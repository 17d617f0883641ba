"""Device value->bin step: a batched searchsorted over monotone int64 keys,
and a category lookup table.

The port of `lightgbm_tpu/ops/binning.py:DeviceBinner`.  For every
numerical (feature, row) the bin is the number of the feature's bin upper
bounds strictly below the value, which is exactly
`np.searchsorted(ub[:hi], v, side="left")` (`BinMapper.values_to_bins`,
reference `BinMapper::ValueToBin`, bin.h:472-508).

Floats are never compared: each f64 maps to its monotone int64 key
(sign-flipped IEEE bit pattern, `bin_mapper.sort_keys`), and keys compare
exactly on every device, so the device bins equal the host bins bit for
bit.  NaN keys to INT64_MAX and is routed per the feature's missing type:
the last bin when NaN-missing, the zero bin (`default_bin`) otherwise.
The JAX package compares split (hi, lo) int32 planes because it runs in
x32 mode; torch has int64 on every device, so one `torch.searchsorted`
over int64 keys does it.

Categorical features look up a flattened per-feature category->bin table
(the LUT): the value truncates toward zero to its category id, NaN takes
the sentinel `_NAN_CAT` (the last bin when NaN-missing, category 0's route
otherwise), and negative, unseen and too-large categories fall to the
last bin, as `value_to_bin` routes them.  Where a feature's category ids
or the table as a whole pass the LUT's capacity, the columns are binned on
the host with `values_to_bins`, as the JAX package falls back.

The result is the transposed `[F, n]` matrix the grower reads.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..io.bin_mapper import BinMapper, BinType, MissingType, sort_keys

_NAN_KEY = int(np.iinfo(np.int64).max)
_INT64_MIN = int(np.iinfo(np.int64).min)
_NAN_CAT = -2  # category sentinel for NaN values
# per-feature / total category-LUT capacity: features with larger raw
# category ids are binned on the host (pandas codes and typical int
# categories sit far below this)
_CAT_LUT_MAX = 1 << 16
_CAT_LUT_TOTAL_MAX = 1 << 22


def sort_keys_t(x: torch.Tensor) -> torch.Tensor:
    """f64 tensor -> monotone int64 keys; NaN -> INT64_MAX (the torch
    twin of `bin_mapper.sort_keys`)."""
    bits = x.view(torch.int64)
    keys = torch.where(bits >= 0, bits, _INT64_MIN - bits)
    return torch.where(torch.isnan(x), torch.full_like(keys, _NAN_KEY), keys)


def _cat_lut(ms: Sequence[BinMapper]) -> Optional[dict]:
    """The flattened category->bin table of the categorical features
    (lightgbm_tpu/ops/binning.py:DeviceBinner.build), or None when a
    feature's ids or the table pass the LUT's capacity."""
    F = len(ms)
    widths = np.zeros(F, np.int64)
    for j, m in enumerate(ms):
        if m.bin_type != BinType.CATEGORICAL:
            continue
        real = [c for c in m.categorical_2_bin if c >= 0]
        w = (max(real) + 1) if real else 1
        if w > _CAT_LUT_MAX:
            return None
        widths[j] = w
    if widths.sum() > _CAT_LUT_TOTAL_MAX:
        return None
    offsets = np.concatenate([[0], np.cumsum(widths)[:-1]])
    lut = np.zeros(max(int(widths.sum()), 1), np.int64)
    nan_cat_bin = np.zeros(F, np.int64)
    for j, m in enumerate(ms):
        if m.bin_type != BinType.CATEGORICAL:
            continue
        lo, w = int(offsets[j]), int(widths[j])
        lut[lo:lo + w] = m.num_bin - 1          # unmapped -> last bin
        for c, b in m.categorical_2_bin.items():
            if 0 <= c < w:
                lut[lo + c] = b
        # NaN: the dedicated last bin when NaN-missing, else category 0's
        # route (values_to_bins' nan_cat)
        nan_cat_bin[j] = (m.num_bin - 1 if m.missing_type == MissingType.NAN
                          else int(lut[lo]))
    return {"is_cat": np.array([m.bin_type == BinType.CATEGORICAL
                                for m in ms]),
            "cat_offset": offsets, "cat_width": widths, "cat_lut": lut,
            "nan_cat_bin": nan_cat_bin}


def bin_tables(mappers: Sequence[BinMapper], used_cols: Sequence[int],
               device) -> Optional[dict]:
    """Per-feature bound keys (NaN-key padded), missing routing and, with
    categorical features, the category LUT; None when the LUT does not
    fit (the host bins the columns then)."""
    ms = [mappers[c] for c in used_cols]
    his = [(m.num_bin - 1 - (1 if m.missing_type == MissingType.NAN else 0))
           if m.bin_type == BinType.NUMERICAL else 0 for m in ms]
    width = max(max(his, default=1), 1)
    bkeys = np.full((len(ms), width), _NAN_KEY, np.int64)
    for j, (m, hi) in enumerate(zip(ms, his)):
        if hi > 0:
            bkeys[j, :hi] = sort_keys(m.bin_upper_bound[:hi])
    last = np.array([m.num_bin - 1 for m in ms], np.int64)
    default_bin = np.array([m.default_bin for m in ms], np.int64)
    nan_is_last = np.array([m.missing_type == MissingType.NAN for m in ms])
    nan_bin = np.where(nan_is_last, last, default_bin)
    out = {"bkeys": torch.from_numpy(bkeys).to(device),
           "nan_bin": torch.from_numpy(nan_bin).to(device)[:, None]}
    if any(m.bin_type == BinType.CATEGORICAL for m in ms):
        cat = _cat_lut(ms)
        if cat is None:
            return None
        out.update({k: torch.from_numpy(v).to(device) for k, v in
                    cat.items()})
        out["last"] = torch.from_numpy(last).to(device)
    return out


def _cat_bins(vals: torch.Tensor, t: dict) -> torch.Tensor:
    """[F, rows] category bins of f64 values (`_bin_chunk_kernel`'s
    categorical branch): truncation toward zero, NaN to its sentinel, the
    clip keeping huge and infinite values unseen."""
    isnan = torch.isnan(vals)
    cv = torch.clamp(torch.trunc(torch.where(isnan, -1.0, vals)), -1.0,
                     float(_CAT_LUT_MAX)).to(torch.int64)
    cv = torch.where(isnan, _NAN_CAT, cv)
    width = t["cat_width"][:, None]
    idx = t["cat_offset"][:, None] + torch.minimum(
        torch.clamp(cv, min=0), width - 1)
    catbin = t["cat_lut"][idx]
    unseen = (cv < 0) | (cv >= width)
    catbin = torch.where(unseen, t["last"][:, None], catbin)
    return torch.where(cv == _NAN_CAT, t["nan_cat_bin"][:, None], catbin)


def bin_matrix_t(X: np.ndarray, mappers: Sequence[BinMapper],
                 used_cols: Sequence[int], device,
                 chunk_rows: int = 65536) -> torch.Tensor:
    """Raw `[n, nf]` f64 rows -> `[F_used, n]` bins on `device` (uint8
    when every used feature has at most 256 bins, else int32).

    Rows stream through in chunks of `chunk_rows`, so the device holds
    one chunk of f64 values and keys at a time beside the output."""
    return bin_chunks_t([X], X.shape[0], mappers, used_cols, device,
                        chunk_rows)


def bin_chunks_t(chunks: Iterable[np.ndarray], n: int,
                 mappers: Sequence[BinMapper], used_cols: Sequence[int],
                 device, chunk_rows: int = 65536) -> torch.Tensor:
    """`bin_matrix_t` of the row blocks `chunks` (each `[m, nf]` f64, n
    rows in all, in order), written into one `[F_used, n]` matrix: the
    second pass of two-round loading, which never holds the whole raw
    matrix.  The tables go to the device once."""
    used = [int(c) for c in used_cols]
    max_bin = max([mappers[c].num_bin for c in used], default=1)
    out_dtype = torch.uint8 if max_bin <= 256 else torch.int32
    out = torch.empty((len(used), n), dtype=out_dtype, device=device)
    if not used or n == 0:
        return out
    t = bin_tables(mappers, used, device)
    has_cat = t is not None and "cat_lut" in t
    chunk = max(int(chunk_rows), 256)
    row = 0
    for X in chunks:
        m = X.shape[0]
        if row + m > n:
            raise ValueError(f"more than the {n} rows announced")
        if t is None:
            # category ids past the LUT: the host bins every column
            host = np.stack([mappers[c].values_to_bins(
                np.ascontiguousarray(X[:, c], dtype=np.float64))
                for c in used])
            out[:, row:row + m] = torch.from_numpy(host).to(
                device=device, dtype=out_dtype)
            row += m
            continue
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            block = np.ascontiguousarray(X[lo:hi][:, used].T,
                                         dtype=np.float64)
            vals = torch.from_numpy(block).to(device)           # [F, rows]
            keys = sort_keys_t(vals)
            num = torch.searchsorted(t["bkeys"], keys)          # [F, rows]
            bins = torch.where(keys == _NAN_KEY, t["nan_bin"], num)
            if has_cat:
                bins = torch.where(t["is_cat"][:, None],
                                   _cat_bins(vals, t), bins)
            out[:, row + lo:row + hi] = bins.to(out_dtype)
        row += m
    if row != n:
        raise ValueError(f"{row} rows binned, {n} announced")
    return out
