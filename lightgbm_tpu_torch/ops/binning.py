"""Device value->bin step: a batched searchsorted over monotone int64 keys.

The port of `lightgbm_tpu/ops/binning.py:DeviceBinner`'s numerical path.
For every (feature, row) the bin is the number of the feature's bin upper
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

The result is the transposed `[F, n]` matrix the grower reads.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..io.bin_mapper import BinMapper, BinType, MissingType, sort_keys

_NAN_KEY = int(np.iinfo(np.int64).max)
_INT64_MIN = int(np.iinfo(np.int64).min)


def sort_keys_t(x: torch.Tensor) -> torch.Tensor:
    """f64 tensor -> monotone int64 keys; NaN -> INT64_MAX (the torch
    twin of `bin_mapper.sort_keys`)."""
    bits = x.view(torch.int64)
    keys = torch.where(bits >= 0, bits, _INT64_MIN - bits)
    return torch.where(torch.isnan(x), torch.full_like(keys, _NAN_KEY), keys)


def bin_tables(mappers: Sequence[BinMapper], used_cols: Sequence[int],
               device) -> dict:
    """Per-feature bound keys (NaN-key padded) and missing routing."""
    ms = [mappers[c] for c in used_cols]
    for m in ms:
        if m.bin_type != BinType.NUMERICAL:
            raise NotImplementedError(
                "categorical_feature: categorical features are not ported "
                "to lightgbm_tpu_torch yet")
    his = [m.num_bin - 1 - (1 if m.missing_type == MissingType.NAN else 0)
           for m in ms]
    width = max(max(his, default=1), 1)
    bkeys = np.full((len(ms), width), _NAN_KEY, np.int64)
    for j, (m, hi) in enumerate(zip(ms, his)):
        if hi > 0:
            bkeys[j, :hi] = sort_keys(m.bin_upper_bound[:hi])
    last = np.array([m.num_bin - 1 for m in ms], np.int64)
    default_bin = np.array([m.default_bin for m in ms], np.int64)
    nan_is_last = np.array([m.missing_type == MissingType.NAN for m in ms])
    nan_bin = np.where(nan_is_last, last, default_bin)
    return {"bkeys": torch.from_numpy(bkeys).to(device),
            "nan_bin": torch.from_numpy(nan_bin).to(device)[:, None]}


def bin_matrix_t(X: np.ndarray, mappers: Sequence[BinMapper],
                 used_cols: Sequence[int], device,
                 chunk_rows: int = 65536) -> torch.Tensor:
    """Raw `[n, nf]` f64 rows -> `[F_used, n]` bins on `device` (uint8
    when every used feature has at most 256 bins, else int32).

    Rows stream through in chunks of `chunk_rows`, so the device holds
    one chunk of f64 values and keys at a time beside the output."""
    used = [int(c) for c in used_cols]
    n = X.shape[0]
    max_bin = max([mappers[c].num_bin for c in used], default=1)
    out_dtype = torch.uint8 if max_bin <= 256 else torch.int32
    out = torch.empty((len(used), n), dtype=out_dtype, device=device)
    if not used or n == 0:
        return out
    t = bin_tables(mappers, used, device)
    chunk = max(int(chunk_rows), 256)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = np.ascontiguousarray(X[lo:hi][:, used].T, dtype=np.float64)
        vals = torch.from_numpy(block).to(device)               # [F, rows]
        keys = sort_keys_t(vals)
        num = torch.searchsorted(t["bkeys"], keys)              # [F, rows]
        out[:, lo:hi] = torch.where(keys == _NAN_KEY, t["nan_bin"],
                                    num).to(out_dtype)
    return out
