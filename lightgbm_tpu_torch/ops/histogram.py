"""Histogram construction: packed stats and the K-slot batched histogram.

The port of `lightgbm_tpu/ops/histogram.py` for the float precisions.
Stats are packed exactly as the JAX package packs them (`pack_stats`):
"hilo" splits each f32 row into bf16 hi and lo rows, so the stats are
`[5, n]` bf16 rows (g_hi, g_lo, h_hi, h_lo, cnt); "bf16" and "f32" are
`[3, n]` rows.  The histogram accumulates every packed row as its own
f32 sum, and `_unpack_hist` adds hi + lo afterwards.

`build_histogram_batched_t` is the K-slot batched histogram.  On a CUDA
tensor it launches kernel B1 (`csrc/histogram.cu`, the port of the
perfeature Pallas kernel `_hist_pallas`); on a CPU tensor it runs
`hist_batched_plain`, the plain PyTorch version of the same function
(the scatter form of the XLA branch of the JAX function).  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

PRECISIONS = ("hilo", "bf16", "f32")


def _dot_spec(precision: str):
    """(stat dtype, accumulator dtype) of a histogram pass: the one table
    the packing, the twin and the kernel wrapper read.  The int8/int16
    and f64 precisions of the JAX package are not ported yet."""
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"tpu_hist_precision={precision!r} is not ported to "
            f"lightgbm_tpu_torch yet (ported: {', '.join(PRECISIONS)})")
    stat = torch.float32 if precision == "f32" else torch.bfloat16
    return stat, torch.float32


def pack_stats(grad: torch.Tensor, hess: torch.Tensor, mask: torch.Tensor,
               precision: str = "hilo") -> torch.Tensor:
    """Per-row gradient/hessian/count-mask -> histogram stat rows.

    grad/hess must already be multiplied by `mask` if masking is intended
    (mask also serves as the count row).  Returns [5, n] bf16 for "hilo",
    [3, n] bf16/f32 otherwise."""
    stat_dtype, _ = _dot_spec(precision)
    if precision != "hilo":
        return torch.stack([grad, hess, mask]).to(stat_dtype)
    g_hi = grad.to(torch.bfloat16)
    g_lo = (grad - g_hi.float()).to(torch.bfloat16)
    h_hi = hess.to(torch.bfloat16)
    h_lo = (hess - h_hi.float()).to(torch.bfloat16)
    cnt = mask.to(torch.bfloat16)  # exact: 0.0 or 1.0
    return torch.stack([g_hi, g_lo, h_hi, h_lo, cnt])


def _unpack_hist(raw: torch.Tensor, precision: str) -> torch.Tensor:
    """[S, ...] accumulated rows -> [..., 3] (g, h, cnt)."""
    if precision != "hilo":
        g, h, c = raw[0], raw[1], raw[2]
    else:
        g = raw[0] + raw[1]
        h = raw[2] + raw[3]
        c = raw[4]
    return torch.stack([g, h, c], dim=-1)


def hist_batched_plain(bins_t: torch.Tensor, stats: torch.Tensor,
                       leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                       num_bins: int) -> torch.Tensor:
    """Plain PyTorch batched histogram: raw [F, B, K, S] f32 sums.

    The scatter form of the JAX function's XLA branch (histogram.py:
    311-337), which contracts a one-hot of (slot, feature, bin) against
    the stat rows: here every (slot, row) match adds the row's S stats at
    its (feature, bin, slot) index with `index_add_`.
        raw[f, bins_t[f, r], k, s] += stats[s, r]
            for every row r with leaf_ids[r] == slot_leaf_ids[k]
    Bins >= num_bins contribute nothing, as they match no one-hot row."""
    F, n = bins_t.shape
    S = stats.shape[0]
    K = slot_leaf_ids.shape[0]
    B = int(num_bins)
    dev = bins_t.device
    k_idx, rows = (slot_leaf_ids[:, None] == leaf_ids[None, :]).nonzero(
        as_tuple=True)                                  # matched (slot, row)
    b = bins_t[:, rows].long()                          # [F, m]
    keep = (b < B)[..., None]
    flat = (torch.arange(F, device=dev)[:, None] * B + b.clamp(max=B - 1)) \
        * K + k_idx[None, :]
    vals = stats[:, rows].to(torch.float32).T           # [m, S]
    vals = torch.where(keep, vals[None], 0.0)           # [F, m, S]
    raw = torch.zeros(F * B * K, S, dtype=torch.float32, device=dev)
    raw.index_add_(0, flat.reshape(-1), vals.reshape(-1, S))
    return raw.view(F, B, K, S)


def hist_batched_kernel(bins_t: torch.Tensor, stats: torch.Tensor,
                        leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                        num_bins: int) -> torch.Tensor:
    """Kernel B1 on the card: raw [F, B, K, S] f32 sums."""
    F, n = bins_t.shape
    S = stats.shape[0]
    K = slot_leaf_ids.shape[0]
    if bins_t.device.type != "cuda":
        raise ValueError(f"kernel B1 takes CUDA tensors, got {bins_t.device}")
    for name, t in (("bins_t", bins_t), ("stats", stats),
                    ("leaf_ids", leaf_ids), ("slot_leaf_ids", slot_leaf_ids)):
        if t.device != bins_t.device:
            raise ValueError(f"{name} is on {t.device}, bins_t on "
                             f"{bins_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bins_t.dtype != torch.uint8:
        raise ValueError(f"bins_t must be uint8, got {bins_t.dtype}")
    if stats.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"stats must be bf16 or f32, got {stats.dtype}")
    if leaf_ids.dtype != torch.int32 or slot_leaf_ids.dtype != torch.int32:
        raise ValueError("leaf_ids and slot_leaf_ids must be int32")
    if stats.shape[1] != n or leaf_ids.shape != (n,) or not 1 <= S <= 5:
        raise ValueError(f"shapes do not agree: bins_t {tuple(bins_t.shape)}"
                         f", stats {tuple(stats.shape)}, leaf_ids "
                         f"{tuple(leaf_ids.shape)}")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins={num_bins} outside [1, 256]")
    if not 1 <= K < 255:
        raise ValueError(f"{K} slots; the kernel takes 1 to 254")
    lib = kernels.library()
    plan = (ctypes.c_int * 5)()
    with torch.cuda.device(bins_t.device):
        kernels.check(lib.lgbt_hist_batched_plan(F, n, S, K, int(num_bins),
                                                 plan), "hist_batched plan")
    # scratch: each row's slot, and one histogram slice per row range
    # (plan[2] of them, added in order)
    slot_of = torch.empty(n, dtype=torch.uint8, device=bins_t.device)
    partial = torch.empty((plan[2], F, num_bins, K, S), dtype=torch.float32,
                          device=bins_t.device)
    raw = torch.empty((F, num_bins, K, S), dtype=torch.float32,
                      device=bins_t.device)
    with torch.cuda.device(bins_t.device):
        code = lib.lgbt_hist_batched(
            bins_t.data_ptr(), stats.data_ptr(),
            int(stats.dtype == torch.float32), leaf_ids.data_ptr(),
            slot_leaf_ids.data_ptr(), slot_of.data_ptr(), partial.data_ptr(),
            raw.data_ptr(), F, n, S, K, int(num_bins), plan,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "hist_batched launch")
    kernels.launches["hist_batched"] += 1
    return raw


def build_histogram_batched_t(bins_t: torch.Tensor, stats: torch.Tensor,
                              leaf_ids: torch.Tensor,
                              slot_leaf_ids: torch.Tensor, num_bins: int,
                              precision: str = "hilo") -> torch.Tensor:
    """Histograms of K leaves in one pass: [K, F, B, 3] f32 (g, h, cnt).

    bins_t:        [F, n] uint8 bins (rows contiguous)
    stats:         [S, n] packed rows from `pack_stats`
    leaf_ids:      [n] int32 current leaf per row
    slot_leaf_ids: [K] int32 leaf wanted in each slot (-1 = dead slot)

    A CUDA tensor goes through kernel B1, a CPU tensor through
    `hist_batched_plain`."""
    if bins_t.device.type == "cuda":
        raw = hist_batched_kernel(bins_t, stats, leaf_ids, slot_leaf_ids,
                                  num_bins)
    elif bins_t.device.type == "cpu":
        raw = hist_batched_plain(bins_t, stats, leaf_ids, slot_leaf_ids,
                                 num_bins)
    else:
        raise ValueError(f"unsupported device {bins_t.device}")
    return _unpack_hist(raw.permute(3, 2, 0, 1), precision)
