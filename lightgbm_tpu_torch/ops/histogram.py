"""Histogram construction: packed stats and the K-slot batched histogram.

The port of `lightgbm_tpu/ops/histogram.py`.  Stats are packed exactly as
the JAX package packs them (`pack_stats`): "hilo" splits each f32 row
into bf16 hi and lo rows, so the stats are `[5, n]` bf16 rows (g_hi,
g_lo, h_hi, h_lo, cnt); "bf16" and "f32" are `[3, n]` rows; "int8" and
"int16" are the `[3, n]` integer rows of quantized gradients, and their
histograms accumulate in exact int32.  A float histogram accumulates
every packed row as its own f32 sum, and `_unpack_hist` adds hi + lo
afterwards.

The quantized precisions round grad/hess onto an integer grid once per
tree (`quantize_values`): per-tree max-abs scales over `quant_limit`,
and stochastic rounding whose uniforms come from `hashed_uniform`, a
PCG-style hash of the row index and two key words (`key_words`).  The
hash runs in int64 masked to 32 bits, since torch's uint32 arithmetic is
partial; it gives the JAX package's uint32 results bit for bit.

`build_histogram_batched_t` is the K-slot batched histogram.  On a CUDA
tensor it launches kernel B1 (`csrc/histogram.cu` on
`csrc/grouped_hist.cuh`, the port of the perfeature Pallas kernel
`_hist_pallas`), or kernel B4 (the port of its "flat" variant) for
`impl="pallas"`; on a CPU tensor both run `hist_batched_plain`, the
plain PyTorch version of the same function (the scatter form of the XLA
branch of the JAX function).  There is no fallback from one to the
other.  B1 (and B2, ops/fused.py) group the rows by slot and gather
each live row's bins from a row-major copy of the bin matrix
(`row_major_bins`, kept on the matrix: 32 MB at 1M rows x 32 features);
`group_rows_plain` is the plain version of that grouping, and
`hist_plan` the launch geometry, both plain Python.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import kernels

PRECISIONS = ("hilo", "bf16", "f32", "int8", "int16")
INT_PRECISIONS = ("int8", "int16")
_INT_STAT_DTYPES = {"int8": torch.int8, "int16": torch.int16}
_INT_TYPE_MAX = {"int8": 127, "int16": 32767}
# the stat-type codes of the C entry points
_STAT_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2,
               torch.int16: 3}
_MASK32 = 0xFFFFFFFF


def _dot_spec(precision: str):
    """(stat dtype, accumulator dtype) of a histogram pass: the one table
    the packing, the twin and the kernel wrappers read.  The integer
    precisions accumulate in exact int32.  The f64 precision of the JAX
    package is not ported yet."""
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"tpu_hist_precision={precision!r} is not ported to "
            f"lightgbm_tpu_torch yet (ported: {', '.join(PRECISIONS)})")
    if precision in _INT_STAT_DTYPES:
        return _INT_STAT_DTYPES[precision], torch.int32
    stat = torch.float32 if precision == "f32" else torch.bfloat16
    return stat, torch.float32


def quant_limit(precision: str, total_rows: int) -> int:
    """Largest |quantized| stat value such that a worst-case histogram
    bin (every row in it at full magnitude) still fits int32."""
    cap = (2 ** 31 - 1) // max(int(total_rows), 1)
    q = min(_INT_TYPE_MAX[precision], cap)
    if q < 1:
        raise ValueError(
            f"{total_rows} rows overflow int32 histogram accumulation even "
            "at 1-bit quantization; use a float tpu_hist_precision")
    return q


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The PCG-style avalanche of the JAX package on uint32 counters,
    computed on int64 tensors holding values in [0, 2**32)."""
    x = (x * 747796405 + 2891336453) & _MASK32
    w = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _MASK32
    return (w >> 22) ^ w


def hashed_uniform(idx: torch.Tensor, seed_a: int, seed_b: int,
                   salt: int) -> torch.Tensor:
    """[n] f32 uniforms in [0, 1) from row counters and two key words."""
    h = _hash_u32((idx.to(torch.int64) & _MASK32)
                  ^ ((int(seed_a) ^ int(salt)) & _MASK32))
    h = _hash_u32((h + (int(seed_b) & _MASK32)) & _MASK32)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def key_words(key) -> tuple:
    """The two uint32 words (first, last) of a threefry key, as ints."""
    kw = np.asarray(key, np.uint32).ravel()
    return int(kw[0]), int(kw[-1])


def quantize_values(x: torch.Tensor, scale, qmax: int, mode: str,
                    seed_a: int = 0, seed_b: int = 0, row_offset: int = 0,
                    salt: int = 0, stochastic=None) -> torch.Tensor:
    """f32 [n] -> int32 grid values in [-qmax, qmax], x ~= result * scale.

    mode="stochastic" rounds floor(q) up with probability frac(q), with
    the uniforms of `hashed_uniform` over the row indices (plus
    row_offset); mode="nearest" rounds half to even.  `stochastic` (a
    flag, > 0 = stochastic) selects between the two in place of `mode`,
    with each branch bit-equal to its static mode."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    # a tensor divisor: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which is not correctly rounded
    q = torch.clamp(x / scale, -float(qmax), float(qmax))
    if stochastic is None and mode == "nearest":
        return torch.round(q).to(torch.int32)
    fl = torch.floor(q)
    idx = torch.arange(x.shape[0], dtype=torch.int64, device=x.device) \
        + int(row_offset)
    r = hashed_uniform(idx, seed_a, seed_b, salt)
    sto = (fl + (r < (q - fl)).to(torch.float32)).to(torch.int32)
    if stochastic is None:
        return sto
    return torch.where(torch.as_tensor(stochastic, device=x.device) > 0,
                       sto, torch.round(q).to(torch.int32))


def pack_stats(grad: torch.Tensor, hess: torch.Tensor, mask: torch.Tensor,
               precision: str = "hilo") -> torch.Tensor:
    """Per-row gradient/hessian/count-mask -> histogram stat rows.

    grad/hess must already be multiplied by `mask` if masking is intended
    (mask also serves as the count row).  Returns [5, n] bf16 for "hilo",
    [3, n] bf16/f32 for "bf16"/"f32", and for "int8"/"int16" the [3, n]
    integer rows of grad/hess that `quantize_values` already rounded."""
    stat_dtype, _ = _dot_spec(precision)
    if precision != "hilo":
        return torch.stack([grad.to(stat_dtype), hess.to(stat_dtype),
                            mask.to(stat_dtype)])
    g_hi = grad.to(torch.bfloat16)
    g_lo = (grad - g_hi.float()).to(torch.bfloat16)
    h_hi = hess.to(torch.bfloat16)
    h_lo = (hess - h_hi.float()).to(torch.bfloat16)
    cnt = mask.to(torch.bfloat16)  # exact: 0.0 or 1.0
    return torch.stack([g_hi, g_lo, h_hi, h_lo, cnt])


def _unpack_hist(raw: torch.Tensor, precision: str) -> torch.Tensor:
    """[S, ...] accumulated rows -> [..., 3] (g, h, cnt).  Integer
    histograms stay int32: the grower rescales them at the split scan."""
    if precision != "hilo":
        g, h, c = raw[0], raw[1], raw[2]
    else:
        g = raw[0] + raw[1]
        h = raw[2] + raw[3]
        c = raw[4]
    return torch.stack([g, h, c], dim=-1)


def _acc_dtype(stats: torch.Tensor) -> torch.dtype:
    return torch.float32 if stats.is_floating_point() else torch.int32


def hist_batched_plain(bins_t: torch.Tensor, stats: torch.Tensor,
                       leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                       num_bins: int) -> torch.Tensor:
    """Plain PyTorch batched histogram: raw [F, B, K, S] sums, f32 for
    float stats and int32 for integer stats.

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
    acc = _acc_dtype(stats)
    k_idx, rows = (slot_leaf_ids[:, None] == leaf_ids[None, :]).nonzero(
        as_tuple=True)                                  # matched (slot, row)
    b = bins_t[:, rows].long()                          # [F, m]
    keep = (b < B)[..., None]
    flat = (torch.arange(F, device=dev)[:, None] * B + b.clamp(max=B - 1)) \
        * K + k_idx[None, :]
    vals = stats[:, rows].to(acc).T                     # [m, S]
    vals = torch.where(keep, vals[None], torch.zeros((), dtype=acc,
                                                     device=dev))
    raw = torch.zeros(F * B * K, S, dtype=acc, device=dev)
    raw.index_add_(0, flat.reshape(-1), vals.reshape(-1, S))
    return raw.view(F, B, K, S)


def _check_hist_args(what: str, bins_t, stats, leaf_ids, slot_leaf_ids,
                     num_bins: int) -> None:
    """The checks both histogram kernels' wrappers make."""
    F, n = bins_t.shape
    S = stats.shape[0]
    K = slot_leaf_ids.shape[0]
    if bins_t.device.type != "cuda":
        raise ValueError(f"kernel {what} takes CUDA tensors, got "
                         f"{bins_t.device}")
    for name, t in (("bins_t", bins_t), ("stats", stats),
                    ("leaf_ids", leaf_ids), ("slot_leaf_ids", slot_leaf_ids)):
        if t.device != bins_t.device:
            raise ValueError(f"{name} is on {t.device}, bins_t on "
                             f"{bins_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bins_t.dtype != torch.uint8:
        raise ValueError(f"bins_t must be uint8, got {bins_t.dtype}")
    if stats.dtype not in _STAT_KINDS:
        raise ValueError(f"stats must be bf16, f32, int8 or int16, got "
                         f"{stats.dtype}")
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


# shared memory the CUDA runtime reserves for each resident block
_SMEM_PER_BLOCK_RESERVED = 1024
_MAX_STATS_BYTES = 16      # one row's packed stats: one 16-byte load


class HistPlan(NamedTuple):
    """Launch geometry of one call of the grouped histogram kernel (the
    field order of csrc/grouped_hist.cuh's kPlan* indices)."""
    threads: int          # threads of a block
    smem: int             # dynamic shared memory of a block, bytes
    chunks: int           # feature chunks of 32 features
    grid: int             # blocks: all resident at once (cooperative)
    seg_rows: int         # least rows of the grouped list a block takes
    tile_rows: int        # rows whose leaf ids each block groups
    scratch_words: int    # int32 words of scratch the call needs


# words of the grouping's leaf id -> slot table (grouped_hist.cuh kTable)
_TABLE_WORDS = 4096 // 4
# shared words of one 256-thread part of kernel B2's split scan
# (csrc/fused.cu ScanTail::kWords)
_SCAN_WORDS = 3 * 8 + 6 * 256 + 4 * 8


def _smem_bytes(K: int, B: int, S: int, threads: int, scan: bool,
                floats: bool) -> int:
    """grouped_hist.cuh's layout: the persistent [4K+1] words (slot ids,
    duplicate chains, offsets, write positions) rounded to 16 bytes, then
    the largest of the grouping's two [warps, K] tables, [K] totals and
    leaf id -> slot table,
    the histogram's [B, S, 32] sums and, for B2, the scan's words."""
    persist = (4 * K + 1 + 3) // 4 * 4
    # int32 sums at a row stride of 33 words, f32 sums at 32; after them
    # each warp's tile of 32 rows' bins (32 x 9 words), which the f32
    # flush reuses for its staging tiles (8 warps x 32 x 33 words)
    tiles = max((threads // 32) * 32 * 9, 8 * 32 * 33 if floats else 0)
    sums = B * S * (32 if floats else 33) + tiles
    union = max(2 * (threads // 32) * K + K + _TABLE_WORDS, sums,
                (threads // 256) * _SCAN_WORDS if scan else 0)
    return 4 * (persist + union)


def hist_plan(F: int, K: int, S: int, B: int, n: int, sms: int,
              smem_max: int, smem_sm: int, scan: bool = False,
              floats: bool = False) -> HistPlan:
    """Geometry of kernel B1 (and of B2's histogram phases).

    Features go in chunks of 32, one per lane, so one slot's [B, S, 32]
    sums (163,200 bytes at B = 255, S = 5) always fit a block.  Where two
    blocks fit an SM's shared memory (smem_sm), blocks have 512 threads
    and two share an SM; else one block of 1024.  The grid is every
    block the card holds at once, as a cooperative launch needs.  Each
    block groups a tile of ceil(n / grid) rows, rounded to 4 x its
    threads (each warp takes an equal part of it).  scan: the call is
    kernel B2's, whose split scan also needs shared memory."""
    if not (1 <= S <= 5 and 1 <= K < 255 and 1 <= B <= 256 and F >= 1
            and n >= 1 and sms >= 1):
        raise ValueError(f"no histogram plan for F={F}, K={K}, S={S}, "
                         f"B={B}, n={n}, sms={sms}")
    chunks = -(-F // 32)
    small = _smem_bytes(K, B, S, 512, scan, floats)
    if 2 * (small + _SMEM_PER_BLOCK_RESERVED) <= smem_sm:
        threads, per_sm, smem = 512, 2, small
    else:
        threads, per_sm = 1024, 1
        smem = _smem_bytes(K, B, S, threads, scan, floats)
    if smem > smem_max or smem + _SMEM_PER_BLOCK_RESERVED > smem_sm:
        raise ValueError(f"the histogram needs {smem} bytes of shared "
                         f"memory; the card gives a block {smem_max}")
    grid = sms * per_sm
    # rows of the grouped list that a block takes at least: fewer rows a
    # block spread a small call over more blocks, each flushing up to
    # B x S x 32 sums
    seg_rows = 512
    # each warp groups 4 x 32 rows at a time
    step = 4 * threads
    tile = -(-n // grid)
    tile = -(-tile // step) * step
    # [n] uint4 packed stats, [n] rows, [K, grid] counts, [K+1] offsets
    scratch = 4 * n + n + grid * K + K + 1
    return HistPlan(threads, smem, chunks, grid, seg_rows, tile, scratch)


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> tuple:
    """(SMs, opt-in shared memory of a block, shared memory of an SM)."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        kernels.check(kernels.library().lgbt_device_limits(out),
                      "device limits")
    return tuple(out)


def row_major_bins(bins_t: torch.Tensor) -> torch.Tensor:
    """[n, FR] uint8 copy of the [F, n] bins, FR = F rounded up to 32
    (padding bytes 0): one row's bins of a 32-feature chunk are one
    32-byte sector.  Made once and kept on bins_t itself, so every call
    on the same matrix (the learner's, for the whole training) reuses
    it; an in-place change of bins_t makes a new one."""
    cached = getattr(bins_t, "_lgbt_rows", None)
    if cached is not None and cached[0] == bins_t._version:
        return cached[1]
    F, n = bins_t.shape
    fr = -(-F // 32) * 32
    rows = torch.zeros((n, fr), dtype=torch.uint8, device=bins_t.device)
    rows[:, :F] = bins_t.t()
    bins_t._lgbt_rows = (bins_t._version, rows)
    return rows


def group_rows_plain(leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor):
    """The grouping pass of kernels B1 and B2 in plain PyTorch: (rows,
    offsets).  rows [m] int32 lists the rows in any slot, grouped by
    slot and in row order within a slot; slot k's rows are
    rows[offsets[k]:offsets[k+1]] ([K+1] int32).  A row goes to the first
    slot holding its leaf id; a later slot with the same id, and a dead
    slot (a negative id), gets none."""
    match = (slot_leaf_ids[:, None] == leaf_ids[None, :]) \
        & (slot_leaf_ids[:, None] >= 0)
    first = match & (match.to(torch.int32).cumsum(0) == 1)
    _, rows = first.nonzero(as_tuple=True)       # slot-major, rows ascending
    counts = first.sum(1)
    offsets = torch.zeros(slot_leaf_ids.shape[0] + 1, dtype=torch.int32,
                          device=leaf_ids.device)
    offsets[1:] = counts.cumsum(0)
    return rows.to(torch.int32), offsets


def _grouped_call(bins_t, stats, slot_leaf_ids, num_bins: int,
                  scan: bool = False):
    """Row-major bins, plan, scratch and ctypes plan of one call."""
    F, n = bins_t.shape
    S = stats.shape[0]
    K = slot_leaf_ids.shape[0]
    if S * stats.element_size() > _MAX_STATS_BYTES:
        raise ValueError(f"{S} {stats.dtype} stat rows exceed the kernel's "
                         f"{_MAX_STATS_BYTES} bytes a row")
    rows = row_major_bins(bins_t)
    index = bins_t.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = hist_plan(F, K, S, int(num_bins), n, *_device_limits(index),
                     scan=scan, floats=stats.is_floating_point())
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=bins_t.device)
    return rows, plan, scratch, (ctypes.c_int * 6)(*plan[:6])


def _raw_buffer(K, F, B, S, dtype, device):
    """The kernels' output: [K, F, BSp], a (slot, feature) row of B * S
    sums padded to a multiple of 4 words (16-byte vector atomics)."""
    return torch.empty((K, F, -(-B * S // 4) * 4), dtype=dtype,
                       device=device)


def _raw_view(raw, F, B, S):
    """[K, F, B, S] view of a `_raw_buffer` (the padding left out)."""
    return raw[:, :, :B * S].view(raw.shape[0], F, B, S)


def _launch_hist(bins_t, stats, leaf_ids, slot_leaf_ids, num_bins: int,
                 group_only: bool):
    F, n = bins_t.shape
    S = stats.shape[0]
    K = slot_leaf_ids.shape[0]
    rows, plan, scratch, cplan = _grouped_call(bins_t, stats, slot_leaf_ids,
                                               num_bins)
    raw = _raw_buffer(K, F, int(num_bins), S, _acc_dtype(stats),
                      bins_t.device)
    with torch.cuda.device(bins_t.device):
        code = kernels.library().lgbt_hist_batched(
            rows.data_ptr(), rows.shape[1], stats.data_ptr(),
            _STAT_KINDS[stats.dtype], leaf_ids.data_ptr(),
            slot_leaf_ids.data_ptr(), scratch.data_ptr(), raw.data_ptr(), F,
            n, S, K, int(num_bins), cplan, int(group_only),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "hist_batched launch")
    return _raw_view(raw, F, int(num_bins), S).permute(1, 2, 0, 3), plan, \
        scratch


def hist_batched_kernel(bins_t: torch.Tensor, stats: torch.Tensor,
                        leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                        num_bins: int) -> torch.Tensor:
    """Kernel B1 on the card: raw [F, B, K, S] sums (f32, or int32 for
    int8/int16 stats: the integer variant, counted apart).  One
    cooperative launch: the grouping pass, then the histogram."""
    _check_hist_args("B1", bins_t, stats, leaf_ids, slot_leaf_ids,
                     num_bins)
    raw, _, _ = _launch_hist(bins_t, stats, leaf_ids, slot_leaf_ids,
                             num_bins, False)
    kernels.launches["hist_batched" if raw.dtype == torch.float32
                     else "hist_batched_int"] += 1
    return raw


def hist_group_kernel(bins_t: torch.Tensor, stats: torch.Tensor,
                      leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                      num_bins: int):
    """Kernel B1 stopped after its grouping pass: (rows, offsets) as
    `group_rows_plain` gives them.  For the tests; not counted."""
    _check_hist_args("B1", bins_t, stats, leaf_ids, slot_leaf_ids,
                     num_bins)
    n = bins_t.shape[1]
    K = slot_leaf_ids.shape[0]
    _, plan, scratch = _launch_hist(bins_t, stats, leaf_ids, slot_leaf_ids,
                                    num_bins, True)
    at = 5 * n + plan.grid * K
    offsets = scratch[at:at + K + 1].clone()
    m = int(offsets[K].item())
    return scratch[4 * n:4 * n + m].clone(), offsets


def hist_flat_kernel(bins_t: torch.Tensor, stats: torch.Tensor,
                     leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                     num_bins: int) -> torch.Tensor:
    """Kernel B4 on the card (the flat variant): raw [F, B, K, S] sums,
    f32 or int32; B1's contract."""
    _check_hist_args("B4", bins_t, stats, leaf_ids, slot_leaf_ids,
                     num_bins)
    F, n = bins_t.shape
    S = stats.shape[0]
    K = slot_leaf_ids.shape[0]
    raw = torch.zeros((F, num_bins, K, S), dtype=_acc_dtype(stats),
                      device=bins_t.device)
    lib = kernels.library()
    with torch.cuda.device(bins_t.device):
        code = lib.lgbt_hist_flat(
            bins_t.data_ptr(), stats.data_ptr(), _STAT_KINDS[stats.dtype],
            leaf_ids.data_ptr(), slot_leaf_ids.data_ptr(), raw.data_ptr(),
            F, n, S, K, int(num_bins),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "hist_flat launch")
    kernels.launches["hist_flat"] += 1
    return raw


def build_histogram_batched_t(bins_t: torch.Tensor, stats: torch.Tensor,
                              leaf_ids: torch.Tensor,
                              slot_leaf_ids: torch.Tensor, num_bins: int,
                              precision: str = "hilo",
                              impl: str = "pallas2") -> torch.Tensor:
    """Histograms of K leaves in one pass: [K, F, B, 3] (g, h, cnt), f32
    or, for the integer precisions, int32.

    bins_t:        [F, n] uint8 bins (rows contiguous)
    stats:         [S, n] packed rows from `pack_stats`
    leaf_ids:      [n] int32 current leaf per row
    slot_leaf_ids: [K] int32 leaf wanted in each slot (-1 = dead slot)
    impl:          "pallas" takes kernel B4 on the card; every other
                   histogram implementation takes kernel B1

    A CPU tensor goes through `hist_batched_plain`."""
    if bins_t.device.type == "cuda":
        kernel = hist_flat_kernel if impl == "pallas" else hist_batched_kernel
        raw = kernel(bins_t, stats, leaf_ids, slot_leaf_ids, num_bins)
    elif bins_t.device.type == "cpu":
        raw = hist_batched_plain(bins_t, stats, leaf_ids, slot_leaf_ids,
                                 num_bins)
    else:
        raise ValueError(f"unsupported device {bins_t.device}")
    return _unpack_hist(raw.permute(3, 2, 0, 1), precision)
