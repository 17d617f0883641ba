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

"f64" (deterministic=true) stacks f64 stat rows and accumulates them in
f64 with `hist_batched_f64`, torch ops in one fixed order on every device
(the JAX package runs it through its XLA branch alone, never Pallas).

`build_histogram_batched_t` is the K-slot batched histogram.  On a CUDA
tensor it launches kernel B1 (`csrc/histogram.cu` on
`csrc/grouped_hist.cuh`, the port of the perfeature Pallas kernel
`_hist_pallas`), or kernel B4 (the port of its "flat" variant, B1's
function on B1's operands, launched as its own instance of the same
body) for `impl="pallas"`; on a CPU tensor both run `hist_batched_plain`,
the plain PyTorch version of the same function (the scatter form of the
XLA branch of the JAX function).  There is no fallback from one to the
other.  B1, B4 (and B2, ops/fused.py) group the rows by slot and gather
each live row's bins from a row-major copy of the bin matrix
(`row_major_bins`, kept on the matrix: 32 MB at 1M rows x 32 features);
`group_rows_plain` is the plain version of that grouping, and
`hist_plan` the launch geometry, both plain Python.

4-bit packed bins (`tpu_pack_bins`, every feature at 16 bins or fewer):
the learner stores `[F, n/2]` uint8, two rows a byte in the JAX
package's per-block stride layout (`pack_bins`, `unpack2d`: row j of a
block in the low nibble, row j + block/2 in the high one).  B1 and B4
then read a packed row-major copy, two features a byte (16 bytes a row
of a 32-feature chunk, 16 MB at 1M rows), and unpack in registers; the
twin unpacks and runs the unpacked twin.

Wide bins (more than 256 bins in a feature, `max_bin>255`): the learner
stores `[F, n]` int32, as the JAX learner does.  B1 and B4 then read a
16-bit row-major copy (64 bytes a row of a 32-feature chunk, 64.5 MB at
1M rows) and spread a slot's sums over a thread-block cluster of
`hist_plan`'s `cluster` blocks, `bin_tile` bins a block, so that each
row is walked once per tile group (`plan_walks`: once whenever B fits 8
tiles); `cluster_schedule` is the plain model of that schedule.  The
twin takes the int32 matrix as it is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import kernels

PRECISIONS = ("hilo", "bf16", "f32", "f64", "int8", "int16")
INT_PRECISIONS = ("int8", "int16")
_INT_STAT_DTYPES = {"int8": torch.int8, "int16": torch.int16}
_INT_TYPE_MAX = {"int8": 127, "int16": 32767}
# the stat-type codes of the C entry points
_STAT_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2,
               torch.int16: 3}
_MASK32 = 0xFFFFFFFF
# the most bins a feature may have: the wide kernels' row-major copy
# holds 16 bits a bin (the learner refuses more)
MAX_WIDE_BINS = 65536
# the bins codes of the C entry points (csrc/grouped_hist.cuh
# U8Bins/PackedBins/WideBins::kCode)
BINS_U8, BINS_PACKED, BINS_WIDE = 0, 1, 2


def _dot_spec(precision: str):
    """(stat dtype, accumulator dtype) of a histogram pass: the one table
    the packing, the twin and the kernel wrappers read.  The integer
    precisions accumulate in exact int32, "f64" (deterministic=true) in
    doubles (`hist_batched_f64`)."""
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"tpu_hist_precision={precision!r} is not ported to "
            f"lightgbm_tpu_torch yet (ported: {', '.join(PRECISIONS)})")
    if precision in _INT_STAT_DTYPES:
        return _INT_STAT_DTYPES[precision], torch.int32
    if precision == "f64":
        return torch.float64, torch.float64
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
    [3, n] bf16/f32/f64 for "bf16"/"f32"/"f64", and for "int8"/"int16"
    the [3, n] integer rows of grad/hess that `quantize_values` already
    rounded."""
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


def unpack2d(packed: torch.Tensor, block: int) -> torch.Tensor:
    """[..., n/2] packed uint8 -> [..., n] uint8 bins (n a multiple of
    block): the port of `lightgbm_tpu/ops/histogram.py:unpack2d`, the one
    definition of the stride layout, with the row block passed in.  In
    each block of `block` rows, byte j holds row j in its low nibble and
    row j + block/2 in its high nibble."""
    half = int(block) // 2
    lead = packed.shape[:-1]
    nb = packed.shape[-1] // half
    if half < 1 or nb * half != packed.shape[-1]:
        raise ValueError(f"{packed.shape[-1]} packed bytes are not whole "
                         f"blocks of {block} rows")
    b = packed.reshape(*lead, nb, half)
    return torch.cat([b & 0xF, b >> 4], dim=-1).reshape(*lead, nb * 2 * half)


def pack_bins(bins_t: torch.Tensor, block: int) -> torch.Tensor:
    """[F, n] uint8 bins below 16 -> [F, n/2] packed (`unpack2d`'s
    inverse), as the JAX learner packs them (learner.py:630-633)."""
    F, n = bins_t.shape
    half = int(block) // 2
    if half < 1 or n % (2 * half):
        raise ValueError(f"{n} rows are not whole blocks of {block}")
    x = bins_t.reshape(F, n // (2 * half), 2, half)
    return (x[:, :, 0, :] | (x[:, :, 1, :] << 4)).reshape(F, n // 2)


def bins_layout(bins_t: torch.Tensor, packed_block: int = 0):
    """(bins code, counter suffix) of a bin matrix: uint8, 4-bit packed
    uint8 (packed_block > 0) or wide (int32)."""
    if bins_t.dtype == torch.int32:
        if packed_block:
            raise ValueError("int32 bins are never packed")
        return BINS_WIDE, "_wide"
    if bins_t.dtype != torch.uint8:
        raise ValueError(f"bins_t must be uint8 or int32, got "
                         f"{bins_t.dtype}")
    return (BINS_PACKED, "_packed") if packed_block else (BINS_U8, "")


def _acc_dtype(stats: torch.Tensor) -> torch.dtype:
    return torch.float32 if stats.is_floating_point() else torch.int32


def hist_batched_plain(bins_t: torch.Tensor, stats: torch.Tensor,
                       leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                       num_bins: int, packed_block: int = 0) -> torch.Tensor:
    """Plain PyTorch batched histogram: raw [F, B, K, S] sums, f32 for
    float stats and int32 for integer stats.

    The scatter form of the JAX function's XLA branch (histogram.py:
    311-337), which contracts a one-hot of (slot, feature, bin) against
    the stat rows: here every (slot, row) match adds the row's S stats at
    its (feature, bin, slot) index with `index_add_`.
        raw[f, bins_t[f, r], k, s] += stats[s, r]
            for every row r with leaf_ids[r] == slot_leaf_ids[k]
    Bins >= num_bins contribute nothing, as they match no one-hot row.
    bins_t may be uint8 or int32 (wide bins).  packed_block > 0: bins_t
    is packed 4-bit `[F, n/2]` in blocks of that many rows, unpacked
    first (`unpack2d`)."""
    if packed_block:
        bins_t = unpack2d(bins_t, packed_block)
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


# one-hot elements of a block of `hist_batched_f64`: 2^24 f64 (134 MB)
_F64_ONEHOT_ELEMS = 1 << 24


def hist_batched_f64(bins_t: torch.Tensor, stats: torch.Tensor,
                     leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                     num_bins: int) -> torch.Tensor:
    """The f64 batched histogram of deterministic=true: raw [F, B, K, S]
    f64 sums, in one fixed order on every device.

    The JAX package computes it with its XLA branch alone (histogram.py:
    311-337: a one-hot of (feature, bin) per row block contracted in f64
    against the slot-expanded stat rows, the blocks added in order), and
    so does this, over the rows of the live slots only: those rows in
    ascending order, cut into blocks whose [F*B, blk] one-hot holds at
    most 2^24 elements, each block one f64 matmul, the blocks added in
    sequence.  No atomics: two runs on one device give the same bits
    (`index_add_`, the float twin's form, adds through atomics on CUDA).
    Bins >= num_bins match no one-hot row."""
    F, n = bins_t.shape
    S = stats.shape[0]
    K = slot_leaf_ids.shape[0]
    B = int(num_bins)
    dev = bins_t.device
    f64 = torch.float64
    slot_oh = slot_leaf_ids[:, None] == leaf_ids[None, :]        # [K, n]
    rows = slot_oh.any(dim=0).nonzero()[:, 0]                    # ascending
    blk = 1
    while blk * 2 * F * B <= _F64_ONEHOT_ELEMS:
        blk *= 2
    iota = torch.arange(B, device=dev)[None, :, None]
    acc = torch.zeros(F * B, K * S, dtype=f64, device=dev)
    for r0 in range(0, rows.shape[0], blk):
        rb = rows[r0:r0 + blk]
        onehot = (bins_t[:, rb].long()[:, None, :] == iota).to(f64)
        sexp = (slot_oh[:, rb].to(f64)[:, None, :]
                * stats[:, rb].to(f64)[None])                    # [K, S, m]
        acc = acc + onehot.reshape(F * B, -1) @ sexp.reshape(K * S, -1).T
    return acc.view(F, B, K, S)


def _check_hist_args(what: str, bins_t, stats, leaf_ids, slot_leaf_ids,
                     num_bins: int, packed_block: int = 0) -> None:
    """The checks both histogram kernels' wrappers make."""
    F = bins_t.shape[0]
    S, n = stats.shape
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
    code, _ = bins_layout(bins_t, packed_block)
    if stats.dtype not in _STAT_KINDS:
        raise ValueError(f"stats must be bf16, f32, int8 or int16, got "
                         f"{stats.dtype}")
    if leaf_ids.dtype != torch.int32 or slot_leaf_ids.dtype != torch.int32:
        raise ValueError("leaf_ids and slot_leaf_ids must be int32")
    cols = n // 2 if packed_block else n
    if bins_t.shape[1] != cols or leaf_ids.shape != (n,) or not 1 <= S <= 5:
        raise ValueError(f"shapes do not agree: bins_t {tuple(bins_t.shape)}"
                         f", stats {tuple(stats.shape)}, leaf_ids "
                         f"{tuple(leaf_ids.shape)}, packed_block "
                         f"{packed_block}")
    top = {BINS_U8: 256, BINS_PACKED: 16, BINS_WIDE: MAX_WIDE_BINS}[code]
    if not 1 <= num_bins <= top:
        raise ValueError(f"num_bins={num_bins} outside [1, {top}]")
    if packed_block and (packed_block % 2 or n % packed_block):
        raise ValueError(f"{n} rows are not whole packed blocks of "
                         f"{packed_block}")
    if not 1 <= K < 255:
        raise ValueError(f"{K} slots; the kernel takes 1 to 254")


# shared memory the CUDA runtime reserves for each resident block
_SMEM_PER_BLOCK_RESERVED = 1024
# blocks of a thread-block cluster at most: the portable cluster size
# (grouped_hist.cuh kMaxCluster)
MAX_CLUSTER = 8
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
    bin_tile: int         # bins whose sums a block holds at a time
    cluster: int          # blocks of a thread-block cluster (wide bins)
    scratch_words: int    # int32 words of scratch the call needs


# words of the grouping's leaf id -> slot table (grouped_hist.cuh kTable)
_TABLE_WORDS = 4096 // 4
# words of phase C's per-entry tile of a row's bins (grouped_hist.cuh
# kTileStride*): 32 bytes and a pad, 16 packed bytes and a pad, or 64
# bytes of 16-bit wide bins and a pad
_TILE_STRIDE = 9
_TILE_STRIDE_PACKED = 5
_TILE_STRIDE_WIDE = 17
# shared words of one 256-thread part of kernel B2's split scan
# (csrc/fused.cu ScanTail::kWords)
_SCAN_WORDS = 3 * 8 + 4 * 8 + 4


def _tiles_words(threads: int, floats: bool, packed: bool,
                 wide: bool) -> int:
    """Words after the sums: each warp's tile of 32 rows' bins, which the
    f32 flush reuses for its staging tiles (8 warps x 32 x 33 words)."""
    stride = (_TILE_STRIDE_WIDE if wide else
              _TILE_STRIDE_PACKED if packed else _TILE_STRIDE)
    return max((threads // 32) * 32 * stride, 8 * 32 * 33 if floats else 0)


def _smem_bytes(K: int, B: int, S: int, threads: int, scan: bool,
                floats: bool, packed: bool = False,
                wide: bool = False) -> int:
    """grouped_hist.cuh's layout: the persistent [4K+1] words (slot ids,
    duplicate chains, offsets, write positions) rounded to 16 bytes, then
    the largest of the grouping's two [warps, K] tables, [K] totals and
    leaf id -> slot table,
    the histogram's [B, S, 32] sums of B bins (a bin tile, for wide bins)
    and the bins tiles, and, for B2, the scan's words.  int32 sums take a
    row stride of 33 words, f32 sums 32."""
    persist = (4 * K + 1 + 3) // 4 * 4
    sums = B * S * (32 if floats else 33) + _tiles_words(threads, floats,
                                                         packed, wide)
    union = max(2 * (threads // 32) * K + K + _TABLE_WORDS, sums,
                (threads // 256) * _SCAN_WORDS if scan else 0)
    return 4 * (persist + union)


def _wide_tiles(K: int, B: int, S: int, threads: int, scan: bool,
                floats: bool, limit: int):
    """(tiles, bins a tile) of wide bins in a block of `threads` with
    `limit` bytes of shared memory, or None: the fewest tiles whose sums
    fit, their bins balanced and a multiple of 4 (the f32 flush's 16-byte
    atomics start at a tile's first bin)."""
    fixed = _smem_bytes(K, 0, S, threads, scan, floats, wide=True)
    if fixed > limit:
        return None
    per_bin = 4 * S * (32 if floats else 33)
    tiles_bytes = 4 * _tiles_words(threads, floats, False, True)
    persist = 4 * ((4 * K + 1 + 3) // 4 * 4)
    most = (limit - persist - tiles_bytes) // per_bin // 4 * 4
    if most < 4:
        return None
    tiles = -(-B // most)
    per_tile = -(-B // tiles)
    return tiles, -(-per_tile // 4) * 4


def hist_plan(F: int, K: int, S: int, B: int, n: int, sms: int,
              smem_max: int, smem_sm: int, scan: bool = False,
              floats: bool = False, packed: bool = False,
              wide: bool = False,
              resident: Optional[Callable[[int, int, int], int]] = None
              ) -> HistPlan:
    """Geometry of kernel B1 (and of B2's histogram phases).

    Features go in chunks of 32, one per lane, so one slot's [B, S, 32]
    sums (163,200 bytes at B = 255, S = 5) always fit a block.  Where two
    blocks fit an SM's shared memory (smem_sm), blocks have 512 threads
    and two share an SM; else one block of 1024.  The grid is every
    block the card holds at once, as a cooperative launch needs.  Each
    block groups a tile of ceil(n / grid) rows, rounded to 4 x its
    threads (each warp takes an equal part of it).  scan: the call is
    kernel B2's, whose split scan also needs shared memory.  packed: the
    bins are 4-bit (B <= 16), so a slot's sums take [16, S, 32] words at
    most and each warp's bins tile 5 words an entry, not 9; the block
    geometry is the same (registers, not shared memory, hold a 512-thread
    block to two per SM: __launch_bounds__(1024) lets a thread 64).
    These plans have clusters of one block.

    wide: the bins are 16-bit (B up to MAX_WIDE_BINS), each warp's bins
    tile 17 words an entry, and a slot's sums are spread over a cluster
    of `cluster` blocks, each holding `bin_tile` bins (a tile): the
    cluster holds a tile group, and each list entry is walked once per
    tile group (`plan_walks`).  For each of 512 threads two to an SM,
    512 alone and 1024 alone, the plan cuts B into the fewest balanced
    tiles whose sums fit the block, and takes C = ceil(tiles / walks)
    blocks a cluster, walks = ceil(tiles / MAX_CLUSTER), so that C <= 8
    and the tile groups are even.  It keeps the geometry with the fewest
    walks, then the most threads resident, then the smallest C (fewer
    adds go to another block).  resident(threads, smem, C) is the number
    of such clusters the card holds at once (the occupancy query of the
    kernel's instance, which knows that GPC boundaries leave some SMs out
    of clusters; required for wide), and the grid is that many clusters,
    C blocks each.  At S = 5 and B = 1024 on an H100 each entry is
    walked once: 1024 threads alone, 5 tiles of 208 bins, C = 5."""
    top = MAX_WIDE_BINS if wide else (16 if packed else 256)
    if not (1 <= S <= 5 and 1 <= K < 255 and 1 <= B <= top
            and F >= 1 and n >= 1 and sms >= 1) or (packed and wide):
        raise ValueError(f"no histogram plan for F={F}, K={K}, S={S}, "
                         f"B={B}, n={n}, sms={sms}")
    chunks = -(-F // 32)
    cluster = 1
    if wide:
        if resident is None:
            raise ValueError("a wide plan needs the clusters the card "
                             "holds at once (resident)")
        best = None
        for threads, per_sm in ((512, 2), (512, 1), (1024, 1)):
            limit = min(smem_max,
                        smem_sm // per_sm - _SMEM_PER_BLOCK_RESERVED)
            fit = _wide_tiles(K, B, S, threads, scan, floats, limit)
            if fit is None:
                continue
            bin_tile = fit[1]
            tiles = -(-B // bin_tile)
            walks = -(-tiles // MAX_CLUSTER)
            c = -(-tiles // walks)
            smem = _smem_bytes(K, bin_tile, S, threads, scan, floats,
                               wide=True)
            held = resident(threads, smem, c)
            if held < 1:
                continue
            key = (walks, -held * c * threads, c)
            if best is None or key < best[0]:
                best = (key, threads, smem, bin_tile, c, held * c)
        if best is None:
            raise ValueError(f"no bin tile of the wide histogram fits "
                             f"the card's {smem_max} bytes a block")
        _, threads, smem, bin_tile, cluster, grid = best
    else:
        bin_tile = B
        small = _smem_bytes(K, B, S, 512, scan, floats, packed)
        if 2 * (small + _SMEM_PER_BLOCK_RESERVED) <= smem_sm:
            threads, per_sm, smem = 512, 2, small
        else:
            threads, per_sm = 1024, 1
            smem = _smem_bytes(K, B, S, threads, scan, floats, packed)
        grid = sms * per_sm
    if smem > smem_max or smem + _SMEM_PER_BLOCK_RESERVED > smem_sm:
        raise ValueError(f"the histogram needs {smem} bytes of shared "
                         f"memory; the card gives a block {smem_max}")
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
    return HistPlan(threads, smem, chunks, grid, seg_rows, tile, bin_tile,
                    cluster, scratch)


def plan_walks(plan: HistPlan, B: int) -> int:
    """Walks of each grouped-list entry per (segment, feature chunk): the
    tile groups, ceil(tiles / cluster) (1 but for wide bins past 8
    tiles)."""
    tiles = -(-B // plan.bin_tile)
    return -(-tiles // plan.cluster)


def cluster_schedule(offsets, F: int, B: int, bins, plan: HistPlan):
    """Plain model of phase C's schedule in the wide instances
    (grouped_hist.cuh phase_hist_cluster, with the same formulas): the
    items (segment x chunk x tile group) over the grid's clusters, the
    shares of a slot's entries over a cluster's C x nw warps (32 entries
    a warp at a time), and each lane's owner block (ClusterSums::add).
    offsets: the [K + 1] slot offsets of the grouped list; bins: [m, F]
    ints, entry e's bin of feature f.  Returns (adds, tile, walked):
    [m, F] the adds each (entry, feature) got and the tile whose block
    took the last of them (-1: none), and [m, chunks] the walks of each
    entry in each chunk."""
    offsets = [int(o) for o in offsets]
    bins = np.asarray(bins, dtype=np.int64)
    K, m = len(offsets) - 1, offsets[-1]
    C, bt, nw = plan.cluster, plan.bin_tile, plan.threads // 32
    NC = plan.grid // C
    walks = plan_walks(plan, B)
    adds = np.zeros((m, F), np.int64)
    tile = np.full((m, F), -1, np.int64)
    walked = np.zeros((m, plan.chunks), np.int64)
    if m == 0:
        return adds, tile, walked
    R = max(plan.seg_rows, -(-m * plan.chunks * walks // NC))
    nr = -(-m // R)
    items = nr * plan.chunks * walks
    for cid in range(NC):
        for t in range(cid, items, NC):
            g, rest = t % walks, t // walks
            c, i = rest // nr, rest % nr
            lo, hi = i * R, min(m, i * R + R)
            f0, fc = 32 * c, min(32, F - 32 * c)
            gb0 = g * C * bt
            n = min(C * bt, B - gb0)
            for k in range(K):
                s0, e0 = max(lo, offsets[k]), min(hi, offsets[k + 1])
                if s0 >= e0:
                    continue
                for rank in range(C):
                    # warp rank * nw + w takes the w0-th 32 entries of
                    # every C * nw * 32
                    idx = np.arange(s0, e0)
                    w0 = ((idx - s0) // 32) % (C * nw)
                    idx = idx[w0 // nw == rank]
                    walked[idx, c] += 1
                    b = bins[idx, f0:f0 + fc] - gb0
                    ok = (b >= 0) & (b < n)
                    owner = np.zeros_like(b)
                    for _ in range(1, MAX_CLUSTER):
                        over = b >= bt
                        b = np.where(over, b - bt, b)
                        owner += over
                    e, f = np.nonzero(ok)
                    adds[idx[e], f0 + f] += 1
                    tile[idx[e], f0 + f] = g * C + owner[e, f]
    return adds, tile, walked


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> tuple:
    """(SMs, opt-in shared memory of a block, shared memory of an SM)."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        kernels.check(kernels.library().lgbt_device_limits(out),
                      "device limits")
    return tuple(out)


def row_major_bins(bins_t: torch.Tensor,
                   packed_block: int = 0) -> torch.Tensor:
    """[n, FR] uint8 copy of the [F, n] bins, FR = F rounded up to 32
    (padding bytes 0): one row's bins of a 32-feature chunk are one
    32-byte sector.  Made once and kept on bins_t itself, so every call
    on the same matrix (the learner's, for the whole training) reuses
    it; an in-place change of bins_t makes a new one.

    int32 (wide) bins_t: the copy is [n, FR] int16 holding each bin's low
    16 bits, which the kernels read unsigned (bins up to 65,535): one row
    of a 32-feature chunk is 64 bytes, four 16-byte loads.

    packed_block > 0: bins_t is packed 4-bit [F, n/2] in blocks of that
    many rows, and the copy is [n, FR/2], two features a byte (feature
    2j of a chunk in the low nibble of its byte j, 2j + 1 in the high
    one): one row of a 32-feature chunk is one 16-byte load."""
    cached = row_major_cached(bins_t, packed_block)
    if cached is not None:
        return cached
    F = bins_t.shape[0]
    fr = -(-F // 32) * 32
    if packed_block:
        full = unpack2d(bins_t, packed_block)
        n = full.shape[1]
        cols = torch.zeros((fr, n), dtype=torch.uint8, device=bins_t.device)
        cols[:F] = full
        del full
        rows = (cols[0::2] | (cols[1::2] << 4)).t().contiguous()
    else:
        n = bins_t.shape[1]
        # int32 -> int16 keeps the low 16 bits (a two's-complement wrap)
        dtype = torch.int16 if bins_t.dtype == torch.int32 else torch.uint8
        rows = torch.zeros((n, fr), dtype=dtype, device=bins_t.device)
        rows[:, :F] = bins_t.t()
    bins_t._lgbt_rows = ((bins_t._version, packed_block), rows)
    return rows


def row_major_cached(bins_t: torch.Tensor,
                     packed_block: int = 0) -> Optional[torch.Tensor]:
    """The row-major copy `row_major_bins` keeps on bins_t, or None when
    none was made (on the CPU the twins read bins_t itself)."""
    cached = getattr(bins_t, "_lgbt_rows", None)
    if cached is not None and cached[0] == (bins_t._version, packed_block):
        return cached[1]
    return None


# the largest int32 scratch of a B1/B2/B4 call since the last
# `reset_call_bytes` (utils/membudget.py holds its plan to it)
PEAK_CALL_BYTES = {"kernel_scratch": 0}


def reset_call_bytes() -> None:
    PEAK_CALL_BYTES["kernel_scratch"] = 0


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


@functools.lru_cache(maxsize=None)
def _resident_clusters(index: int, scan: bool, ints: bool, flat: bool,
                       threads: int, smem: int, cluster: int) -> int:
    """Clusters of the wide instance of B1, B4 (flat) or B2 (scan) that
    the card holds at once at this geometry: the occupancy query of the
    kernel itself."""
    out = (ctypes.c_int * 1)()
    lib = kernels.library()
    with torch.cuda.device(index):
        code = (lib.lgbt_fused_clusters(threads, smem, cluster, out) if scan
                else lib.lgbt_hist_clusters(int(ints), int(flat), threads,
                                            smem, cluster, out))
    kernels.check(code, "resident clusters")
    return out[0]


def call_plan(bins_t, S: int, n: int, K: int, num_bins: int, floats: bool,
              scan: bool = False, packed_block: int = 0,
              flat: bool = False) -> HistPlan:
    """The plan of one call of B1, B4 (flat) or B2 (scan) on the card
    that holds bins_t: its limits, and for wide bins the clusters that
    card holds of the instance the call launches."""
    index = bins_t.device.index
    if index is None:
        index = torch.cuda.current_device()
    code, _ = bins_layout(bins_t, packed_block)
    resident = functools.partial(_resident_clusters, index, scan,
                                 not floats, flat)
    return hist_plan(bins_t.shape[0], K, S, int(num_bins), n,
                     *_device_limits(index), scan=scan, floats=floats,
                     packed=code == BINS_PACKED, wide=code == BINS_WIDE,
                     resident=resident)


def _grouped_call(bins_t, stats, slot_leaf_ids, num_bins: int,
                  scan: bool = False, packed_block: int = 0,
                  flat: bool = False):
    """Row-major bins, plan, scratch and ctypes plan of one call."""
    S, n = stats.shape
    K = slot_leaf_ids.shape[0]
    if S * stats.element_size() > _MAX_STATS_BYTES:
        raise ValueError(f"{S} {stats.dtype} stat rows exceed the kernel's "
                         f"{_MAX_STATS_BYTES} bytes a row")
    rows = row_major_bins(bins_t, packed_block)
    plan = call_plan(bins_t, S, n, K, num_bins, stats.is_floating_point(),
                     scan, packed_block, flat)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=bins_t.device)
    PEAK_CALL_BYTES["kernel_scratch"] = max(
        PEAK_CALL_BYTES["kernel_scratch"], int(scratch.nbytes))
    return rows, plan, scratch, (ctypes.c_int * 8)(*plan[:8])


def _raw_buffer(K, F, B, S, dtype, device):
    """The kernels' output: [K, F, BSp], a (slot, feature) row of B * S
    sums padded to a multiple of 4 words (16-byte vector atomics)."""
    return torch.empty((K, F, -(-B * S // 4) * 4), dtype=dtype,
                       device=device)


def _raw_view(raw, F, B, S):
    """[K, F, B, S] view of a `_raw_buffer` (the padding left out)."""
    return raw[:, :, :B * S].view(raw.shape[0], F, B, S)


def _launch_hist(bins_t, stats, leaf_ids, slot_leaf_ids, num_bins: int,
                 group_only: bool, packed_block: int = 0,
                 flat: bool = False):
    F = bins_t.shape[0]
    S, n = stats.shape
    K = slot_leaf_ids.shape[0]
    rows, plan, scratch, cplan = _grouped_call(
        bins_t, stats, slot_leaf_ids, num_bins, packed_block=packed_block,
        flat=flat)
    raw = _raw_buffer(K, F, int(num_bins), S, _acc_dtype(stats),
                      bins_t.device)
    with torch.cuda.device(bins_t.device):
        code = kernels.library().lgbt_hist_batched(
            rows.data_ptr(), rows.shape[1] * rows.element_size(),
            bins_layout(bins_t, packed_block)[0], stats.data_ptr(),
            _STAT_KINDS[stats.dtype], leaf_ids.data_ptr(),
            slot_leaf_ids.data_ptr(), scratch.data_ptr(), raw.data_ptr(), F,
            n, S, K, int(num_bins), cplan, int(group_only), int(flat),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "hist_batched launch")
    return _raw_view(raw, F, int(num_bins), S).permute(1, 2, 0, 3), plan, \
        scratch


def hist_batched_kernel(bins_t: torch.Tensor, stats: torch.Tensor,
                        leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                        num_bins: int, packed_block: int = 0) -> torch.Tensor:
    """Kernel B1 on the card: raw [F, B, K, S] sums (f32, or int32 for
    int8/int16 stats: the integer variant, counted apart).  One
    cooperative launch: the grouping pass, then the histogram.
    packed_block > 0: the packed 4-bit variant (bins_t [F, n/2] in
    blocks of that many rows); int32 bins_t: the wide variant; each
    counted apart too."""
    _check_hist_args("B1", bins_t, stats, leaf_ids, slot_leaf_ids,
                     num_bins, packed_block)
    raw, _, _ = _launch_hist(bins_t, stats, leaf_ids, slot_leaf_ids,
                             num_bins, False, packed_block)
    name = "hist_batched" + bins_layout(bins_t, packed_block)[1]
    kernels.launches[name if raw.dtype == torch.float32
                     else name + "_int"] += 1
    return raw


def hist_group_kernel(bins_t: torch.Tensor, stats: torch.Tensor,
                      leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                      num_bins: int):
    """Kernel B1 stopped after its grouping pass: (rows, offsets) as
    `group_rows_plain` gives them.  For the tests; not counted."""
    _check_hist_args("B1", bins_t, stats, leaf_ids, slot_leaf_ids,
                     num_bins)
    n = stats.shape[1]
    K = slot_leaf_ids.shape[0]
    _, plan, scratch = _launch_hist(bins_t, stats, leaf_ids, slot_leaf_ids,
                                    num_bins, True)
    at = 5 * n + plan.grid * K
    offsets = scratch[at:at + K + 1].clone()
    m = int(offsets[K].item())
    return scratch[4 * n:4 * n + m].clone(), offsets


def hist_flat_kernel(bins_t: torch.Tensor, stats: torch.Tensor,
                     leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                     num_bins: int, packed_block: int = 0) -> torch.Tensor:
    """Kernel B4 on the card (the flat variant): raw [F, B, K, S] sums,
    f32 or int32; B1's contract, on the flat path's operands (256-row
    blocks; packed_block > 0: 4-bit bins packed in blocks of that many
    rows; int32 bins_t: wide bins).  The grouped body of B1 under B4's
    own instance, one cooperative launch; its six variants are counted
    apart."""
    _check_hist_args("B4", bins_t, stats, leaf_ids, slot_leaf_ids,
                     num_bins, packed_block)
    raw, _, _ = _launch_hist(bins_t, stats, leaf_ids, slot_leaf_ids,
                             num_bins, False, packed_block, flat=True)
    name = "hist_flat" + bins_layout(bins_t, packed_block)[1]
    kernels.launches[name if raw.dtype == torch.float32
                     else name + "_int"] += 1
    return raw


def build_histogram_batched_t(bins_t: torch.Tensor, stats: torch.Tensor,
                              leaf_ids: torch.Tensor,
                              slot_leaf_ids: torch.Tensor, num_bins: int,
                              precision: str = "hilo",
                              impl: str = "pallas2",
                              packed_block: int = 0) -> torch.Tensor:
    """Histograms of K leaves in one pass: [K, F, B, 3] (g, h, cnt), f32
    or, for the integer precisions, int32.

    bins_t:        [F, n] uint8 or int32 (wide) bins (rows contiguous)
    stats:         [S, n] packed rows from `pack_stats`
    leaf_ids:      [n] int32 current leaf per row
    slot_leaf_ids: [K] int32 leaf wanted in each slot (-1 = dead slot)
    impl:          "pallas" takes kernel B4 on the card; every other
                   histogram implementation takes kernel B1
    packed_block:  > 0: bins_t is packed 4-bit [F, n/2] in blocks of this
                   many rows (the packed variant of B1 or B4)

    A CPU tensor goes through `hist_batched_plain`.  precision="f64"
    (deterministic=true, an XLA-only path in the JAX package) takes
    `hist_batched_f64` on every device and no kernel."""
    if precision == "f64":
        if packed_block:
            raise ValueError("f64 histograms take unpacked bins")
        raw = hist_batched_f64(bins_t, stats, leaf_ids, slot_leaf_ids,
                               num_bins)
    elif bins_t.device.type == "cuda":
        kernel = hist_flat_kernel if impl == "pallas" \
            else hist_batched_kernel
        raw = kernel(bins_t, stats, leaf_ids, slot_leaf_ids, num_bins,
                     packed_block)
    elif bins_t.device.type == "cpu":
        raw = hist_batched_plain(bins_t, stats, leaf_ids, slot_leaf_ids,
                                 num_bins, packed_block)
    else:
        raise ValueError(f"unsupported device {bins_t.device}")
    return _unpack_hist(raw.permute(3, 2, 0, 1), precision)
