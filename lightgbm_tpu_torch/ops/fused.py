"""The grow megakernel and the row-partition kernel.

The port of `lightgbm_tpu/ops/fused.py`.

`fused_hist_scan` is the frontier step of the quantized grower
(tpu_hist_impl=fused): the int32 histograms of the K smaller children,
sibling subtraction against the parents' pooled histograms, and the
per-feature split scan of all 2K children, returned as flat
`pack_pf_records` rows.  On a CUDA tensor it launches kernel B2
(`csrc/fused.cu`: kernel B1's grouped integer histogram and the split
scan in one cooperative launch); on a CPU tensor it runs
`fused_hist_scan_plain`, the same function in plain PyTorch.  The scan
runs on exact int32 prefix sums and then the same elementwise f32 math
as the grower's own split search, so the records are bitwise equal to
it: the two paths grow the
same trees.  `probe_fused` runs the kernel against its twin on tiny
operands before the learner trusts it, and raises on any difference.

`partition_rows` is the K-way frontier partition in one pass over the
rows (tpu_partition_impl=kernel).  On a CUDA tensor it launches kernel
B3 (`csrc/partition.cu`); on a CPU tensor it runs
`partition_rows_plain`, the "vselect" integer math in plain PyTorch.
Both are bitwise equal to the "vselect" lowering.

Both take uint8 bins or the int32 bins of wide features (more than 256
bins): B2's wide instance reads the 16-bit row-major copy and scans the
bins in tiles of 256, B3's reads the int32 matrix in place; each is
counted apart ("_wide").
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import compile_ledger
from . import kernels
from .histogram import (BINS_WIDE, INT_PRECISIONS, MAX_WIDE_BINS,
                        _STAT_KINDS, _grouped_call, _raw_buffer, _raw_view,
                        _unpack_hist, bins_layout, hist_batched_plain,
                        unpack2d)
from .split import (PF_RECORD_WIDTH, numeric_go_left, pack_pf_records,
                    per_feature_best_split)

# ctx-row column layout (the JAX package's fused.py CTX_*): row j < 2K is
# child j's (sum_g, sum_h, count, min_constraint, max_constraint,
# use_small); row 2K holds the dequantization scales (g, h, 1.0)
CTX_SUM_G, CTX_SUM_H, CTX_COUNT, CTX_MIN_C, CTX_MAX_C, CTX_USE_SMALL = \
    range(6)
CTX_WIDTH = 8
SPLIT_KW = ("l1", "l2", "max_delta_step", "min_data_in_leaf",
            "min_sum_hessian", "min_gain_to_split")


def fused_supported(precision: str, *, bynode: bool = False,
                    has_cat: bool = False, has_bundles: bool = False,
                    has_cegb: bool = False, forced: bool = False):
    """Reason the in-kernel split scan cannot engage, or None if it can
    (lightgbm_tpu/ops/fused.py:73-98, on the serial learner): the scan
    needs the exact int32 sums of int8/int16 and one feature mask for
    every child, and categorical splits, EFB bundle columns, CEGB
    penalties and forced splits each reshape the search itself."""
    if precision not in INT_PRECISIONS:
        return (f"precision={precision!r} (the in-kernel scan needs the "
                "exact int32 accumulation of int8/int16)")
    if bynode:
        return "feature_fraction_bynode (per-node masks)"
    for flag, name in ((has_cat, "categorical splits"),
                       (has_bundles, "EFB bundling"),
                       (has_cegb, "CEGB"),
                       (forced, "forced splits")):
        if flag:
            return name
    return None


def fused_hist_scan_plain(bins_t, stats, leaf_ids, slot_leaf_ids,
                          parent_hist, child_ctx, meta_i, meta_f,
                          num_bins: int, precision: str, *, split_kw: dict):
    """Plain PyTorch twin of kernel B2.

    bins_t [F, n] uint8 or int32; stats [3, n] int8/int16; leaf_ids [n]
    int32;
    slot_leaf_ids [K] int32 (-1 = dead); parent_hist [K, F, B, 3] int32;
    child_ctx [2K+1, 8] f32 (the CTX_* columns); meta_i [F, 8] int32
    (num_bin, missing_type, default_bin, monotone); meta_f [F, 8] f32
    (penalty, feature_mask); split_kw: the six split scalars.

    Returns (hist [K, F, B, 3] int32 smaller-child histograms, records
    [2K, F, PF_RECORD_WIDTH] f32 per-child per-feature best splits), as
    the JAX package's `fused_hist_scan` does."""
    K = slot_leaf_ids.shape[0]
    C = 2 * K
    raw = hist_batched_plain(bins_t, stats, leaf_ids, slot_leaf_ids,
                             num_bins)
    hist = _unpack_hist(raw.permute(3, 2, 0, 1), precision)
    kk = torch.arange(C, device=hist.device) % K
    small = hist[kk]
    large = parent_hist[kk] - small
    use_small = child_ctx[:C, CTX_USE_SMALL] > 0
    hs = torch.where(use_small[:, None, None, None], small, large)
    pf = per_feature_best_split(
        hs, child_ctx[:C, CTX_SUM_G], child_ctx[:C, CTX_SUM_H],
        child_ctx[:C, CTX_COUNT], meta_i[:, 0], meta_i[:, 1],
        meta_i[:, 2], meta_i[:, 3], meta_f[:, 0], meta_f[:, 1],
        min_constraint=child_ctx[:C, CTX_MIN_C],
        max_constraint=child_ctx[:C, CTX_MAX_C],
        acc_scale=child_ctx[C, :3], **split_kw)
    return hist, pack_pf_records(pf)


def _launch_fused(bins_t, stats, leaf_ids, slot_leaf_ids, parent_hist,
                  child_ctx, meta_i, meta_f, num_bins: int, precision: str,
                  split_kw: dict):
    """Check the operands and launch kernel B2 (uncounted)."""
    F, n = bins_t.shape
    K = slot_leaf_ids.shape[0]
    C = 2 * K
    B = int(num_bins)
    dev = bins_t.device
    if dev.type != "cuda":
        raise ValueError(f"kernel B2 takes CUDA tensors, got {dev}")
    layout, _ = bins_layout(bins_t)
    top = MAX_WIDE_BINS if layout == BINS_WIDE else 256
    expect = (("bins_t", bins_t, bins_t.dtype, (F, n)),
              ("stats", stats, stats.dtype, (3, n)),
              ("leaf_ids", leaf_ids, torch.int32, (n,)),
              ("slot_leaf_ids", slot_leaf_ids, torch.int32, (K,)),
              ("parent_hist", parent_hist, torch.int32, (K, F, B, 3)),
              ("child_ctx", child_ctx, torch.float32, (C + 1, CTX_WIDTH)),
              ("meta_i", meta_i, torch.int32, (F, 8)),
              ("meta_f", meta_f, torch.float32, (F, 8)))
    for name, t, dtype, shape in expect:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"{list(shape)} tensor on {dev}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
    if precision not in INT_PRECISIONS \
            or stats.dtype not in (torch.int8, torch.int16):
        raise ValueError("kernel B2 takes the [3, n] int8/int16 stats of "
                         "the quantized precisions")
    if not 1 <= B <= top or not 1 <= K < 255:
        raise ValueError(f"num_bins={B} or {K} slots out of range")
    rows, plan, scratch, cplan = _grouped_call(bins_t, stats, slot_leaf_ids,
                                               B, scan=True)
    raw = _raw_buffer(K, F, B, 3, torch.int32, dev)
    records = torch.empty((C, F, PF_RECORD_WIDTH), dtype=torch.float32,
                          device=dev)
    kw = [float(split_kw[k]) for k in SPLIT_KW]
    with torch.cuda.device(dev), compile_ledger.launch(
            "fused_hist_scan", "fused_hist_scan" + bins_layout(bins_t)[1],
            plan, int(scratch.nbytes)):
        code = kernels.library().lgbt_fused_hist_scan(
            rows.data_ptr(), rows.shape[1] * rows.element_size(), layout,
            stats.data_ptr(),
            _STAT_KINDS[stats.dtype], leaf_ids.data_ptr(),
            slot_leaf_ids.data_ptr(), scratch.data_ptr(), raw.data_ptr(),
            parent_hist.data_ptr(), child_ctx.data_ptr(), meta_i.data_ptr(),
            meta_f.data_ptr(), records.data_ptr(), F, n, K, B, cplan, *kw,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "fused_hist_scan launch")
    return _raw_view(raw, F, B, 3), records


def fused_hist_scan_kernel(bins_t, stats, leaf_ids, slot_leaf_ids,
                           parent_hist, child_ctx, meta_i, meta_f,
                           num_bins: int, precision: str, *,
                           split_kw: dict):
    """Kernel B2 on the card; `fused_hist_scan_plain`'s contract.  Its
    wide instance (int32 bins_t) is counted apart."""
    out = _launch_fused(bins_t, stats, leaf_ids, slot_leaf_ids, parent_hist,
                        child_ctx, meta_i, meta_f, num_bins, precision,
                        split_kw)
    kernels.count("fused_hist_scan" + bins_layout(bins_t)[1])
    return out


def fused_hist_scan(bins_t, stats, leaf_ids, slot_leaf_ids, parent_hist,
                    child_ctx, meta_i, meta_f, num_bins: int,
                    precision: str, *, split_kw: dict):
    """The grow megakernel: kernel B2 on a CUDA tensor, its twin on a
    CPU tensor.  See `fused_hist_scan_plain` for the operands."""
    args = (bins_t, stats, leaf_ids, slot_leaf_ids, parent_hist, child_ctx,
            meta_i, meta_f, num_bins, precision)
    if bins_t.device.type == "cuda":
        return fused_hist_scan_kernel(*args, split_kw=split_kw)
    if bins_t.device.type == "cpu":
        return fused_hist_scan_plain(*args, split_kw=split_kw)
    raise ValueError(f"unsupported device {bins_t.device}")


def probe_operands(precision: str, device, seed: int = 0, wide: bool = False):
    """Tiny seeded operands of B2 (the shapes of the JAX package's
    `fused_scan_ok` probe: 256 rows, 8 features, 16 bins, K = 2): a
    positional tuple and the split_kw.  wide: int32 bins over 600 bins
    (three scan tiles), for B2's wide instance."""
    rng = np.random.default_rng(seed)
    n, F, B, K = 256, 8, (600 if wide else 16), 2
    q = 127 if precision == "int8" else 32767
    dt = torch.int8 if precision == "int8" else torch.int16
    bins = torch.from_numpy(rng.integers(0, B, size=(F, n)).astype(
        np.int32 if wide else np.uint8))
    g = rng.integers(-q, q + 1, size=n)
    h = rng.integers(0, q + 1, size=n)
    stats = torch.from_numpy(np.stack([g, h, np.ones(n, np.int64)])).to(dt)
    leaf = torch.from_numpy(rng.integers(0, 2, size=n).astype(np.int32))
    slots = torch.tensor([0, 1], dtype=torch.int32)
    small = _unpack_hist(hist_batched_plain(bins, stats, leaf, slots, B)
                         .permute(3, 2, 0, 1), precision)
    parent = (small.sum(0, keepdim=True).expand_as(small) * 2).to(
        torch.int32).contiguous()
    C = 2 * K
    scales = np.array([0.5, 0.25, 1.0], np.float32)
    ctx = np.zeros((C + 1, CTX_WIDTH), np.float32)
    for j in range(C):
        # slot k's smaller child is its left one for even k
        use_small = (j < K) == (j % K % 2 == 0)
        hs = small[j % K] if use_small else parent[j % K] - small[j % K]
        # the child's totals from its feature-0 bins (every row lands in
        # one bin of each feature), so the scan finds real splits
        tot = hs[0].sum(0).numpy().astype(np.float32) * scales
        ctx[j, :6] = [tot[0], tot[1], tot[2], -1e30, 1e30, float(use_small)]
    ctx[C, :3] = scales
    meta_i = np.zeros((F, 8), np.int32)
    meta_i[:, 0] = B
    meta_i[:, 1] = np.arange(F) % 3              # none, zero, NaN missing
    meta_i[:, 2] = np.arange(F) % B
    meta_f = np.zeros((F, 8), np.float32)
    meta_f[:, 0] = 1.0
    meta_f[:, 1] = 1.0
    split_kw = dict(l1=0.0, l2=1.0, max_delta_step=0.0, min_data_in_leaf=1.0,
                    min_sum_hessian=1e-3, min_gain_to_split=0.0)
    args = tuple(t.to(device) for t in (
        bins, stats, leaf, slots, parent, torch.from_numpy(ctx),
        torch.from_numpy(meta_i), torch.from_numpy(meta_f)))
    return args + (B, precision), split_kw


def assert_fused_equal(got, ref) -> None:
    """Raise unless two (hist, records) results are bitwise equal."""
    if not torch.equal(got[0], ref[0]):
        raise RuntimeError("kernel B2's histograms differ from its twin's")
    a = got[1].contiguous().view(torch.int32)
    b = ref[1].contiguous().view(torch.int32)
    if not torch.equal(a, b):
        bad = (a != b).nonzero()[:4].tolist()
        raise RuntimeError(f"kernel B2's split records differ from its "
                           f"twin's at [child, feature, field] {bad}")


@functools.lru_cache(maxsize=8)
def probe_fused(device: torch.device, precision: str,
                wide: bool = False) -> None:
    """Run kernel B2 against its twin on tiny operands on the card; raise
    on any difference (there is no fallback to hide behind).  wide: its
    wide instance, at int32 bins.  A check, not a use: its launch is not
    counted."""
    args, kw = probe_operands(precision, device, wide=wide)
    got = _launch_fused(*args, kw)
    ref = fused_hist_scan_plain(*args, split_kw=kw)
    assert_fused_equal(got, ref)


def fix_bundle_col(raw, off, nbf, fixed):
    """Bundle column -> feature-space bin, elementwise (grower.py:
    1197-1206 of the JAX package).  Bins outside the feature's
    [offset+1, offset+num_bin-1] range are another bundle member's
    value, so there this feature sits at its all-default bin 0; columns
    of unbundled features (`fixed` false) pass through."""
    rel = raw - off
    in_rng = (rel >= 1) & (rel < nbf)
    return torch.where(fixed, torch.where(in_rng, rel, 0), raw)


def partition_rows_plain(bins_t, sel_feat, leaf_ids, sel, new_ids, thr,
                         dleft, mt, nbf, db, do_k, packed_block: int = 0,
                         iscat=None, cmask=None, bundle=None
                         ) -> torch.Tensor:
    """The "vselect" partition: [n] int32 updated leaf ids.

    bins_t: [F, n] uint8 or int32 bins (or 4-bit packed [F, n/2] in
    blocks of packed_block rows, when > 0);
    sel_feat/sel/new_ids/thr/mt/nbf/db: [K] int32; dleft/do_k: [K] bool;
    iscat [K] bool and cmask [K, B] f32 (categorical splits: a row goes
    left where its bin's mask entry is set, grower.py:1331-1338 of the
    JAX package), or None; bundle: the split features' ([K] int32
    bundle column, [K] int32 bin offset, [K] bool needs_fix) when
    bins_t holds EFB bundle columns, else None."""
    cols = bins_t[(sel_feat if bundle is None else bundle[0]).long()]
    if packed_block:
        cols = unpack2d(cols, packed_block)
    cols = cols.to(torch.int32)                                 # [K, n]
    if bundle is not None:
        cols = fix_bundle_col(cols, bundle[1][:, None], nbf[:, None],
                              bundle[2][:, None])
    go_left = numeric_go_left(cols, mt[:, None], nbf[:, None], db[:, None],
                              thr[:, None], dleft[:, None])
    if iscat is not None:
        cm = torch.gather(cmask, 1, cols.long())
        go_left = torch.where(iscat[:, None], cm > 0.5, go_left)
    move = (leaf_ids[None, :] == sel[:, None]) & do_k[:, None] & ~go_left
    # each row sits in at most one frontier leaf: the max over slots is
    # its unique new id, -1 = stay
    moved_to = torch.where(move, new_ids[:, None].to(torch.int32),
                           -1).amax(dim=0)
    return torch.where(moved_to >= 0, moved_to, leaf_ids)


# the largest K kernel B3 takes: its leaf id -> slot table holds bytes
# (csrc/partition.cu kMaxK)
_PARTITION_MAX_K = 254


def check_partition_args(bins_t, sel_feat, leaf_ids, sel, new_ids, thr,
                         dleft, mt, nbf, db, do_k) -> None:
    """The checks of kernel B3's wrapper, on any device: the slot
    parameters go to the kernel as they are, one pointer each (int32, and
    the two flags as bool or uint8 bytes), so nothing is converted or
    packed on the host per round."""
    F, n = bins_t.shape
    K = sel.shape[0]
    if bins_t.dtype not in (torch.uint8, torch.int32) \
            or not bins_t.is_contiguous():
        raise ValueError("bins_t must be a contiguous uint8 or int32 "
                         "[F, n] tensor")
    if leaf_ids.dtype != torch.int32 or leaf_ids.shape != (n,) \
            or not leaf_ids.is_contiguous():
        raise ValueError("leaf_ids must be a contiguous int32 [n] tensor")
    if not 1 <= K <= _PARTITION_MAX_K:
        raise ValueError(f"{K} slots; kernel B3 takes 1 to "
                         f"{_PARTITION_MAX_K}")
    for name, t in (("sel_feat", sel_feat), ("sel", sel),
                    ("new_ids", new_ids), ("thr", thr), ("dleft", dleft),
                    ("mt", mt), ("nbf", nbf), ("db", db), ("do_k", do_k)):
        flag = name in ("dleft", "do_k")
        ok = (torch.bool, torch.uint8) if flag else (torch.int32,)
        if t.shape != (K,) or t.device != bins_t.device \
                or t.dtype not in ok or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous [{K}] "
                f"{'bool' if flag else 'int32'} tensor on {bins_t.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def partition_rows_kernel(bins_t, sel_feat, leaf_ids, sel, new_ids, thr,
                          dleft, mt, nbf, db, do_k) -> torch.Tensor:
    """Kernel B3 on the card.  leaf_ids at a 16-byte aligned address
    takes the kernel's 16-byte loads; a slice at another address the
    scalar ones.  Its wide instance (int32 bins_t) is counted apart."""
    if bins_t.device.type != "cuda":
        raise ValueError(f"kernel B3 takes CUDA tensors, got {bins_t.device}")
    check_partition_args(bins_t, sel_feat, leaf_ids, sel, new_ids, thr,
                         dleft, mt, nbf, db, do_k)
    n = bins_t.shape[1]
    out = torch.empty_like(leaf_ids)         # its own, aligned allocation
    vec = leaf_ids.data_ptr() % 16 == 0
    wide = bins_t.dtype == torch.int32
    name = "partition_rows_wide" if wide else "partition_rows"
    with torch.cuda.device(bins_t.device), compile_ledger.launch(
            "partition_rows", name, (sel.shape[0], int(vec))):
        code = kernels.library().lgbt_partition_rows(
            bins_t.data_ptr(), int(wide), n, sel_feat.data_ptr(),
            sel.data_ptr(),
            new_ids.data_ptr(), thr.data_ptr(), dleft.data_ptr(),
            mt.data_ptr(), nbf.data_ptr(), db.data_ptr(), do_k.data_ptr(),
            leaf_ids.data_ptr(), out.data_ptr(), sel.shape[0], int(vec),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "partition_rows launch")
    kernels.count(name)
    return out


def partition_rows(bins_t, sel_feat, leaf_ids, sel, new_ids, thr, dleft,
                   mt, nbf, db, do_k) -> torch.Tensor:
    """Row->leaf partition of K splits at once: [n] int32 leaf ids.

    Slot k moves the rows of leaf sel[k] whose bin in feature
    sel_feat[k] does not go left to new_ids[k], when do_k[k]."""
    if bins_t.device.type == "cuda":
        return partition_rows_kernel(bins_t, sel_feat, leaf_ids, sel,
                                     new_ids, thr, dleft, mt, nbf, db, do_k)
    if bins_t.device.type == "cpu":
        return partition_rows_plain(bins_t, sel_feat, leaf_ids, sel,
                                    new_ids, thr, dleft, mt, nbf, db, do_k)
    raise ValueError(f"unsupported device {bins_t.device}")
