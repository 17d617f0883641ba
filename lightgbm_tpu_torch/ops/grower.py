"""Leaf-wise tree growth in batched frontier rounds, on the device.

The port of the serial, dense, numerical branch of
`lightgbm_tpu/ops/grower.py:_build_grower`; its module docstring explains
the design.  In short: leaf assignment is an [n] int32 vector; each round
picks the top-K leaves by stored best gain, partitions all K leaves' rows
in one pass, histograms all K smaller children in one batched pass
(kernel B1 on the card), derives the siblings by subtraction from a
dense [L, F, B, 3] histogram pool, and searches the best split of all 2K
children at once.  Step records go into an [L-1, W] buffer that the host
replays into a `Tree` later.

The JAX grower is one `lax.while_loop`.  Here the rounds are a host loop
of launches on PyTorch's stream: every per-round value (leaf ids, pool,
stored splits, the split counter) stays in device tensors, and the host
waits on the device once per loop round, for the stop test.  The frontier
ramp's pre-rounds run unconditionally, as in the JAX grower, and need no
stop test.  `grow` returns the number of those waits, so callers can
count host syncs.

Every state vector carries one extra trailing slot (index L): the slot
updates of dead slots land there, where the JAX grower drops
out-of-bounds scatter indices.  Nothing reads it back.

The quantized precisions (int8/int16) follow the JAX grower's quantized
branch: grad/hess are rounded once per tree onto an integer grid (max-abs
scales, stochastic rounding seeded from the tree's threefry key), the
histograms, the pool and sibling subtraction stay exact int32, and the
split search runs int32 prefix sums before it dequantizes.  With
hist_impl="fused" each round's histograms, subtraction and split scan
are one call (kernel B2 on the card), whose per-feature records the
round reduces to each child's best split.  quant_refit recomputes the
final leaf outputs from the f32 grad/hess sums of each leaf's rows.

With packed_bins the matrix is 4-bit packed [F, n_pad/2] in row blocks
of the JAX grower's size (grower.py:585-591): the histograms read it
packed (B1's packed variant on the card), and the select-family
partitions unpack the columns they test (`unpack2d`), as the JAX grower
does (grower.py:1238-1241,1277-1278,1303-1304).

With feature_fraction_bynode < 1 every node's split search sees its own
Bernoulli draw of the tree's features (grower.py:616-623): the root's
from a split of the tree key, each round's 2K children's from the next
split, `jax.random.uniform` over the padded feature axis, computed on
the host (`utils.prng.uniform`) and queued to the device.  As in the JAX
grower, the per-node masks take the fused scan away ("fused" then runs
the B1 histogram and the torch split search every round) and the
frontier ramp with it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.prng import fold_in, split, uniform
from .fused import (CTX_COUNT, CTX_MAX_C, CTX_MIN_C, CTX_SUM_G, CTX_SUM_H,
                    CTX_USE_SMALL, CTX_WIDTH, fused_hist_scan, partition_rows,
                    partition_rows_plain)
from .histogram import (INT_PRECISIONS, build_histogram_batched_t, key_words,
                        pack_stats, quant_limit, quantize_values, unpack2d)
from .leafsum import leaf_sums
from .predict import upload
from .split import (K_MIN_SCORE, finalize_split, leaf_output,
                    numeric_go_left, per_feature_best_split,
                    unpack_pf_records)

# record-row field indices (lightgbm_tpu/ops/grower.py REC_*)
REC_LEAF, REC_FEATURE, REC_THRESHOLD, REC_DEFAULT_LEFT, REC_GAIN, \
    REC_LEFT_OUTPUT, REC_RIGHT_OUTPUT, REC_LEFT_COUNT, REC_RIGHT_COUNT, \
    REC_LEFT_WEIGHT, REC_RIGHT_WEIGHT, REC_INTERNAL_VALUE, \
    REC_INTERNAL_WEIGHT, REC_INTERNAL_COUNT, REC_DID_SPLIT, \
    REC_IS_CAT = range(16)
REC_WIDTH = 16

PARTITION_IMPLS = ("select", "vselect", "kernel")


class GrowerParams(NamedTuple):
    """Grower configuration (the serial dense subset of the JAX
    package's GrowerParams)."""
    num_leaves: int
    num_bins: int          # bin-axis size B
    precision: str
    l1: float
    l2: float
    max_delta_step: float
    min_data_in_leaf: float
    min_sum_hessian: float
    min_gain_to_split: float
    max_depth: int
    # leaves split per round; 1 = strict reference best-first order
    split_batch: int = 16
    # batch only leaves whose gain >= alpha * the round's best gain
    split_batch_alpha: float = 0.0
    # "select" (K scalar passes), "vselect" (one [K, n] block, plain
    # torch) or "kernel" (kernel B3 on the card)
    partition_impl: str = "select"
    # frontier ramp: pre-rounds at K' = 1, s, s^2, ... < K before the
    # full-K loop; bit-identical trees, less dead-slot work
    ramp: bool = False
    ramp_step: int = 2
    # batched histogram: "pallas" (kernel B4 on the card), "fused" (the
    # grow megakernel B2 for int8/int16; the perfeature histogram
    # otherwise), anything else the perfeature kernel B1
    hist_impl: str = "pallas2"
    # bins stored 4-bit packed two rows a byte, in row blocks of
    # min(block_rows, n_pad) rows (the learner's layout)
    packed_bins: bool = False
    block_rows: int = 8192
    # int8/int16 only: grad/hess rounding ("stochastic" or "nearest"),
    # and the leaf refit from the f32 sums
    quant_round: str = "stochastic"
    quant_refit: bool = False
    # per-node feature sampling: each node's split search sees a
    # Bernoulli(fraction) subset of the tree's features, drawn over the
    # first `bynode_width` features (0: the whole padded axis)
    feature_fraction_bynode: float = 1.0
    bynode_width: int = 0


def resolve_split_batch(split_batch: int, num_leaves: int) -> int:
    """Auto-pick the per-round split batch K (lightgbm_tpu's rule: small
    trees stay nearly sequential, wide trees use K=25)."""
    if split_batch > 0:
        return split_batch
    return max(1, num_leaves // 16) if num_leaves < 192 else 25


def pad_rows(n: int, block_rows: int) -> int:
    """Rows padded up to a whole number of histogram blocks."""
    block = min(block_rows, max(n, 1))
    return ((n + block - 1) // block) * block


def _top_k(x: torch.Tensor, k: int):
    """`lax.top_k`: the k largest values, descending, ties by lower
    index first (a stable descending sort keeps that order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)




def grow(params: GrowerParams, bins_t: torch.Tensor, grad: torch.Tensor,
         hess: torch.Tensor, row_mask: torch.Tensor,
         feature_mask: torch.Tensor, meta: Dict[str, torch.Tensor],
         key: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """Grow one tree.

    bins_t: [F, n_pad] uint8, or int32 when a feature has more than 256
    bins (padding rows and features hold bin 0), or [F, n_pad/2] packed
    with params.packed_bins;
    grad/hess/row_mask: [n_pad] f32 (padding rows zero); feature_mask:
    [F] f32; meta: per-feature int32 num_bin/missing_type/default_bin/
    monotone and f32 penalty; key: the tree's threefry key (uint32[2],
    `utils.prng`), which seeds the stochastic rounding of int8/int16.

    Returns records [L-1, 16], leaf_ids [n_pad], leaf_output [L],
    leaf_cnt [L], leaf_sum_h [L] (device tensors) and syncs (int)."""
    quantized = params.precision in INT_PRECISIONS
    if quantized and params.quant_round not in ("stochastic", "nearest"):
        raise ValueError(f"tpu_quant_round={params.quant_round!r}; expected "
                         "stochastic or nearest")
    if quantized and key is None:
        raise ValueError("the quantized precisions need the tree's key")
    if params.partition_impl not in PARTITION_IMPLS:
        raise NotImplementedError(
            f"tpu_partition_impl={params.partition_impl!r} is not ported "
            f"to lightgbm_tpu_torch yet (ported: {PARTITION_IMPLS})")
    if params.ramp_step < 2:
        raise ValueError(f"ramp_step={params.ramp_step}; the frontier "
                         "bound needs a growth factor >= 2")
    if params.packed_bins and (
            params.partition_impl not in ("select", "vselect")
            or not params.hist_impl.startswith("pallas")):
        raise ValueError("packed 4-bit bins require the pallas histogram "
                         "impl and a select-family partition lowering")
    dev = bins_t.device
    L = params.num_leaves
    B = params.num_bins
    F = bins_t.shape[0]
    # rows come from grad, not bins_t: packed bins hold two rows a byte
    n_pad = grad.shape[0]
    block = min(params.block_rows, n_pad)
    block = n_pad // max(n_pad // block, 1)
    pblock = block if params.packed_bins else 0
    K = max(1, min(int(params.split_batch), L - 1))
    f32, i32 = torch.float32, torch.int32
    split_kw = dict(l1=params.l1, l2=params.l2,
                    max_delta_step=params.max_delta_step,
                    min_data_in_leaf=params.min_data_in_leaf,
                    min_sum_hessian=params.min_sum_hessian,
                    min_gain_to_split=params.min_gain_to_split)
    out_kw = dict(l1=params.l1, l2=params.l2,
                  max_delta_step=params.max_delta_step)

    # per-node feature masks reshape the split search, so the megakernel's
    # in-launch scan (one mask for every child) is left, as the JAX
    # grower leaves it (grower.py:557-562): "fused" then rides B1
    bynode = params.feature_fraction_bynode < 1.0
    if bynode and key is None:
        raise ValueError("feature_fraction_bynode needs the tree's key")
    fused_scan = params.hist_impl == "fused" and quantized and not bynode
    qscale = None
    FG = feature_mask.shape[0]
    FW = params.bynode_width or FG
    if FW > FG:
        raise ValueError(f"bynode_width {FW} exceeds the feature axis {FG}")
    frac_node = np.float32(params.feature_fraction_bynode)

    def bynode_masks(k, shape_prefix):
        """Per-node feature masks (grower.py:616-623): Bernoulli(fraction)
        over the tree's mask from `jax.random.uniform` of the feature
        axis the JAX learner pads to (`bynode_width`), the tree's mask
        where a draw is empty.  The draw is
        made on the host from the key and queued to the device; the rest
        stays there."""
        draw = np.zeros(shape_prefix + (FG,), np.float32)
        draw[..., :FW] = uniform(k, shape_prefix + (FW,)) < frac_node
        samp = upload(draw, dev) * (feature_mask > 0)
        nonempty = samp.sum(dim=-1, keepdim=True) > 0
        return torch.where(nonempty, samp, feature_mask)

    def best_of(pf, sg, sh, min_c, max_c):
        """Each child's best feature (the lowest index among equal gains)
        and its finalized split."""
        bf = torch.argmax(pf.gain, dim=-1).to(i32)
        return finalize_split(pf, bf, sg, sh, min_constraint=min_c,
                              max_constraint=max_c, **out_kw)

    def select(hist, sg, sh, cnt, min_c, max_c, fmask):
        """Best split of each leaf of the batch: hist [C, F, B, 3] (int32
        sums under the quantized precisions, rescaled after the bin
        prefix sums); fmask [F], or [C, F] (one mask a leaf)."""
        pf = per_feature_best_split(
            hist, sg, sh, cnt, meta["num_bin"], meta["missing_type"],
            meta["default_bin"], meta["monotone"], meta["penalty"],
            fmask, min_constraint=min_c, max_constraint=max_c,
            acc_scale=qscale, **split_kw)
        return best_of(pf, sg, sh, min_c, max_c)

    # ---- root ------------------------------------------------------------
    g = grad * row_mask
    h = hess * row_mask
    if quantized:
        # per-tree discretization (grower.py:937-984 of the JAX package):
        # max-abs scales capped by quant_limit so no int32 bin overflows,
        # stochastic rounding from the tree key folded with 0x5154, and
        # the leaf totals from the same integers the histograms add
        qmax = quant_limit(params.precision, n_pad)
        # XLA rewrites the JAX grower's division by the constant qmax
        # into a product with its f32 reciprocal; so does this
        inv_q = torch.tensor(np.float32(1.0) / np.float32(qmax), device=dev)
        floor = torch.tensor(1e-30, dtype=f32, device=dev)
        g_scale = torch.maximum(g.abs().max(), floor) * inv_q
        h_scale = torch.maximum(h.abs().max(), floor) * inv_q
        seed_a, seed_b = key_words(fold_in(key, 0x5154))
        g_q = quantize_values(g, g_scale, qmax, params.quant_round, seed_a,
                              seed_b, 0, salt=0x9E3779B9)
        h_q = quantize_values(h, h_scale, qmax, params.quant_round, seed_a,
                              seed_b, 0, salt=0x85EBCA6B)
        qscale = torch.stack([g_scale, h_scale,
                              torch.ones((), dtype=f32, device=dev)])
        sum_g = g_q.sum(dtype=i32).to(f32) * g_scale
        sum_h = h_q.sum(dtype=i32).to(f32) * h_scale
        cnt = row_mask.to(i32).sum(dtype=i32).to(f32)
        stats = pack_stats(g_q, h_q, row_mask, params.precision).contiguous()
    else:
        sum_g = g.sum(dtype=f32)
        sum_h = h.sum(dtype=f32)
        cnt = row_mask.sum(dtype=f32)
        stats = pack_stats(g, h, row_mask, params.precision).contiguous()
    leaf_ids = torch.zeros(n_pad, dtype=i32, device=dev)
    root_slots = torch.full((K,), -1, dtype=i32, device=dev)
    root_slots[0] = 0
    root_hist = build_histogram_batched_t(
        bins_t, stats, leaf_ids, root_slots, B, params.precision,
        params.hist_impl, pblock)[0]
    big = torch.tensor(1e30, dtype=f32, device=dev)
    root_fmask = feature_mask
    node_key = key
    if bynode:
        # the rounding seed above folds the tree key without advancing it;
        # the node draws split it (grower.py:1084-1086)
        node_key, k_root = split(node_key)
        root_fmask = bynode_masks(k_root, ())
    root = select(root_hist[None], sum_g[None], sum_h[None], cnt[None],
                  -big, big, root_fmask)
    if fused_scan:
        # the megakernel's per-feature tables (the JAX package's fused.py
        # layout); no per-node masks in this slice, so the feature mask
        # is baked in
        zi = torch.zeros(F, dtype=i32, device=dev)
        fmeta_i = torch.stack(
            [meta["num_bin"], meta["missing_type"], meta["default_bin"],
             meta["monotone"], zi, zi, zi, zi], dim=1).to(i32).contiguous()
        zf = torch.zeros(F, dtype=f32, device=dev)
        fmeta_f = torch.stack(
            [meta["penalty"].to(f32), feature_mask.to(f32), zf, zf, zf, zf,
             zf, zf], dim=1).contiguous()

    def vec(fill, dtype=f32, first=None):
        v = torch.full((L + 1,), fill, dtype=dtype, device=dev)
        if first is not None:
            v[0] = first
        return v

    st = {
        # int32 under the quantized precisions: subtraction stays exact
        "pool": torch.zeros((L + 1, F, B, 3), dtype=root_hist.dtype,
                            device=dev),
        "leaf_sum_g": vec(0.0, first=sum_g),
        "leaf_sum_h": vec(0.0, first=sum_h),
        "leaf_cnt": vec(0.0, first=cnt),
        "leaf_depth": vec(0, i32),
        "leaf_output": vec(0.0, first=leaf_output(sum_g, sum_h, **out_kw)),
        "bs_gain": vec(K_MIN_SCORE, first=root.gain[0]),
        "bs_feat": vec(0, i32, first=root.feature[0]),
        "bs_thr": vec(0, i32, first=root.threshold[0]),
        "bs_dleft": vec(False, torch.bool, first=root.default_left[0]),
        "bs_lg": vec(0.0, first=root.left_sum_g[0]),
        "bs_lh": vec(0.0, first=root.left_sum_h[0]),
        "bs_lc": vec(0.0, first=root.left_count[0]),
        "bs_lo": vec(0.0, first=root.left_output[0]),
        "bs_ro": vec(0.0, first=root.right_output[0]),
    }
    st["pool"][0] = root_hist
    # K slack rows so the last round's full-width write stays in bounds
    records = torch.zeros((L - 1 + K, REC_WIDTH), dtype=f32, device=dev)
    n_splits = torch.zeros((), dtype=i32, device=dev)

    def cand_gains():
        gains = st["bs_gain"][:L]
        if params.max_depth <= 0:
            return gains
        return torch.where(st["leaf_depth"][:L] < params.max_depth, gains,
                           K_MIN_SCORE)

    def partition(sel, new_ids, do_k, sel_feat, sel_thr, sel_dleft):
        mt = meta["missing_type"][sel_feat]
        nbf = meta["num_bin"][sel_feat]
        db = meta["default_bin"][sel_feat]
        if params.partition_impl == "kernel":
            return partition_rows(bins_t, sel_feat, leaf_ids, sel, new_ids,
                                  sel_thr, sel_dleft, mt, nbf, db, do_k)
        if params.partition_impl == "vselect":
            return partition_rows_plain(bins_t, sel_feat, leaf_ids, sel,
                                        new_ids, sel_thr, sel_dleft, mt,
                                        nbf, db, do_k, pblock)
        # "select": one scalar-broadcast pass per slot
        new_leaf = leaf_ids
        for k in range(sel.shape[0]):
            col = bins_t[sel_feat[k].long()]
            if pblock:
                col = unpack2d(col, pblock)
            col = col.to(i32)
            go_left = numeric_go_left(col, mt[k], nbf[k], db[k],
                                      sel_thr[k], sel_dleft[k])
            move = (leaf_ids == sel[k]) & do_k[k] & ~go_left
            new_leaf = torch.where(move, new_ids[k], new_leaf)
        return new_leaf

    def exec_round(Kr: int) -> None:
        nonlocal leaf_ids, n_splits, node_key
        vals, sel = _top_k(cand_gains(), Kr)
        kar = torch.arange(Kr, dtype=i32, device=dev)
        budget = (L - 1) - n_splits
        # vals descend, so do_k is a prefix: this round's records are
        # contiguous
        do_k = (vals > 0.0) & (kar < budget)
        if params.split_batch_alpha > 0.0 and K > 1:
            alpha = min(params.split_batch_alpha, 0.999)
            do_k &= vals >= alpha * vals[0]
        sl = sel.long()
        sel_feat, sel_thr = st["bs_feat"][sl], st["bs_thr"][sl]
        sel_dleft = st["bs_dleft"][sl]
        lg, lh, lc = st["bs_lg"][sl], st["bs_lh"][sl], st["bs_lc"][sl]
        lo, ro = st["bs_lo"][sl], st["bs_ro"][sl]
        num_do = do_k.sum(dtype=i32)
        new_ids = n_splits + 1 + kar
        pg, ph, pc = (st["leaf_sum_g"][sl], st["leaf_sum_h"][sl],
                      st["leaf_cnt"][sl])
        rg, rh, rc = pg - lg, ph - lh, pc - lc

        leaf_ids = partition(sel, new_ids, do_k, sel_feat, sel_thr,
                             sel_dleft)

        # all K smaller children in one pass, siblings by subtraction
        smaller_is_left = lc <= rc
        smaller_ids = torch.where(
            do_k, torch.where(smaller_is_left, sel, new_ids), -1).to(i32)
        parent_hist = st["pool"][sl]                      # [Kr, F, B, 3]
        if fused_scan:
            # histograms + subtraction + split scan of all 2K children in
            # one call (grower.py:1410-1436); dead slots carry garbage
            # records that land in the trash slot
            C = 2 * Kr
            ctx = torch.zeros((C + 1, CTX_WIDTH), dtype=f32, device=dev)
            ctx[:C, CTX_SUM_G] = torch.cat([lg, rg])
            ctx[:C, CTX_SUM_H] = torch.cat([lh, rh])
            ctx[:C, CTX_COUNT] = torch.cat([lc, rc])
            ctx[:C, CTX_MIN_C] = -big
            ctx[:C, CTX_MAX_C] = big
            ctx[:C, CTX_USE_SMALL] = torch.cat(
                [smaller_is_left, ~smaller_is_left]).to(f32)
            ctx[C, :3] = qscale
            hist_small, srecs = fused_hist_scan(
                bins_t, stats, leaf_ids, smaller_ids, parent_hist, ctx,
                fmeta_i, fmeta_f, B, params.precision, split_kw=split_kw)
        else:
            hist_small = build_histogram_batched_t(
                bins_t, stats, leaf_ids, smaller_ids, B, params.precision,
                params.hist_impl, pblock)
        hist_large = parent_hist - hist_small
        sil = smaller_is_left[:, None, None, None]
        hist_left = torch.where(sil, hist_small, hist_large)
        hist_right = torch.where(sil, hist_large, hist_small)
        # live slots write their leaves, dead ones the trash slot L
        at_sel = torch.where(do_k, sel, L).long()
        at_new = torch.where(do_k, new_ids, L).long()

        def put(key, left, right):
            st[key].index_copy_(0, at_sel, left.to(st[key].dtype))
            st[key].index_copy_(0, at_new, right.to(st[key].dtype))

        put("pool", hist_left, hist_right)

        # best splits of all 2K children (no monotone bounds in this slice)
        child_masks = feature_mask
        if bynode:
            # one mask a child, from the round's split of the key
            # (grower.py:1476-1479)
            node_key, k_nodes = split(node_key)
            child_masks = bynode_masks(k_nodes, (2 * Kr,))
        if fused_scan:
            # the megakernel's records: argmax over the per-feature gains,
            # then finalize_split (grower.py:1532-1551)
            ch = best_of(unpack_pf_records(srecs), torch.cat([lg, rg]),
                         torch.cat([lh, rh]), -big, big)
        else:
            ch = select(torch.cat([hist_left, hist_right]),
                        torch.cat([lg, rg]), torch.cat([lh, rh]),
                        torch.cat([lc, rc]), -big, big, child_masks)

        # the record block reads the parent's output before it changes
        rec = torch.stack([
            sel.to(f32), sel_feat.to(f32), sel_thr.to(f32),
            sel_dleft.to(f32), vals, lo, ro, lc, rc, lh, rh,
            st["leaf_output"][sl], ph, pc, do_k.to(f32),
            torch.zeros(Kr, dtype=f32, device=dev)], dim=1)   # [Kr, 16]
        for key, li, ri in (("leaf_sum_g", lg, rg), ("leaf_sum_h", lh, rh),
                            ("leaf_cnt", lc, rc), ("leaf_output", lo, ro)):
            put(key, li, ri)
        d_child = st["leaf_depth"][sl] + 1
        put("leaf_depth", d_child, d_child)
        for key, cv in (("bs_gain", ch.gain), ("bs_feat", ch.feature),
                        ("bs_thr", ch.threshold),
                        ("bs_dleft", ch.default_left),
                        ("bs_lg", ch.left_sum_g), ("bs_lh", ch.left_sum_h),
                        ("bs_lc", ch.left_count), ("bs_lo", ch.left_output),
                        ("bs_ro", ch.right_output)):
            put(key, cv[:Kr], cv[Kr:])
        records.index_copy_(0, (n_splits + kar).long(), rec)
        n_splits = n_splits + num_do

    if params.ramp and not bynode and K > 1:
        # after r rounds the frontier holds at most 2^r leaves, so a
        # pre-round of width K' >= 2^r splits exactly the leaves the
        # full-K round would: the tree is the same, the dead-slot work
        # of the first rounds goes.  Not under bynode: its draws take
        # the round's width, which would change the masks
        kr = 1
        while kr < K:
            exec_round(kr)
            kr *= int(params.ramp_step)
    syncs = 0
    while True:
        go = (n_splits < L - 1) & (cand_gains().max() > 0.0)
        syncs += 1
        if not bool(go):      # the one host wait of the round
            break
        exec_round(K)
    if quantized and params.quant_refit:
        # leaf refit (grower.py:1733-1755): the structure came from the
        # integer histograms, the outputs come from the f32 sums
        # per-leaf sums in row order, as XLA:CPU's scatter adds them (a
        # fixed-order kernel on the card: ops/leafsum.py)
        rg, rh = leaf_sums(leaf_ids, torch.stack([g, h]), L + 1)
        refit = torch.minimum(torch.maximum(
            leaf_output(rg, rh + 2e-15, **out_kw), -big), big)
        st["leaf_output"] = torch.where(st["leaf_cnt"] > 0, refit,
                                        st["leaf_output"])
    return {"records": records[:L - 1], "leaf_ids": leaf_ids,
            "leaf_output": st["leaf_output"][:L],
            "leaf_cnt": st["leaf_cnt"][:L],
            "leaf_sum_h": st["leaf_sum_h"][:L], "syncs": syncs}
