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
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .fused import partition_rows, partition_rows_plain
from .histogram import build_histogram_batched_t, pack_stats
from .split import (K_MIN_SCORE, finalize_split, leaf_output,
                    numeric_go_left, per_feature_best_split)

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
         feature_mask: torch.Tensor, meta: Dict[str, torch.Tensor]
         ) -> Dict[str, torch.Tensor]:
    """Grow one tree.

    bins_t: [F, n_pad] uint8 (padding rows and features hold bin 0);
    grad/hess/row_mask: [n_pad] f32 (padding rows zero); feature_mask:
    [F] f32; meta: per-feature int32 num_bin/missing_type/default_bin/
    monotone and f32 penalty.

    Returns records [L-1, 16], leaf_ids [n_pad], leaf_output [L],
    leaf_cnt [L], leaf_sum_h [L] (device tensors) and syncs (int)."""
    if params.partition_impl not in PARTITION_IMPLS:
        raise NotImplementedError(
            f"tpu_partition_impl={params.partition_impl!r} is not ported "
            f"to lightgbm_tpu_torch yet (ported: {PARTITION_IMPLS})")
    if params.ramp_step < 2:
        raise ValueError(f"ramp_step={params.ramp_step}; the frontier "
                         "bound needs a growth factor >= 2")
    dev = bins_t.device
    L = params.num_leaves
    B = params.num_bins
    F = bins_t.shape[0]
    n_pad = grad.shape[0]
    K = max(1, min(int(params.split_batch), L - 1))
    f32, i32 = torch.float32, torch.int32
    split_kw = dict(l1=params.l1, l2=params.l2,
                    max_delta_step=params.max_delta_step,
                    min_data_in_leaf=params.min_data_in_leaf,
                    min_sum_hessian=params.min_sum_hessian,
                    min_gain_to_split=params.min_gain_to_split)
    out_kw = dict(l1=params.l1, l2=params.l2,
                  max_delta_step=params.max_delta_step)

    def select(hist, sg, sh, cnt, min_c, max_c):
        """Best split of each leaf of the batch: hist [C, F, B, 3]."""
        pf = per_feature_best_split(
            hist, sg, sh, cnt, meta["num_bin"], meta["missing_type"],
            meta["default_bin"], meta["monotone"], meta["penalty"],
            feature_mask, min_constraint=min_c, max_constraint=max_c,
            **split_kw)
        bf = torch.argmax(pf.gain, dim=-1).to(i32)
        return finalize_split(pf, bf, sg, sh, min_constraint=min_c,
                              max_constraint=max_c, **out_kw)

    # ---- root ------------------------------------------------------------
    g = grad * row_mask
    h = hess * row_mask
    sum_g = g.sum(dtype=f32)
    sum_h = h.sum(dtype=f32)
    cnt = row_mask.sum(dtype=f32)
    stats = pack_stats(g, h, row_mask, params.precision).contiguous()
    leaf_ids = torch.zeros(n_pad, dtype=i32, device=dev)
    root_slots = torch.full((K,), -1, dtype=i32, device=dev)
    root_slots[0] = 0
    root_hist = build_histogram_batched_t(bins_t, stats, leaf_ids,
                                          root_slots, B, params.precision)[0]
    big = torch.tensor(1e30, dtype=f32, device=dev)
    root = select(root_hist[None], sum_g[None], sum_h[None], cnt[None],
                  -big, big)

    def vec(fill, dtype=f32, first=None):
        v = torch.full((L + 1,), fill, dtype=dtype, device=dev)
        if first is not None:
            v[0] = first
        return v

    st = {
        "pool": torch.zeros((L + 1, F, B, 3), dtype=f32, device=dev),
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
                                        nbf, db, do_k)
        # "select": one scalar-broadcast pass per slot
        new_leaf = leaf_ids
        for k in range(sel.shape[0]):
            col = bins_t[sel_feat[k].long()].to(i32)
            go_left = numeric_go_left(col, mt[k], nbf[k], db[k],
                                      sel_thr[k], sel_dleft[k])
            move = (leaf_ids == sel[k]) & do_k[k] & ~go_left
            new_leaf = torch.where(move, new_ids[k], new_leaf)
        return new_leaf

    def exec_round(Kr: int) -> None:
        nonlocal leaf_ids, n_splits
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
        hist_small = build_histogram_batched_t(
            bins_t, stats, leaf_ids, smaller_ids, B, params.precision)
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
        ch = select(torch.cat([hist_left, hist_right]),
                    torch.cat([lg, rg]), torch.cat([lh, rh]),
                    torch.cat([lc, rc]), -big, big)

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

    if params.ramp and K > 1:
        # after r rounds the frontier holds at most 2^r leaves, so a
        # pre-round of width K' >= 2^r splits exactly the leaves the
        # full-K round would: the tree is the same, the dead-slot work
        # of the first rounds goes
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
    return {"records": records[:L - 1], "leaf_ids": leaf_ids,
            "leaf_output": st["leaf_output"][:L],
            "leaf_cnt": st["leaf_cnt"][:L],
            "leaf_sum_h": st["leaf_sum_h"][:L], "syncs": syncs}
