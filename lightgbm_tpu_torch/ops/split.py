"""Best-split search over histograms as masked cumulative sums + argmax.

The port of `lightgbm_tpu/ops/split.py`: the numerical search, whose two
scan directions that module's docstring derives from the reference
(feature_histogram.hpp:508-644), and the categorical search
(`per_feature_best_split_categorical`, feature_histogram.hpp:118-279).
Every function takes optional leading batch dimensions in front of the
feature axis, where the JAX
grower vmaps over children: the math is elementwise, so a written-out
batch axis computes the same values.

Tie-breaking mirrors the reference scan order: dir=-1 keeps the LARGEST
threshold among equal gains, dir=+1 the smallest, dir=+1 wins only on a
strictly greater gain, and across features the lowest index wins
(`torch.argmax` returns the first maximum, as `jnp.argmax` does).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

K_MIN_SCORE = -1e30
K_EPSILON = 1e-15

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


def numeric_go_left(col, mt, nbf, db, thr, dleft):
    """Numerical split decision incl. missing-value routing (reference
    dense_bin.hpp Split semantics); elementwise over broadcast tensors."""
    is_miss = torch.where(mt == MISSING_NAN, col == nbf - 1,
                          (mt == MISSING_ZERO) & (col == db))
    return torch.where(is_miss, dleft, col <= thr)


def argbest(gain, feature, threshold=None):
    """Winner index over the last axis with the shared deterministic
    tie-break of `lightgbm_tpu/ops/split.py:argbest`: highest gain, then
    lowest feature id, then lowest threshold bin (the first such entry);
    leading axes are a batch ([...] indices)."""
    elig = gain >= gain.amax(-1, keepdim=True)
    big = 2 ** 31 - 1
    f = torch.where(elig, feature.to(torch.int32), big)
    elig = elig & (feature == f.amin(-1, keepdim=True))
    if threshold is not None:
        t = torch.where(elig, threshold.to(torch.int32), big)
        elig = elig & (threshold == t.amin(-1, keepdim=True))
    return torch.argmax(elig.to(torch.int32), dim=-1).to(torch.int32)


_SCAN_BASE = 16


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums over the last axis, in XLA's f32 summation order.

    `jnp.cumsum` lowers to a reduce-window that XLA rewrites into a
    blocked scan: sequential prefixes inside blocks of 16 elements, the
    block totals scanned the same way, and each block's exclusive prefix
    added to its inner prefixes.  Taking the sums in that order makes the
    port's bin prefix sums bit-equal to the JAX package's, so equal
    histograms give equal gains and split ties break alike.
    (`torch.cumsum` accumulates in f64 on the CPU and in a parallel
    order on the card.)"""
    n = x.shape[-1]
    nb = -(-n // _SCAN_BASE)
    pad = nb * _SCAN_BASE - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blk = x.reshape(*x.shape[:-1], nb, _SCAN_BASE)
    parts = [blk[..., 0]]
    for i in range(1, _SCAN_BASE):
        parts.append(parts[-1] + blk[..., i])
    inner = torch.stack(parts, dim=-1)
    if nb > 1:
        pre = cumsum_last(inner[..., -1])
        excl = torch.cat([torch.zeros_like(pre[..., :1]), pre[..., :-1]], -1)
        inner = excl[..., None] + inner
    return inner.reshape(*x.shape[:-1], nb * _SCAN_BASE)[..., :n]


_REDUCE_WINDOW = 32


def reduce_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim`, in XLA:CPU's f32 summation order.

    XLA:CPU sums an axis of up to 32 elements in sequence, from 0.
    A longer axis of n elements it first rewrites into a reduce-window
    of 32: the axis is padded with zeros to the next multiple of 32,
    half the padding (rounded down) in front, each window of 32 is summed
    in sequence, and the ceil(n/32) window sums are then summed by the
    same rule.  Taking the sums in that order makes sums that the JAX
    package takes with `jnp.sum` bit-equal here (`torch.sum` adds in
    another order on each device).  The summed axis is moved to the front
    and made contiguous, so that each step adds whole contiguous slices."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n > _REDUCE_WINDOW:
        nb = -(-n // _REDUCE_WINDOW)
        pad = nb * _REDUCE_WINDOW - n
        x = torch.cat([x.new_zeros((pad // 2,) + x.shape[1:]), x,
                       x.new_zeros((pad - pad // 2,) + x.shape[1:])])
        # [32, nb, ...]: position in the window first
        x = x.reshape(nb, _REDUCE_WINDOW, *x.shape[1:]).transpose(0, 1)
        return reduce_sum(_sum_in_order(x.contiguous()), 0)
    return _sum_in_order(x.contiguous())


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """((0 + x[0]) + x[1]) + ... over the leading axis."""
    acc = x[0] + 0.0
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _threshold_l1(s, l1):
    reg = torch.clamp(s.abs() - l1, min=0.0)
    return torch.sign(s) * reg


def leaf_output(sum_g, sum_h, l1, l2, max_delta_step):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:449-456)."""
    out = -_threshold_l1(sum_g, l1) / (sum_h + l2)
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def leaf_split_gain(sum_g, sum_h, l1, l2, max_delta_step):
    """GetLeafSplitGain (feature_histogram.hpp:497-506)."""
    output = leaf_output(sum_g, sum_h, l1, l2, max_delta_step)
    sg_l1 = _threshold_l1(sum_g, l1)
    return -(2.0 * sg_l1 * output + (sum_h + l2) * output * output)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


class SplitResult(NamedTuple):
    gain: torch.Tensor          # f32; <=0 means no valid split
    feature: torch.Tensor       # i32 index into used features
    threshold: torch.Tensor     # i32 bin threshold
    default_left: torch.Tensor  # bool
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor    # f32
    left_output: torch.Tensor
    right_output: torch.Tensor


class PerFeatureBest(NamedTuple):
    """Per-feature best-split candidates (pre cross-feature argmax)."""
    gain: torch.Tensor        # [..., F] net gain
    threshold: torch.Tensor   # [..., F] i32
    default_left: torch.Tensor  # [..., F] bool
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor


# flat f32 record layout of a PerFeatureBest row (lightgbm_tpu's
# split.pack_pf_records): gain, threshold, default_left, left g/h/count
PF_REC_GAIN, PF_REC_THRESHOLD, PF_REC_DEFAULT_LEFT, PF_REC_LEFT_G, \
    PF_REC_LEFT_H, PF_REC_LEFT_C = range(6)
PF_RECORD_WIDTH = 8  # fields 6-7 spare


def pack_pf_records(pf: PerFeatureBest) -> torch.Tensor:
    """[..., F, PF_RECORD_WIDTH] f32 records from per-feature bests."""
    zero = torch.zeros_like(pf.gain, dtype=torch.float32)
    return torch.stack(
        [pf.gain.float(), pf.threshold.float(), pf.default_left.float(),
         pf.left_sum_g.float(), pf.left_sum_h.float(),
         pf.left_count.float(), zero, zero], dim=-1)


def unpack_pf_records(rec: torch.Tensor) -> PerFeatureBest:
    """Inverse of `pack_pf_records`."""
    return PerFeatureBest(
        gain=rec[..., PF_REC_GAIN],
        threshold=rec[..., PF_REC_THRESHOLD].to(torch.int32),
        default_left=rec[..., PF_REC_DEFAULT_LEFT] > 0.5,
        left_sum_g=rec[..., PF_REC_LEFT_G],
        left_sum_h=rec[..., PF_REC_LEFT_H],
        left_count=rec[..., PF_REC_LEFT_C])


def per_feature_best_split(
        hist, sum_g, sum_h, num_data, num_bin, missing_type, default_bin,
        monotone, penalty, feature_mask, *, l1: float, l2: float,
        max_delta_step: float, min_data_in_leaf: float,
        min_sum_hessian: float, min_gain_to_split: float,
        min_constraint=-1e30, max_constraint=1e30,
        acc_scale=None) -> PerFeatureBest:
    """Best candidate per feature.

    hist: [..., F, B, 3] f32 (g, h, cnt); sum_g/sum_h/num_data and the
    monotone bounds min/max_constraint: [...] (or scalars); the
    per-feature arrays: [F], or [..., F] (each leaf its own features: the
    voting learner's voted sets).

    acc_scale (quantized precisions): hist arrives as int32 sums and the
    bin prefix sums run in int32, which is exact in any order; the [3]
    dequantization scales (g, h, count) apply after them, as in the JAX
    package (split.py:206-210)."""
    F, B = hist.shape[-3], hist.shape[-2]
    dev = hist.device

    def lead(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x[..., None, None]

    sg, sh, nd = lead(sum_g), lead(sum_h), lead(num_data)
    min_c, max_c = lead(min_constraint), lead(max_constraint)
    bin_iota = torch.arange(B, device=dev, dtype=torch.int32)[None, :]
    nb = num_bin[..., None]
    hg, hh, hc = hist[..., 0], hist[..., 1], hist[..., 2]

    is_zero_missing = missing_type[..., None] == MISSING_ZERO
    is_nan_missing = missing_type[..., None] == MISSING_NAN
    skip_bin = is_zero_missing & (bin_iota == default_bin[..., None])
    na_bin = is_nan_missing & (bin_iota == nb - 1)
    acc_mask = (~skip_bin) & (~na_bin) & (bin_iota < nb)

    zero = torch.zeros((), dtype=hist.dtype, device=dev)
    masked = torch.where(acc_mask, torch.stack([hg, hh, hc]), zero)
    if acc_scale is None:
        cg, ch, cc = cumsum_last(masked).unbind(0)
    else:
        # int32 prefix sums are exact; dequantize at the scan boundary
        scale = torch.as_tensor(acc_scale, dtype=torch.float32, device=dev)
        ci = torch.cumsum(masked, dim=-1, dtype=torch.int32)
        cg, ch, cc = (ci[i].to(torch.float32) * scale[i] for i in range(3))

    gain_shift = leaf_split_gain(sg, sh + 2 * K_EPSILON, l1, l2,
                                 max_delta_step)
    min_gain_shift = gain_shift + min_gain_to_split
    mono = monotone[..., None]

    def eval_dir(left_g, left_h, left_c, thr_valid):
        right_g = sg - left_g
        right_h = sh - left_h
        right_c = nd - left_c
        ok = (thr_valid
              & (left_c >= min_data_in_leaf) & (right_c >= min_data_in_leaf)
              & (left_h >= min_sum_hessian) & (right_h >= min_sum_hessian))
        lo = _clip(leaf_output(left_g, left_h, l1, l2, max_delta_step),
                   min_c, max_c)
        ro = _clip(leaf_output(right_g, right_h, l1, l2, max_delta_step),
                   min_c, max_c)
        mono_bad = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
        sg_l1_l = _threshold_l1(left_g, l1)
        sg_l1_r = _threshold_l1(right_g, l1)
        g_l = -(2.0 * sg_l1_l * lo + (left_h + l2) * lo * lo)
        g_r = -(2.0 * sg_l1_r * ro + (right_h + l2) * ro * ro)
        gain = torch.where(mono_bad, 0.0, g_l + g_r)
        return torch.where(ok & (gain > min_gain_shift), gain, K_MIN_SCORE)

    # ---- direction +1: left = prefix, missing goes right ----------------
    thr_ok_p1 = (bin_iota <= nb - 2) & (~skip_bin)
    gain_p1 = eval_dir(cg, ch, cc, thr_ok_p1)

    # ---- direction -1: right = suffix, missing goes left ----------------
    tg, th, tc = cg[..., -1:], ch[..., -1:], cc[..., -1:]
    left_g_m1 = sg - (tg - cg)
    left_h_m1 = sh - (th - ch)
    left_c_m1 = nd - (tc - cc)
    thr_ok_m1 = ((bin_iota <= nb - 2 - is_nan_missing.to(torch.int32))
                 & (~skip_bin))
    gain_m1 = eval_dir(left_g_m1, left_h_m1, left_c_m1, thr_ok_m1)

    # ---- per-feature best with reference tie-breaking -------------------
    idx_m1 = (B - 1) - torch.argmax(gain_m1.flip(-1), dim=-1)
    best_m1 = torch.gather(gain_m1, -1, idx_m1[..., None])[..., 0]
    idx_p1 = torch.argmax(gain_p1, dim=-1)
    best_p1 = torch.gather(gain_p1, -1, idx_p1[..., None])[..., 0]

    use_p1 = best_p1 > best_m1                                   # strict >
    feat_gain = torch.where(use_p1, best_p1, best_m1)
    feat_thr = torch.where(use_p1, idx_p1, idx_m1)
    feat_dleft = ~use_p1
    # only-2-bin NaN features get default_left=False in the reference
    # (feature_histogram.hpp:105-108)
    two_bin_nan = (num_bin <= 2) & (missing_type == MISSING_NAN)
    feat_dleft = feat_dleft & ~two_bin_nan

    feat_gain = torch.where(feature_mask > 0, feat_gain, K_MIN_SCORE)
    out_gain = torch.where(feat_gain > K_MIN_SCORE / 2,
                           (feat_gain - min_gain_shift[..., 0]) * penalty,
                           K_MIN_SCORE)

    def at_thr(a):
        return torch.gather(a, -1, feat_thr[..., None])[..., 0]

    lg = torch.where(feat_dleft, at_thr(left_g_m1), at_thr(cg))
    lh = torch.where(feat_dleft, at_thr(left_h_m1), at_thr(ch))
    lc = torch.where(feat_dleft, at_thr(left_c_m1), at_thr(cc))
    return PerFeatureBest(gain=out_gain, threshold=feat_thr.to(torch.int32),
                          default_left=feat_dleft, left_sum_g=lg,
                          left_sum_h=lh, left_count=lc)


def finalize_split(pf: PerFeatureBest, best_f, sum_g, sum_h, *, l1: float,
                   l2: float, max_delta_step: float,
                   min_constraint=-1e30, max_constraint=1e30) -> SplitResult:
    """SplitResult for the chosen feature index ([...] over the batch)."""
    dev = pf.gain.device

    def pick(a):
        return torch.gather(a, -1, best_f[..., None].long())[..., 0]

    def as_f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    sum_g, sum_h = as_f32(sum_g), as_f32(sum_h)
    min_c, max_c = as_f32(min_constraint), as_f32(max_constraint)
    lg, lh = pick(pf.left_sum_g), pick(pf.left_sum_h)
    lo = _clip(leaf_output(lg, lh, l1, l2, max_delta_step), min_c, max_c)
    ro = _clip(leaf_output(sum_g - lg, sum_h - lh, l1, l2, max_delta_step),
               min_c, max_c)
    # the grower's stored splits are f32: under deterministic=true the
    # candidate math above runs in f64 and is cast down here, in the one
    # place the JAX package casts it (split.py:299-305)
    return SplitResult(
        gain=pick(pf.gain).float(), feature=best_f.to(torch.int32),
        threshold=pick(pf.threshold), default_left=pick(pf.default_left),
        left_sum_g=lg.float(), left_sum_h=lh.float(),
        left_count=pick(pf.left_count).float(),
        left_output=lo.float(), right_output=ro.float())


class PerFeatureCatBest(NamedTuple):
    """Per-feature best categorical split candidates."""
    gain: torch.Tensor          # [..., F] net gain (penalized)
    cat_mask: torch.Tensor      # [..., F, B] f32: 1.0 for bins going left
    left_sum_g: torch.Tensor    # [..., F]
    left_sum_h: torch.Tensor
    left_count: torch.Tensor
    left_output: torch.Tensor   # [..., F], with the mode's l2
    right_output: torch.Tensor


def _gain_given_outputs(gl, hl, gr, hr, l1, l2, mds, min_c, max_c):
    """GetSplitGains (feature_histogram.hpp:432-447): the gain of the two
    leaf outputs after the constraint clip."""
    lo = _clip(leaf_output(gl, hl, l1, l2, mds), min_c, max_c)
    ro = _clip(leaf_output(gr, hr, l1, l2, mds), min_c, max_c)
    g_l = -(2.0 * _threshold_l1(gl, l1) * lo + (hl + l2) * lo * lo)
    g_r = -(2.0 * _threshold_l1(gr, l1) * ro + (hr + l2) * ro * ro)
    return g_l + g_r, lo, ro


def cat_scan_steps(max_cat_threshold: int, num_bins: int) -> int:
    """The steps of the sorted-CTR scan that can change its state: a
    feature's scan is active for at most min(max_cat_threshold,
    (used + 1) // 2) steps, and used <= B."""
    return max(0, min(int(max_cat_threshold), (int(num_bins) + 1) // 2))


def per_feature_best_split_categorical(
        hist, sum_g, sum_h, num_data, num_bin, missing_type, penalty,
        feature_mask, *, l1: float, l2: float, max_delta_step: float,
        min_data_in_leaf: float, min_sum_hessian: float,
        min_gain_to_split: float, cat_l2: float, cat_smooth: float,
        max_cat_threshold: int, max_cat_to_onehot: int,
        min_data_per_group: float, min_constraint=-1e30,
        max_constraint=1e30, scan_steps=None) -> PerFeatureCatBest:
    """Categorical best-split search (FindBestThresholdCategorical,
    reference feature_histogram.hpp:118-279), the port of
    `lightgbm_tpu/ops/split.py:per_feature_best_split_categorical`.

    hist: [..., F, B, 3] f32; sum_g/sum_h/num_data and the bounds: [...];
    num_bin/missing_type/penalty and feature_mask: [F], or [..., F]
    (each leaf its own features: the voting learner's voted sets).

    Two modes a feature, by num_bin <= max_cat_to_onehot: one-hot (each
    category bin against the rest, vectorized over the bins), or the
    sorted-CTR subset scan (bins with count >= cat_smooth sorted by
    sum_g / (sum_h + cat_smooth), a stable sort with invalid bins last,
    then prefix-scanned from both ends with the reference's
    min_data_per_group grouping and early-break rules).  The JAX package
    runs the scan as a `lax.scan` of B steps of f32 scalars a feature;
    here it is one loop of elementwise steps over (children, features,
    both directions), adding one bin a step in f32 as that scan does (no
    cumsum, whose order differs).  Past a feature's limit its state stops
    changing, so the loop runs `cat_scan_steps` steps (`scan_steps`
    overrides it; any larger count gives the same result).

    Returns per-feature candidates whose cat_mask marks the bins (the
    categories) routed left."""
    F, B = hist.shape[-3], hist.shape[-2]
    dev = hist.device
    f32 = torch.float32

    def lead(x):
        x = torch.as_tensor(x, dtype=f32, device=dev)
        return x[..., None, None]

    sg, sh, nd = lead(sum_g), lead(sum_h), lead(num_data)
    min_c, max_c = lead(min_constraint), lead(max_constraint)
    hg, hh, hc = hist[..., 0], hist[..., 1], hist[..., 2]
    bin_iota = torch.arange(B, device=dev, dtype=torch.int32)[None, :]

    # used_bin = num_bin - 1 + (missing_type == None)  (hpp:130-131)
    is_full = missing_type == MISSING_NONE
    used_bin = num_bin - 1 + is_full.to(torch.int32)            # [F]

    gain_shift = leaf_split_gain(sg[..., 0], sh[..., 0], l1, l2,
                                 max_delta_step)                # [..., 1]
    min_gain_shift = gain_shift + min_gain_to_split

    # ---- one-hot mode (hpp:137-169) --------------------------------------
    in_range = bin_iota < used_bin[..., None]                   # [F, B]
    oh_hl = hh + K_EPSILON
    oh_hr = sh - hh - K_EPSILON
    ok = (in_range
          & (hc >= min_data_in_leaf) & (hh >= min_sum_hessian)
          & ((nd - hc) >= min_data_in_leaf)
          & (oh_hr >= min_sum_hessian))
    oh_gain = _gain_given_outputs(sg - hg, oh_hr, hg, oh_hl, l1, l2,
                                  max_delta_step, min_c, max_c)[0]
    oh_gain = torch.where(ok & (oh_gain > min_gain_shift[..., None]),
                          oh_gain, K_MIN_SCORE)
    oh_t = torch.argmax(oh_gain, dim=-1)                        # [..., F]

    def at(a, idx):
        return torch.gather(a, -1, idx[..., None])[..., 0]

    oh_best_gain = at(oh_gain, oh_t)
    oh_mask = (bin_iota == oh_t[..., None]).to(f32)
    oh_lg, oh_lh, oh_lc = at(hg, oh_t), at(hh, oh_t) + K_EPSILON, \
        at(hc, oh_t)

    # ---- sorted-CTR subset mode (hpp:170-243) ----------------------------
    l2c = l2 + cat_l2
    valid = in_range & (hc >= cat_smooth)                       # [..., F, B]
    ctr = hg / (hh + cat_smooth)
    sort_key = torch.where(valid, ctr, float("inf"))
    order = torch.sort(sort_key, dim=-1, stable=True).indices    # [..., F, B]
    used = valid.sum(dim=-1, dtype=torch.int32)                 # [..., F]
    limit = torch.clamp((used + 1) // 2, max=int(max_cat_threshold))
    # the bins in scan order, ascending and descending: step i reads bin
    # order[i] of the first and order[used - 1 - i] of the second
    asc = torch.gather(hist, -2, order[..., None].expand(*order.shape, 3))
    pos_d = torch.clamp(used[..., None] - 1 - bin_iota.to(torch.int64),
                        0, B - 1)
    desc = torch.gather(asc, -2, pos_d[..., None].expand(*pos_d.shape, 3))
    seq = torch.stack([asc, desc], dim=-3)                  # [..., F, 2, B, 3]

    shape = seq.shape[:-2]                                  # [..., F, 2]
    lim = limit[..., None]
    slg = torch.zeros(shape, dtype=f32, device=dev)
    slh = torch.full(shape, K_EPSILON, dtype=f32, device=dev)
    slc = torch.zeros(shape, dtype=f32, device=dev)
    grp = torch.zeros(shape, dtype=f32, device=dev)
    dead = torch.zeros(shape, dtype=torch.bool, device=dev)
    bg = torch.full(shape, K_MIN_SCORE, dtype=f32, device=dev)
    bi = torch.full(shape, -1, dtype=torch.int32, device=dev)
    blg, blh, blc = (torch.zeros(shape, dtype=f32, device=dev)
                     for _ in range(3))
    mgs = min_gain_shift[..., None]
    steps = (cat_scan_steps(max_cat_threshold, B) if scan_steps is None
             else int(scan_steps))
    for i in range(min(steps, B)):
        v = seq[..., i, :]
        active = (lim > i) & ~dead
        slg = slg + torch.where(active, v[..., 0], 0.0)
        slh = slh + torch.where(active, v[..., 1], 0.0)
        slc = slc + torch.where(active, v[..., 2], 0.0)
        grp = grp + torch.where(active, v[..., 2], 0.0)
        cont1 = (slc < min_data_in_leaf) | (slh < min_sum_hessian)
        rc = nd - slc
        srh = sh - slh
        brk = ((rc < min_data_in_leaf) | (rc < min_data_per_group)
               | (srh < min_sum_hessian))
        cont2 = grp < min_data_per_group
        evaluate = active & ~cont1 & ~brk & ~cont2
        gain = _gain_given_outputs(slg, slh, sg - slg, srh, l1, l2c,
                                   max_delta_step, min_c, max_c)[0]
        good = evaluate & (gain > mgs) & (gain > bg)
        grp = torch.where(evaluate, 0.0, grp)
        bg = torch.where(good, gain, bg)
        bi = torch.where(good, i, bi)
        blg = torch.where(good, slg, blg)
        blh = torch.where(good, slh, blh)
        blc = torch.where(good, slc, blc)
        dead = dead | (active & ~cont1 & brk)

    # the ascending scan, the first, keeps ties
    use2 = bg[..., 1] > bg[..., 0]

    def pick(a):
        return torch.where(use2, a[..., 1], a[..., 0])

    so_gain, so_bi = pick(bg), pick(bi)
    so_lg, so_lh, so_lc = pick(blg), pick(blh), pick(blc)
    # bins routed left: sorted positions 0..bi (ascending), or the last
    # bi + 1 valid ones (descending)
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(B, device=dev).expand_as(order))
    b_i = so_bi[..., None].to(inv.dtype)
    asc_mask = inv <= b_i
    desc_mask = (inv >= used[..., None] - 1 - b_i) & (inv < used[..., None])
    so_mask = (torch.where(use2[..., None], desc_mask, asc_mask)
               & (b_i >= 0)).to(f32)

    # ---- merge the modes a feature (hpp:136 use_onehot) ------------------
    use_oh = num_bin <= max_cat_to_onehot                       # [F]
    gain = torch.where(use_oh, oh_best_gain, so_gain)
    mask = torch.where(use_oh[..., None], oh_mask, so_mask)
    lg = torch.where(use_oh, oh_lg, so_lg)
    lh = torch.where(use_oh, oh_lh, so_lh)
    lc = torch.where(use_oh, oh_lc, so_lc)
    l2_out = torch.where(use_oh, torch.tensor(l2, dtype=f32, device=dev),
                         torch.tensor(l2c, dtype=f32, device=dev))

    # leaf outputs with the mode's l2 (hpp:244-258)
    mc, xc = min_c[..., 0], max_c[..., 0]
    lo = _clip(-_threshold_l1(lg, l1) / (lh + l2_out), mc, xc)
    ro = _clip(-_threshold_l1(sg[..., 0] - lg, l1)
               / (sh[..., 0] - lh + l2_out), mc, xc)
    if max_delta_step > 0.0:
        lo = torch.clamp(lo, -max_delta_step, max_delta_step)
        ro = torch.clamp(ro, -max_delta_step, max_delta_step)

    gain = torch.where(feature_mask > 0, gain, K_MIN_SCORE)
    out_gain = torch.where(gain > K_MIN_SCORE / 2,
                           (gain - min_gain_shift) * penalty, K_MIN_SCORE)
    return PerFeatureCatBest(gain=out_gain, cat_mask=mask, left_sum_g=lg,
                             left_sum_h=lh, left_count=lc, left_output=lo,
                             right_output=ro)
