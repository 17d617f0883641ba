"""Best-split search over histograms as masked cumulative sums + argmax.

The port of the numerical part of `lightgbm_tpu/ops/split.py`; the
module docstring there derives the two scan directions from the
reference (feature_histogram.hpp:508-644).  Every function takes optional
leading batch dimensions in front of the feature axis, where the JAX
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
    """Winner index with the shared deterministic tie-break: highest
    gain, then lowest feature id, then lowest threshold bin."""
    elig = gain >= gain.max()
    big = 2 ** 31 - 1
    f = torch.where(elig, feature.to(torch.int32), big)
    elig = elig & (feature == f.min())
    if threshold is not None:
        t = torch.where(elig, threshold.to(torch.int32), big)
        elig = elig & (threshold == t.min())
    return torch.argmax(elig.to(torch.int32)).to(torch.int32)


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
        min_constraint=-1e30, max_constraint=1e30) -> PerFeatureBest:
    """Best candidate per feature.

    hist: [..., F, B, 3] f32 (g, h, cnt); sum_g/sum_h/num_data and the
    monotone bounds min/max_constraint: [...] (or scalars); the
    per-feature arrays: [F]."""
    F, B = hist.shape[-3], hist.shape[-2]
    dev = hist.device

    def lead(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x[..., None, None]

    sg, sh, nd = lead(sum_g), lead(sum_h), lead(num_data)
    min_c, max_c = lead(min_constraint), lead(max_constraint)
    bin_iota = torch.arange(B, device=dev, dtype=torch.int32)[None, :]
    nb = num_bin[:, None]
    hg, hh, hc = hist[..., 0], hist[..., 1], hist[..., 2]

    is_zero_missing = missing_type[:, None] == MISSING_ZERO
    is_nan_missing = missing_type[:, None] == MISSING_NAN
    skip_bin = is_zero_missing & (bin_iota == default_bin[:, None])
    na_bin = is_nan_missing & (bin_iota == nb - 1)
    acc_mask = (~skip_bin) & (~na_bin) & (bin_iota < nb)

    zero = torch.zeros((), dtype=hist.dtype, device=dev)
    cg, ch, cc = cumsum_last(torch.where(
        acc_mask, torch.stack([hg, hh, hc]), zero)).unbind(0)

    gain_shift = leaf_split_gain(sg, sh + 2 * K_EPSILON, l1, l2,
                                 max_delta_step)
    min_gain_shift = gain_shift + min_gain_to_split
    mono = monotone[:, None]

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
    return SplitResult(
        gain=pick(pf.gain), feature=best_f.to(torch.int32),
        threshold=pick(pf.threshold), default_left=pick(pf.default_left),
        left_sum_g=lg, left_sum_h=lh, left_count=pick(pf.left_count),
        left_output=lo, right_output=ro)
