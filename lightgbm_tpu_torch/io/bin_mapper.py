"""Per-feature value -> bin quantization.

A copy of `lightgbm_tpu/io/bin_mapper.py` (pure numpy): the port bins
with the same mappers, so both packages see the same bin matrix.

Behavioral re-implementation of the reference BinMapper
(reference src/io/bin.cpp:78-470, include/LightGBM/bin.h:65-230):

* numerical features: greedy equal-count bin boundary search
  (`GreedyFindBin`, bin.cpp:78) with the zero-as-one-bin variant
  (`FindBinWithZeroAsOneBin`, bin.cpp:256) that dedicates one bin to
  [-1e-35, 1e-35] and splits the budget between negative / positive values;
* categorical features: categories sorted by count, mapped to bins until 99%
  coverage, rare categories -> the NaN bin (bin.cpp:410-460);
* missing handling: None / Zero / NaN (bin.h:26-30) — with MissingType.NaN the
  last bin is reserved for NaN values;
* forced bin bounds (`forcedbins_filename`, bin.cpp:157-255).

Bin semantics: numerical bin `i` holds values v with
`bin_upper_bound[i-1] < v <= bin_upper_bound[i]`; the last real upper bound is
+inf.  `value_to_bin` therefore is a searchsorted over the upper bounds
(reference `BinMapper::ValueToBin`, bin.h:472-508).
"""

from __future__ import annotations

import enum
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

K_ZERO_THRESHOLD = 1e-35  # reference include/LightGBM/meta.h:53
_F32_INF = float("inf")
_NO_IDX = 1 << 60  # "no candidate" sentinel for the vectorized greedy


class MissingType(enum.IntEnum):
    NONE = 0
    ZERO = 1
    NAN = 2


class BinType(enum.IntEnum):
    NUMERICAL = 0
    CATEGORICAL = 1


def sort_keys(values: np.ndarray) -> np.ndarray:
    """f64 -> monotone int64 keys; NaN -> INT64_MAX sentinel.

    key(x) = bits(x) for bits >= 0 else INT64_MIN - bits(x): a total
    order identical to the f64 '<' order, with -0.0 and +0.0 keying
    equal (both 0).  Shared by the host fast binning path below and the
    ops/binning.py device kernel (integer compares are exact on every
    backend, unlike f32-demoted float compares).
    """
    v = np.ascontiguousarray(values, dtype=np.float64)
    bits = v.view(np.int64)
    keys = np.where(bits >= 0, bits,
                    np.int64(np.iinfo(np.int64).min) - bits)
    return np.where(np.isnan(v), np.int64(np.iinfo(np.int64).max), keys)


def _upper_bound(a: float) -> float:
    """Smallest double strictly greater than a (reference Common::GetDoubleUpperBound)."""
    return float(np.nextafter(a, np.inf))


def _equal_ordered(a: float, b: float) -> bool:
    """b <= nextafter(a, inf) (reference Common::CheckDoubleEqualOrdered)."""
    return b <= np.nextafter(a, np.inf)


def greedy_find_bin_scalar(distinct_values: Sequence[float],
                           counts: Sequence[int], max_bin: int,
                           total_cnt: int,
                           min_data_in_bin: int) -> List[float]:
    """Greedy equal-count boundary search (reference src/io/bin.cpp:78-155).

    Returns bin upper bounds; the last is +inf.

    This is the straight per-value transcription of the reference loop —
    O(num_distinct) Python iterations.  It is kept as the parity oracle
    for the vectorized `greedy_find_bin` below, which must produce
    bit-identical boundaries (tests/test_ingest.py).
    """
    assert max_bin > 0
    num_distinct = len(distinct_values)
    bounds: List[float] = []
    if num_distinct <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            cur_cnt_inbin += counts[i]
            if cur_cnt_inbin >= min_data_in_bin:
                val = _upper_bound((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bounds or not _equal_ordered(bounds[-1], val):
                    bounds.append(val)
                    cur_cnt_inbin = 0
        bounds.append(_F32_INF)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin

    # values with count >= mean size get their own bin
    rest_bin_cnt = max_bin
    rest_sample_cnt = total_cnt
    is_big = [False] * num_distinct
    for i in range(num_distinct):
        if counts[i] >= mean_bin_size:
            is_big[i] = True
            rest_bin_cnt -= 1
            rest_sample_cnt -= counts[i]
    # C++ float semantics: x/0 is inf (every distinct value "big" leaves
    # rest_bin_cnt == 0, reference bin.cpp:116 tolerates it); Python's /
    # would raise instead
    with np.errstate(divide="ignore", invalid="ignore"):
        mean_bin_size = float(np.float64(rest_sample_cnt)
                              / np.float64(rest_bin_cnt))

    uppers = [_F32_INF] * max_bin
    lowers = [_F32_INF] * max_bin
    bin_cnt = 0
    lowers[0] = distinct_values[0]
    cur_cnt_inbin = 0
    # 0.5f: the reference multiplies by a float literal (bin.cpp:131)
    half = np.float32(0.5)
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= counts[i]
        cur_cnt_inbin += counts[i]
        if (is_big[i] or cur_cnt_inbin >= mean_bin_size or
                (is_big[i + 1] and cur_cnt_inbin >= max(1.0, mean_bin_size * half))):
            uppers[bin_cnt] = distinct_values[i]
            bin_cnt += 1
            lowers[bin_cnt] = distinct_values[i + 1]
            if bin_cnt >= max_bin - 1:
                break
            cur_cnt_inbin = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                with np.errstate(divide="ignore", invalid="ignore"):
                    mean_bin_size = float(np.float64(rest_sample_cnt)
                                          / np.float64(rest_bin_cnt))
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _upper_bound((uppers[i] + lowers[i + 1]) / 2.0)
        if not bounds or not _equal_ordered(bounds[-1], val):
            bounds.append(val)
    bounds.append(_F32_INF)
    return bounds


def _ceil_int(x) -> int:
    """Smallest integer >= x, exact for any finite float.

    For integer d and float threshold t, `d >= t` (the scalar loop's
    closure test, exact because ints below 2**53 convert to f64
    losslessly) is equivalent to `d >= ceil(t)` — which turns the
    running-count comparison into an integer searchsorted key."""
    return math.ceil(float(x))


def greedy_find_bin(distinct_values: Sequence[float], counts: Sequence[int],
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Vectorized greedy equal-count boundary search.

    Bit-identical to `greedy_find_bin_scalar` (the reference
    bin.cpp:78-155 transcription) but O(max_bin * log n) instead of
    O(num_distinct) Python iterations: the closure condition
    `cur_cnt_inbin >= threshold` is a searchsorted over the exact
    integer cumulative counts (thresholds via `_ceil_int`), and the
    is_big interrupts come from precomputed sorted index arrays.  The
    running `mean_bin_size` re-division only happens when a bin closes,
    so the state machine advances one CLOSURE per step, not one value.
    """
    assert max_bin > 0
    dv = np.asarray(distinct_values, dtype=np.float64)
    cnt = np.asarray(counts, dtype=np.int64)
    num_distinct = len(dv)
    bounds: List[float] = []
    cum = np.cumsum(cnt) if num_distinct else np.zeros(0, np.int64)

    if num_distinct <= max_bin:
        # closure at the first i with cum-from-start >= min_data_in_bin;
        # a deduped (rejected) boundary keeps accumulating, so the next
        # candidate is simply i+1 (the condition stays satisfied)
        base = 0
        pos = 0
        last = num_distinct - 1  # i ranges over [0, num_distinct-2]
        while pos < last:
            j = int(np.searchsorted(cum[:last], base + min_data_in_bin,
                                    side="left"))
            j = max(j, pos)
            if j >= last:
                break
            val = _upper_bound((dv[j] + dv[j + 1]) / 2.0)
            if not bounds or not _equal_ordered(bounds[-1], val):
                bounds.append(val)
                base = int(cum[j])
            pos = j + 1
        bounds.append(_F32_INF)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin

    is_big = cnt >= mean_bin_size  # exact: int64 -> f64 lossless here
    rest_bin_cnt = int(max_bin - is_big.sum())
    rest_sample0 = int(total_cnt - cnt[is_big].sum())
    with np.errstate(divide="ignore", invalid="ignore"):
        mean_bin_size = float(np.float64(rest_sample0)
                              / np.float64(rest_bin_cnt))

    big_idx = np.flatnonzero(is_big)
    # positions i (<= nd-2) whose SUCCESSOR is big — the half-mean early
    # closure sites; their cum values stay sorted for searchsorted
    b3_idx = np.flatnonzero(is_big[1:])
    b3_cum = cum[b3_idx]
    nb_cum = np.cumsum(np.where(is_big, 0, cnt))

    uppers = np.full(max_bin + 1, _F32_INF)
    lowers = np.full(max_bin + 1, _F32_INF)
    bin_cnt = 0
    lowers[0] = dv[0]
    half = np.float32(0.5)
    start = 0
    last = num_distinct - 1  # loop domain is [0, num_distinct-2]
    while start < last:
        base = int(cum[start - 1]) if start > 0 else 0
        # c1: next value that is itself big
        p = int(np.searchsorted(big_idx, start))
        c1 = int(big_idx[p]) if p < len(big_idx) else _NO_IDX
        if c1 >= last:
            c1 = _NO_IDX
        # c2: running count reaches mean_bin_size
        c2 = _NO_IDX
        if math.isfinite(mean_bin_size):
            j = int(np.searchsorted(cum[:last],
                                    base + _ceil_int(mean_bin_size),
                                    side="left"))
            c2 = max(j, start) if j < last else _NO_IDX
        # c3: successor is big and running count reaches half the mean
        c3 = _NO_IDX
        if len(b3_idx):
            q = int(np.searchsorted(b3_idx, start))
            if q < len(b3_idx):
                thr3 = max(1.0, mean_bin_size * half)
                if math.isfinite(thr3):
                    r = q + int(np.searchsorted(b3_cum[q:],
                                                base + _ceil_int(thr3),
                                                side="left"))
                    if r < len(b3_idx):
                        c3 = max(int(b3_idx[r]), start)
        i = min(c1, c2, c3)
        if i >= last:
            break
        uppers[bin_cnt] = dv[i]
        bin_cnt += 1
        lowers[bin_cnt] = dv[i + 1]
        if bin_cnt >= max_bin - 1:
            break
        if not is_big[i]:
            rest_bin_cnt -= 1
            with np.errstate(divide="ignore", invalid="ignore"):
                mean_bin_size = float(
                    np.float64(rest_sample0 - int(nb_cum[i]))
                    / np.float64(rest_bin_cnt))
        start = i + 1
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _upper_bound((uppers[i] + lowers[i + 1]) / 2.0)
        if not bounds or not _equal_ordered(bounds[-1], val):
            bounds.append(val)
    bounds.append(_F32_INF)
    return bounds


def _find_bin_zero_as_one(distinct_values: Sequence[float], counts: Sequence[int],
                          max_bin: int, total_cnt: int,
                          min_data_in_bin: int) -> List[float]:
    """Zero-as-one-bin boundary search (reference src/io/bin.cpp:256-313).

    The left/zero/right partition is a pair of searchsorteds over the
    sorted distinct values instead of a per-value scan."""
    dv = np.asarray(distinct_values, dtype=np.float64)
    cnt = np.asarray(counts, dtype=np.int64)
    num_distinct = len(dv)
    cum = np.concatenate([[0], np.cumsum(cnt)])
    # first index with v > -K / v > K (side='right' == strict >)
    left_cnt = int(np.searchsorted(dv, -K_ZERO_THRESHOLD, side="right"))
    rs = int(np.searchsorted(dv, K_ZERO_THRESHOLD, side="right"))
    left_cnt_data = int(cum[left_cnt])
    cnt_zero = int(cum[rs] - cum[left_cnt])
    right_cnt_data = int(cum[num_distinct] - cum[rs])

    bounds: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        left_max_bin = max(
            1, int(left_cnt_data / max(1, total_cnt - cnt_zero) * (max_bin - 1)))
        bounds = greedy_find_bin(dv[:left_cnt], cnt[:left_cnt],
                                 left_max_bin, left_cnt_data, min_data_in_bin)
        if bounds:
            bounds[-1] = -K_ZERO_THRESHOLD

    right_start = rs if rs < num_distinct else -1

    right_max_bin = max_bin - 1 - len(bounds)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(dv[right_start:],
                                       cnt[right_start:], right_max_bin,
                                       right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(right_bounds)
    else:
        bounds.append(_F32_INF)
    assert len(bounds) <= max_bin
    return bounds


def _find_bin_with_forced(distinct_values: Sequence[float], counts: Sequence[int],
                          max_bin: int, total_cnt: int, min_data_in_bin: int,
                          forced_bounds: Sequence[float]) -> List[float]:
    """Forced-boundary variant (reference src/io/bin.cpp:157-255)."""
    dv = np.asarray(distinct_values, dtype=np.float64)
    cnt = np.asarray(counts, dtype=np.int64)
    num_distinct = len(dv)
    cum = np.concatenate([[0], np.cumsum(cnt)])
    left_cnt = int(np.searchsorted(dv, -K_ZERO_THRESHOLD, side="right"))
    rs = int(np.searchsorted(dv, K_ZERO_THRESHOLD, side="right"))
    right_start = rs if rs < num_distinct else -1

    bounds: List[float] = []
    if max_bin == 2:
        bounds.append(K_ZERO_THRESHOLD if left_cnt == 0 else -K_ZERO_THRESHOLD)
    elif max_bin >= 3:
        if left_cnt > 0:
            bounds.append(-K_ZERO_THRESHOLD)
        if right_start >= 0:
            bounds.append(K_ZERO_THRESHOLD)
    bounds.append(_F32_INF)

    max_to_insert = max_bin - len(bounds)
    num_inserted = 0
    for b in forced_bounds:
        if num_inserted >= max_to_insert:
            break
        if abs(b) > K_ZERO_THRESHOLD:
            bounds.append(float(b))
            num_inserted += 1
    bounds.sort()

    free_bins = max_bin - len(bounds)
    bounds_to_add: List[float] = []
    value_ind = 0
    n_bounds = len(bounds)
    for i in range(n_bounds):
        bin_start = value_ind
        # first distinct value >= bounds[i] ends this segment (the
        # per-value advance walk, as one searchsorted)
        value_ind = int(np.searchsorted(dv, bounds[i], side="left"))
        cnt_in_bin = int(cum[value_ind] - cum[bin_start])
        bins_remaining = max_bin - n_bounds - len(bounds_to_add)
        num_sub_bins = int(round(cnt_in_bin * free_bins / max(1, total_cnt)))
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == n_bounds - 1:
            num_sub_bins = bins_remaining + 1
        new_bounds = greedy_find_bin(dv[bin_start:value_ind],
                                     cnt[bin_start:value_ind],
                                     num_sub_bins, cnt_in_bin, min_data_in_bin)
        bounds_to_add.extend(new_bounds[:-1])  # last is +inf
    bounds.extend(bounds_to_add)
    bounds.sort()
    assert len(bounds) <= max_bin
    return bounds


class BinMapper:
    """Quantizer for one feature (reference include/LightGBM/bin.h:65-230)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.is_trivial: bool = True
        self.bin_type: BinType = BinType.NUMERICAL
        self.missing_type: MissingType = MissingType.NONE
        self.bin_upper_bound: np.ndarray = np.array([_F32_INF])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0      # bin of value 0.0
        self.most_freq_bin: int = 0
        self.sparse_rate: float = 0.0

    # ------------------------------------------------------------------
    def find_bin(self, sample_values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int = 3, min_split_data: int = 0,
                 bin_type: BinType = BinType.NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False,
                 forced_bounds: Optional[Sequence[float]] = None) -> None:
        """Compute bin boundaries from sampled non-zero values.

        `sample_values` excludes (near-)zero values; zeros are implied by
        `total_sample_cnt - len(sample_values)` as in the reference
        (src/io/bin.cpp:325-390).  NaNs may be present and are counted as
        missing.
        """
        values = np.asarray(sample_values, dtype=np.float64)
        na_cnt = int(np.isnan(values).sum())
        values = values[~np.isnan(values)]

        if not use_missing:
            self.missing_type = MissingType.NONE
        elif zero_as_missing:
            self.missing_type = MissingType.ZERO
        else:
            self.missing_type = MissingType.NAN if na_cnt > 0 else MissingType.NONE
        if self.missing_type != MissingType.NAN:
            na_cnt = 0

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - values.size - na_cnt)

        # distinct values with zero spliced in at its sorted position.
        # Vectorized equal-ordered grouping (the scalar loop was the
        # binning hot spot at ~10s/1M rows): consecutive values with
        # next <= nextafter(prev, inf) merge, keeping the LARGER value —
        # i.e. each group's last element — exactly like the sequential
        # merge (reference bin.cpp:332-352 semantics).
        # unstable sort on purpose: values carry no payload and equal
        # doubles are bit-identical, so stability is unobservable —
        # introsort is measurably faster at the 200k-sample scale
        values = np.sort(values)
        distinct_values = np.zeros(0, np.float64)
        counts = np.zeros(0, np.int64)
        if values.size:
            new_group = values[1:] > np.nextafter(values[:-1], np.inf)
            last_idx = np.flatnonzero(np.append(new_group, True))
            dv = values[last_idx]
            cn = np.diff(np.concatenate([[-1], last_idx]))
            # splice zero (its count is implied, never sampled) at its
            # ordered position; sampled values are never exactly 0.0 (the
            # caller filtered |v| <= kZeroThreshold), so the insertion
            # point is unambiguous.  An INTERIOR zero (negatives and
            # positives both present) is inserted even at count 0 — the
            # scalar loop and reference bin.cpp:341-344 do, and the extra
            # zero-count entry changes categorical bin assembly
            if dv.size:
                pos = int(np.searchsorted(dv, 0.0))
                if zero_cnt > 0 or 0 < pos < len(dv):
                    dv = np.insert(dv, pos, 0.0)
                    cn = np.insert(cn, pos, zero_cnt)
            distinct_values = np.asarray(dv, np.float64)
            counts = cn.astype(np.int64)
        else:
            distinct_values = np.asarray([0.0])
            counts = np.asarray([zero_cnt], np.int64)

        self.min_val = float(distinct_values[0]) if len(distinct_values) \
            else 0.0
        self.max_val = float(distinct_values[-1]) if len(distinct_values) \
            else 0.0
        num_distinct = len(distinct_values)
        forced = list(forced_bounds) if forced_bounds else []

        if bin_type == BinType.NUMERICAL:
            self._find_bin_numerical(distinct_values, counts, num_distinct, max_bin,
                                     total_sample_cnt, min_data_in_bin, na_cnt, forced)
        else:
            self._find_bin_categorical(distinct_values, counts, max_bin,
                                       total_sample_cnt, na_cnt, min_data_in_bin)

        # trivial check + most-freq-bin / sparse-rate (reference bin.cpp:500-528)
        self.is_trivial = self.num_bin <= 1
        if min_split_data > 0 and not self.is_trivial:
            if not _splittable(self._cnt_in_bin, total_sample_cnt, min_split_data,
                               self.bin_type):
                self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = self.value_to_bin(0.0)
            total = max(1, total_sample_cnt)
            cnt = self._cnt_in_bin
            self.most_freq_bin = int(np.argmax(cnt))
            self.sparse_rate = float(cnt[self.default_bin]) / total
            max_sparse_rate = float(cnt[self.most_freq_bin]) / total
            # snap to the zero bin unless another bin dominates (>0.7)
            if self.most_freq_bin != self.default_bin and max_sparse_rate > np.float32(0.7):
                self.sparse_rate = max_sparse_rate
            else:
                self.most_freq_bin = self.default_bin
        else:
            self.sparse_rate = 1.0

    def _find_bin_numerical(self, distinct_values, counts, num_distinct, max_bin,
                            total_sample_cnt, min_data_in_bin, na_cnt, forced):
        def run(mb: int, total: int) -> List[float]:
            if forced:
                return _find_bin_with_forced(distinct_values, counts, mb, total,
                                             min_data_in_bin, forced)
            return _find_bin_zero_as_one(distinct_values, counts,
                                         mb, total, min_data_in_bin)

        if self.missing_type == MissingType.ZERO:
            bounds = run(max_bin, total_sample_cnt)
            if len(bounds) == 2:
                self.missing_type = MissingType.NONE
        elif self.missing_type == MissingType.NONE:
            bounds = run(max_bin, total_sample_cnt)
        else:  # NaN: reserve the last bin for NaN
            bounds = run(max_bin - 1, total_sample_cnt - na_cnt)
            bounds.append(float("nan"))
        self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        self.num_bin = len(bounds)

        # the scalar `while v > ub[i_bin]` walk over sorted distincts IS
        # a searchsorted('left'); the last REAL bound is +inf, so the
        # NaN tail (missing==NaN) is never reached
        n_real = self.num_bin - (1 if self.missing_type == MissingType.NAN
                                 else 0)
        dv = np.asarray(distinct_values, dtype=np.float64)
        pos = np.searchsorted(self.bin_upper_bound[:n_real], dv, side="left")
        cnt_in_bin = np.zeros(self.num_bin, np.int64)
        np.add.at(cnt_in_bin, pos, np.asarray(counts, dtype=np.int64))
        cnt_in_bin = cnt_in_bin.tolist()
        if self.missing_type == MissingType.NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        self._cnt_in_bin = cnt_in_bin
        self.default_bin = self.value_to_bin(0.0)

    def _find_bin_categorical(self, distinct_values, counts, max_bin,
                              total_sample_cnt, na_cnt, min_data_in_bin=3):
        """Count-sorted categorical binning (reference bin.cpp:425-497).

        Categories map to bins in descending-count order until 99% coverage;
        rare categories share the LAST bin (via the unseen->num_bin-1 rule in
        value_to_bin); a dedicated -1/NaN bin is added only when every
        category got a bin and NaNs exist.
        """
        # int(v) truncates toward zero; distincts sorted ascending and
        # non-negative truncation is monotone, so np.unique preserves the
        # scalar dict's first-occurrence (ascending-category) order that
        # the stable count sort below depends on
        iv = np.asarray(distinct_values, np.float64).astype(np.int64)
        cn = np.asarray(counts, np.int64)
        neg = iv < 0
        na_cnt += int(cn[neg].sum())
        cats, inv = np.unique(iv[~neg], return_inverse=True)
        ccnt = np.bincount(inv, weights=cn[~neg]).astype(np.int64) \
            if cats.size else np.zeros(0, np.int64)
        self.num_bin = 0
        rest_cnt = total_sample_cnt - na_cnt
        self._cnt_in_bin = []
        if rest_cnt <= 0:
            self.missing_type = MissingType.NONE
            return
        items = sorted(zip(cats.tolist(), ccnt.tolist()),
                       key=lambda kv: -kv[1])
        # avoid first bin being category 0 (reference bin.cpp:453-460)
        if items and items[0][0] == 0:
            if len(items) == 1:
                items.append((items[0][0] + 1, 0))
            items[0], items[1] = items[1], items[0]
        cut_cnt = int(np.float32((total_sample_cnt - na_cnt)) * np.float32(0.99))
        self.categorical_2_bin = {}
        self.bin_2_categorical = []
        used_cnt = 0
        mb = min(len(items), max_bin)
        cnt_in_bin: List[int] = []
        cur_cat = 0
        while cur_cat < len(items) and (used_cnt < cut_cnt or self.num_bin < mb):
            cat, cnt = items[cur_cat]
            if cnt < min_data_in_bin and cur_cat > 1:
                break
            self.bin_2_categorical.append(cat)
            self.categorical_2_bin[cat] = self.num_bin
            used_cnt += cnt
            cnt_in_bin.append(cnt)
            self.num_bin += 1
            cur_cat += 1
        # dedicated NaN bin only when all categories were consumed
        if cur_cat == len(items) and na_cnt > 0:
            self.bin_2_categorical.append(-1)
            self.categorical_2_bin[-1] = self.num_bin
            cnt_in_bin.append(0)
            self.num_bin += 1
        if cur_cat == len(items) and na_cnt == 0:
            self.missing_type = MissingType.NONE
        else:
            self.missing_type = MissingType.NAN
        if cnt_in_bin:
            cnt_in_bin[-1] += total_sample_cnt - used_cnt
        self._cnt_in_bin = cnt_in_bin

    @property
    def cnt_in_bin(self) -> List[int]:
        """Per-bin sample occupancy recorded by `find_bin` (reference
        ``BinMapper::cnt_in_bin``, bin.h:102) — the training reference
        the model-health profile captures.  Serialized by
        `to_dict`/`from_dict` so binary dataset caches and the
        distributed bin-mapper sync keep it; empty only for mappers
        from snapshots written before it existed."""
        return list(getattr(self, "_cnt_in_bin", []))

    # ------------------------------------------------------------------
    def value_to_bin(self, value: float) -> int:
        """Map one raw value to its bin (reference bin.h:472-508)."""
        if math.isnan(value):
            if self.missing_type == MissingType.NAN:
                return self.num_bin - 1
            value = 0.0
        if self.bin_type == BinType.NUMERICAL:
            ub = self.bin_upper_bound
            hi = self.num_bin - 1
            if self.missing_type == MissingType.NAN:
                hi -= 1
            return int(np.searchsorted(ub[:hi], value, side="left"))
        iv = int(value)
        if iv < 0:
            return self.num_bin - 1
        return self.categorical_2_bin.get(iv, self.num_bin - 1)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin for a full column."""
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        if self.bin_type == BinType.NUMERICAL:
            has_nan = bool(nan_mask.any())
            vals = np.where(nan_mask, 0.0, values) if has_nan else values
            hi = self.num_bin - 1
            if self.missing_type == MissingType.NAN:
                hi -= 1
            out = np.searchsorted(self.bin_upper_bound[:hi], vals,
                                  side="left").astype(np.int32)
            if has_nan and self.missing_type == MissingType.NAN:
                out[nan_mask] = self.num_bin - 1
            return out
        # NaN: dedicated bin when missing==NaN, else treated as category 0
        nan_cat = -1 if self.missing_type == MissingType.NAN else 0
        ivals = np.where(nan_mask, nan_cat,
                         np.nan_to_num(values, nan=0.0)).astype(np.int64)
        out = np.full(values.shape, self.num_bin - 1, dtype=np.int32)
        for cat, b in self.categorical_2_bin.items():
            if cat >= 0:
                out[ivals == cat] = b
        out[ivals < 0] = self.num_bin - 1
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative raw value for a bin (used for model thresholds)."""
        if self.bin_type == BinType.NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])

    # -- serialization (for distributed bin-mapper sync & binary cache) ----
    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "is_trivial": self.is_trivial,
            "bin_type": int(self.bin_type),
            "missing_type": int(self.missing_type),
            "bin_upper_bound": [float(x) for x in self.bin_upper_bound],
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
            "sparse_rate": self.sparse_rate,
            # sample occupancy travels with the mapper so the model-
            # health profile survives binary dataset caches and the
            # distributed bin-mapper sync (ISSUE 14); absent in files
            # written before it existed (from_dict defaults to [])
            "cnt_in_bin": [int(x) for x in
                           getattr(self, "_cnt_in_bin", [])],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.is_trivial = bool(d["is_trivial"])
        m.bin_type = BinType(d["bin_type"])
        m.missing_type = MissingType(d["missing_type"])
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = [int(x) for x in d["bin_2_categorical"]]
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        m.most_freq_bin = int(d["most_freq_bin"])
        m.sparse_rate = float(d.get("sparse_rate", 0.0))
        m._cnt_in_bin = [int(x) for x in d.get("cnt_in_bin", [])]
        return m


def _splittable(cnt_in_bin: List[int], total_cnt: int, filter_cnt: int,
                bin_type: BinType) -> bool:
    """Inverse of reference NeedFilter (src/io/bin.cpp:54-76)."""
    if bin_type == BinType.NUMERICAL:
        sum_left = 0
        for c in cnt_in_bin[:-1]:
            sum_left += c
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return True
        return False
    if len(cnt_in_bin) <= 2:
        for c in cnt_in_bin[:-1]:
            if c >= filter_cnt and total_cnt - c >= filter_cnt:
                return True
        return False
    return True
