"""Decision tree model: flattened array-of-nodes + serialization.

A copy of `lightgbm_tpu/models/tree.py` (pure numpy): both packages
write and read the same `Tree=` blocks of the model text.

Re-implements the reference `Tree` (reference include/LightGBM/tree.h:25,
src/io/tree.cpp) with numpy arrays:

* node numbering: internal node k is created by the k-th split; leaves are
  referenced as `~leaf_idx` in child arrays (negative),
* `decision_type` bit flags: bit0 categorical, bit1 default-left,
  bits 2-3 missing type (0 none / 1 zero / 2 nan)  (tree.h:19-20,210-229),
* text serialization matches the reference v3 model block (tree.cpp ToString)
  so models interchange with the reference,
* vectorized batch prediction (the analog of AddPredictionToScore,
  tree.h:106-119) via a level-by-level gather loop instead of per-row
  pointer chasing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
K_ZERO_THRESHOLD = 1e-35


def _is_zero(v: float) -> bool:
    return -K_ZERO_THRESHOLD <= v <= K_ZERO_THRESHOLD


def _fmt(v: float) -> str:
    """Format a double like the reference (up to 17 significant digits)."""
    s = repr(float(v))
    if s.endswith(".0"):
        s = s[:-2]
    return s


def _fmt_float(v: float) -> str:
    """Format split gains / shrinkage (float precision in reference)."""
    return f"{v:g}"


class Tree:
    def __init__(self, max_leaves: int):
        self.max_leaves = max_leaves
        n = max(max_leaves, 1)
        ni = max(n - 1, 1)
        self.num_leaves = 1
        self.num_cat = 0
        self.shrinkage = 1.0
        self.split_feature_inner = np.zeros(ni, dtype=np.int32)
        self.split_feature = np.zeros(ni, dtype=np.int32)
        self.split_gain = np.zeros(ni, dtype=np.float32)
        self.threshold_in_bin = np.zeros(ni, dtype=np.int32)
        self.threshold = np.zeros(ni, dtype=np.float64)
        self.decision_type = np.zeros(ni, dtype=np.int8)
        self.left_child = np.zeros(ni, dtype=np.int32)
        self.right_child = np.zeros(ni, dtype=np.int32)
        self.leaf_value = np.zeros(n, dtype=np.float64)
        self.leaf_weight = np.zeros(n, dtype=np.float64)
        self.leaf_count = np.zeros(n, dtype=np.int32)
        self.leaf_parent = np.full(n, -1, dtype=np.int32)
        self.leaf_depth = np.zeros(n, dtype=np.int32)
        self.internal_value = np.zeros(ni, dtype=np.float64)
        self.internal_weight = np.zeros(ni, dtype=np.float64)
        self.internal_count = np.zeros(ni, dtype=np.int32)
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        self.cat_boundaries_inner: List[int] = [0]
        self.cat_threshold_inner: List[int] = []

    # ------------------------------------------------------------------
    def _split_common(self, leaf: int, feature_inner: int, real_feature: int,
                      left_value: float, right_value: float, left_cnt: int,
                      right_cnt: int, left_weight: float, right_weight: float,
                      gain: float) -> int:
        new_node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = feature_inner
        self.split_feature[new_node] = real_feature
        self.split_gain[new_node] = gain
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~self.num_leaves
        self.leaf_parent[leaf] = new_node
        self.leaf_parent[self.num_leaves] = new_node
        self.internal_weight[new_node] = self.leaf_weight[leaf]
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_count[new_node] = left_cnt + right_cnt
        self.leaf_value[leaf] = 0.0 if math.isnan(left_value) else left_value
        self.leaf_weight[leaf] = left_weight
        self.leaf_count[leaf] = left_cnt
        self.leaf_value[self.num_leaves] = 0.0 if math.isnan(right_value) else right_value
        self.leaf_weight[self.num_leaves] = right_weight
        self.leaf_count[self.num_leaves] = right_cnt
        self.leaf_depth[self.num_leaves] = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] += 1
        return new_node

    def split(self, leaf: int, feature_inner: int, real_feature: int,
              threshold_bin: int, threshold_double: float, left_value: float,
              right_value: float, left_cnt: int, right_cnt: int,
              left_weight: float, right_weight: float, gain: float,
              missing_type: int, default_left: bool) -> int:
        """Numerical split; returns the new (right) leaf index."""
        new_node = self._split_common(leaf, feature_inner, real_feature,
                                      left_value, right_value, left_cnt,
                                      right_cnt, left_weight, right_weight, gain)
        dt = 0
        if default_left:
            dt |= K_DEFAULT_LEFT_MASK
        dt |= (int(missing_type) & 3) << 2
        self.decision_type[new_node] = dt
        self.threshold_in_bin[new_node] = threshold_bin
        self.threshold[new_node] = threshold_double
        self.num_leaves += 1
        return self.num_leaves - 1

    def split_categorical(self, leaf: int, feature_inner: int, real_feature: int,
                          threshold_bins: Sequence[int], thresholds: Sequence[int],
                          left_value: float, right_value: float, left_cnt: int,
                          right_cnt: int, left_weight: float, right_weight: float,
                          gain: float, missing_type: int) -> int:
        """Categorical split: `thresholds` are bitset words of raw categories
        going LEFT; `threshold_bins` the same in bin space."""
        new_node = self._split_common(leaf, feature_inner, real_feature,
                                      left_value, right_value, left_cnt,
                                      right_cnt, left_weight, right_weight, gain)
        dt = K_CATEGORICAL_MASK | ((int(missing_type) & 3) << 2)
        self.decision_type[new_node] = dt
        self.threshold_in_bin[new_node] = self.num_cat
        self.threshold[new_node] = self.num_cat
        self.num_cat += 1
        self.cat_boundaries.append(self.cat_boundaries[-1] + len(thresholds))
        self.cat_threshold.extend(int(x) for x in thresholds)
        self.cat_boundaries_inner.append(
            self.cat_boundaries_inner[-1] + len(threshold_bins))
        self.cat_threshold_inner.extend(int(x) for x in threshold_bins)
        self.num_leaves += 1
        return self.num_leaves - 1

    # ------------------------------------------------------------------
    def apply_shrinkage(self, rate: float) -> None:
        lv = self.leaf_value[:self.num_leaves] * rate
        lv[np.abs(lv) <= K_ZERO_THRESHOLD] = 0.0
        self.leaf_value[:self.num_leaves] = lv
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        lv = val + self.leaf_value[:self.num_leaves]
        lv[np.abs(lv) <= K_ZERO_THRESHOLD] = 0.0
        self.leaf_value[:self.num_leaves] = lv
        self.shrinkage = 1.0

    def as_constant_tree(self, val: float) -> None:
        self.num_leaves = 1
        self.shrinkage = 1.0
        self.leaf_value[0] = val

    def set_leaf_value(self, leaf: int, value: float) -> None:
        self.leaf_value[leaf] = 0.0 if _is_zero(value) else value

    def max_depth(self) -> int:
        if self.num_leaves <= 1:
            return 0
        return int(self.leaf_depth[:self.num_leaves].max())

    # ------------------------------------------------------------------
    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Leaf index per row; X is the raw feature matrix [n, num_features]."""
        n = X.shape[0]
        if self.num_leaves == 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)  # >=0: internal node, <0: ~leaf
        for _ in range(self.max_depth()):
            active = node >= 0
            if not active.any():
                break
            nid = node[active]
            feat = self.split_feature[nid]
            fval = X[active, feat]
            dt = self.decision_type[nid]
            is_cat = (dt & K_CATEGORICAL_MASK) != 0
            missing = (dt.astype(np.int32) >> 2) & 3
            default_left = (dt & K_DEFAULT_LEFT_MASK) != 0
            lc = self.left_child[nid]
            rc = self.right_child[nid]

            nan_mask = np.isnan(fval)
            # numerical path
            fv = np.where(nan_mask & (missing != 2), 0.0, fval)
            is_default = ((missing == 1) & (np.abs(fv) <= K_ZERO_THRESHOLD) |
                          (missing == 2) & nan_mask)
            go_left_num = np.where(is_default, default_left,
                                   fv <= self.threshold[nid])
            if is_cat.any():
                go_left = np.where(is_cat,
                                   self._categorical_go_left(fval, nid, missing),
                                   go_left_num)
            else:
                go_left = go_left_num
            node[active] = np.where(go_left, lc, rc).astype(np.int32)
        return (~node).astype(np.int32)

    def _categorical_go_left(self, fval: np.ndarray, nid: np.ndarray,
                             missing: np.ndarray) -> np.ndarray:
        """Vectorized CategoricalDecision (tree.h:307-318)."""
        cat_threshold = np.asarray(self.cat_threshold, dtype=np.uint32)
        cat_boundaries = np.asarray(self.cat_boundaries, dtype=np.int64)
        nan_mask = np.isnan(fval)
        int_fval = np.where(nan_mask, 0, np.nan_to_num(fval, nan=0.0)).astype(np.int64)
        neg = int_fval < 0
        # nid covers ALL active nodes (numerical ones too, masked by the
        # caller); their thresholds are raw doubles — clip before indexing
        cat_idx = np.clip(self.threshold[nid].astype(np.int64), 0,
                          max(len(cat_boundaries) - 2, 0))
        start = cat_boundaries[cat_idx]
        width = cat_boundaries[cat_idx + 1] - start
        word_idx = int_fval // 32
        in_range = word_idx < width
        word = cat_threshold[np.clip(start + word_idx, 0, len(cat_threshold) - 1)] \
            if len(cat_threshold) else np.zeros(len(nid), dtype=np.uint32)
        bit = (word >> (int_fval % 32).astype(np.uint32)) & 1
        go_left = in_range & (bit == 1)
        go_left[neg] = False
        go_left[nan_mask & (missing == 2)] = False
        return go_left

    def predict(self, X: np.ndarray) -> np.ndarray:
        leaves = self.predict_leaf(X)
        return self.leaf_value[leaves]

    # ------------------------------------------------------------------
    def to_string(self) -> str:
        nl = self.num_leaves
        ni = nl - 1
        parts = [
            f"num_leaves={nl}",
            f"num_cat={self.num_cat}",
            "split_feature=" + " ".join(str(int(x)) for x in self.split_feature[:ni]),
            "split_gain=" + " ".join(_fmt_float(x) for x in self.split_gain[:ni]),
            "threshold=" + " ".join(_fmt(x) for x in self.threshold[:ni]),
            "decision_type=" + " ".join(str(int(x)) for x in self.decision_type[:ni]),
            "left_child=" + " ".join(str(int(x)) for x in self.left_child[:ni]),
            "right_child=" + " ".join(str(int(x)) for x in self.right_child[:ni]),
            "leaf_value=" + " ".join(_fmt(x) for x in self.leaf_value[:nl]),
            "leaf_weight=" + " ".join(_fmt(x) for x in self.leaf_weight[:nl]),
            "leaf_count=" + " ".join(str(int(x)) for x in self.leaf_count[:nl]),
            "internal_value=" + " ".join(_fmt_float(x) for x in self.internal_value[:ni]),
            "internal_weight=" + " ".join(_fmt_float(x) for x in self.internal_weight[:ni]),
            "internal_count=" + " ".join(str(int(x)) for x in self.internal_count[:ni]),
        ]
        if self.num_cat > 0:
            parts.append("cat_boundaries=" +
                         " ".join(str(x) for x in self.cat_boundaries))
            parts.append("cat_threshold=" +
                         " ".join(str(x) for x in self.cat_threshold))
        parts.append(f"shrinkage={_fmt_float(self.shrinkage)}")
        return "\n".join(parts) + "\n\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in text.strip().split("\n"):
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        nl = int(kv["num_leaves"])
        t = cls(max(nl, 2))
        t.num_leaves = nl
        t.num_cat = int(kv.get("num_cat", "0"))
        t.shrinkage = float(kv.get("shrinkage", "1"))

        def arr(key, dtype, size):
            if size <= 0 or key not in kv or kv[key] == "":
                return np.zeros(max(size, 0), dtype=dtype)
            vals = kv[key].split()
            return np.asarray([float(x) for x in vals], dtype=dtype)

        ni = nl - 1
        t.split_feature = arr("split_feature", np.int32, ni)
        t.split_feature_inner = t.split_feature.copy()
        t.split_gain = arr("split_gain", np.float32, ni)
        t.threshold = arr("threshold", np.float64, ni)
        t.threshold_in_bin = np.zeros(ni, dtype=np.int32)
        t.decision_type = arr("decision_type", np.int8, ni)
        t.left_child = arr("left_child", np.int32, ni)
        t.right_child = arr("right_child", np.int32, ni)
        t.leaf_value = arr("leaf_value", np.float64, nl)
        t.leaf_weight = arr("leaf_weight", np.float64, nl)
        t.leaf_count = arr("leaf_count", np.int32, nl)
        t.internal_value = arr("internal_value", np.float64, ni)
        t.internal_weight = arr("internal_weight", np.float64, ni)
        t.internal_count = arr("internal_count", np.int32, ni)
        if t.num_cat > 0:
            t.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
            t.cat_boundaries_inner = list(t.cat_boundaries)
            t.cat_threshold_inner = list(t.cat_threshold)
        # recompute leaf depths/parents from children arrays
        t.leaf_parent = np.full(max(nl, 1), -1, dtype=np.int32)
        t.leaf_depth = np.zeros(max(nl, 1), dtype=np.int32)
        if nl > 1:
            t._recompute_depths(0, 0)
        return t

    def _recompute_depths(self, node: int, depth: int) -> None:
        stack = [(node, depth)]
        while stack:
            nd, dp = stack.pop()
            for child in (self.left_child[nd], self.right_child[nd]):
                if child >= 0:
                    stack.append((int(child), dp + 1))
                else:
                    leaf = ~int(child)
                    self.leaf_depth[leaf] = dp + 1
                    self.leaf_parent[leaf] = nd
