"""TreeSHAP feature contributions (`pred_contrib`).

The plain twin is a copy of `lightgbm_tpu/models/shap.py` (numpy, one
row at a time): the reference's `Tree::PredictContrib` (reference
include/LightGBM/tree.h:133), per-row, per-feature Shapley values such
that `sum(contribs) + expected_value == raw prediction`, by the
polynomial-time TreeSHAP algorithm (Lundberg et al.): a root-to-leaf
walk carrying a "unique path" of (feature, zero_fraction, one_fraction,
pweight) entries, EXTENDed at every split and UNWOUND to attribute each
leaf's value to the features on its path, the node covers (training row
counts) weighting the "cold" branches.

`forest_contribs_t` is the path's version: the same recursion batched
over rows as f64 torch ops on the rows' device.  The recursion visits
every node whatever the row; only the one-fractions (1 on the row's
"hot" branch, 0 on the other) and the order in which a row visits the
leaves (its hot child first) depend on the row.  So the walk runs once
a tree over the tree's structure, with each row's one-fractions and
pweights as [n] tensors, doing each row's f64 operations in the twin's
order (elementwise ops only, no fused multiply-add, division by device
tensors); each leaf's contributions are kept, and every row then adds
them to its features leaf by leaf in its own visiting order.  The
result is the twin's bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .tree import (K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK,
                   K_ZERO_THRESHOLD, Tree)


class _Path:
    """Unique feature path: parallel arrays grown/shrunk in place."""

    __slots__ = ("feature", "zero", "one", "pweight", "length")

    def __init__(self, max_depth: int):
        cap = max_depth + 2
        self.feature = np.full(cap, -1, np.int64)
        self.zero = np.zeros(cap, np.float64)
        self.one = np.zeros(cap, np.float64)
        self.pweight = np.zeros(cap, np.float64)
        self.length = 0

    def copy_of(self) -> "_Path":
        p = _Path(len(self.feature) - 2)
        p.feature[:] = self.feature
        p.zero[:] = self.zero
        p.one[:] = self.one
        p.pweight[:] = self.pweight
        p.length = self.length
        return p

    def extend(self, zero_fraction: float, one_fraction: float,
               feature: int) -> None:
        i = self.length
        self.feature[i] = feature
        self.zero[i] = zero_fraction
        self.one[i] = one_fraction
        self.pweight[i] = 1.0 if i == 0 else 0.0
        self.length += 1
        l = self.length
        for j in range(l - 2, -1, -1):
            self.pweight[j + 1] += one_fraction * self.pweight[j] * (j + 1) / l
            self.pweight[j] = zero_fraction * self.pweight[j] * (l - j - 1) / l

    def unwind(self, i: int) -> None:
        l = self.length
        one = self.one[i]
        zero = self.zero[i]
        n = self.pweight[l - 1]
        for j in range(l - 2, -1, -1):
            if one != 0.0:
                t = self.pweight[j]
                self.pweight[j] = n * l / ((j + 1) * one)
                n = t - self.pweight[j] * zero * (l - j - 1) / l
            else:
                self.pweight[j] = self.pweight[j] * l / (zero * (l - j - 1))
        for j in range(i, l - 1):
            self.feature[j] = self.feature[j + 1]
            self.zero[j] = self.zero[j + 1]
            self.one[j] = self.one[j + 1]
        self.length -= 1

    def unwound_sum(self, i: int) -> float:
        """Sum of pweights as if entry i were unwound (without mutating)."""
        l = self.length
        one = self.one[i]
        zero = self.zero[i]
        n = self.pweight[l - 1]
        total = 0.0
        for j in range(l - 2, -1, -1):
            if one != 0.0:
                tmp = n * l / ((j + 1) * one)
                total += tmp
                n = self.pweight[j] - tmp * zero * (l - j - 1) / l
            else:
                total += self.pweight[j] * l / (zero * (l - j - 1))
        return total


def _node_decision(tree: Tree, node: int, row: np.ndarray) -> bool:
    """go-left for one row at one internal node (Tree.predict semantics)."""
    v = row[tree.split_feature[node]]
    dt = int(tree.decision_type[node])
    mt = (dt >> 2) & 3
    if dt & K_CATEGORICAL_MASK:
        # NaN folds to category 0 unless missing_type is NaN; truncation
        # happens BEFORE the negative test so (-1, 0) folds to 0 as well
        # (Tree._categorical_go_left, models/tree.py:216-233)
        if np.isnan(v):
            if mt == 2:
                return False
            cat = 0
        else:
            cat = int(v)
        if cat < 0:
            return False
        cidx = int(tree.threshold[node])
        lo = tree.cat_boundaries[cidx]
        hi = tree.cat_boundaries[cidx + 1]
        w = cat // 32
        if w >= hi - lo:
            return False
        return bool((tree.cat_threshold[lo + w] >> (cat % 32)) & 1)
    if mt == 2:
        if np.isnan(v):
            return (dt & K_DEFAULT_LEFT_MASK) != 0
        fv = v
    else:
        fv = 0.0 if np.isnan(v) else v
        if mt == 1 and abs(fv) <= K_ZERO_THRESHOLD:
            return (dt & K_DEFAULT_LEFT_MASK) != 0
    return fv <= tree.threshold[node]


def _covers(tree: Tree):
    """(internal_cover, leaf_cover) row counts per node."""
    return (tree.internal_count.astype(np.float64),
            tree.leaf_count.astype(np.float64))


def tree_expected_value(tree: Tree) -> float:
    """Cover-weighted mean leaf value (reference ExpectedValue)."""
    nl = tree.num_leaves
    if nl == 1:
        return float(tree.leaf_value[0])
    w = tree.leaf_count[:nl].astype(np.float64)
    tot = w.sum()
    if tot <= 0:
        return 0.0
    return float((w * tree.leaf_value[:nl]).sum() / tot)


def tree_shap_row(tree: Tree, row: np.ndarray, phi: np.ndarray) -> None:
    """Accumulate one tree's contributions for one row into phi [F+1]."""
    if tree.num_leaves == 1:
        return
    icov, lcov = _covers(tree)

    def recurse(node: int, path: _Path, zero_fraction: float,
                one_fraction: float, feature: int) -> None:
        path = path.copy_of()
        path.extend(zero_fraction, one_fraction, feature)
        if node < 0:  # leaf
            leaf = ~node
            for i in range(1, path.length):
                w = path.unwound_sum(i)
                phi[path.feature[i]] += (
                    w * (path.one[i] - path.zero[i])
                    * tree.leaf_value[leaf])
            return
        go_left = _node_decision(tree, node, row)
        hot = tree.left_child[node] if go_left else tree.right_child[node]
        cold = tree.right_child[node] if go_left else tree.left_child[node]
        cover = icov[node]
        hot_cover = (icov[hot] if hot >= 0 else lcov[~hot])
        cold_cover = (icov[cold] if cold >= 0 else lcov[~cold])
        incoming_zero, incoming_one = 1.0, 1.0
        split_f = int(tree.split_feature[node])
        # if this feature already appears on the path, undo its previous
        # extension first (unique-path invariant)
        prev = -1
        for i in range(path.length):
            if path.feature[i] == split_f:
                prev = i
                break
        if prev >= 0:
            incoming_zero = path.zero[prev]
            incoming_one = path.one[prev]
            path.unwind(prev)
        denom = cover if cover > 0 else 1.0
        recurse(hot, path, incoming_zero * hot_cover / denom,
                incoming_one, split_f)
        recurse(cold, path, incoming_zero * cold_cover / denom,
                0.0, split_f)

    recurse(0, _Path(tree.max_depth()), 1.0, 1.0, -1)


def forest_contribs(models: List[Tree], X: np.ndarray, num_trees: int,
                    num_class: int) -> np.ndarray:
    """[n, num_class, F+1] contributions (last slot = expected value).

    Matches the reference layout for PredictForMat with
    C_API_PREDICT_CONTRIB: per class, per-feature SHAP values plus the
    model's expected value so rows sum to the raw prediction.
    """
    n, F = X.shape
    out = np.zeros((n, num_class, F + 1), np.float64)
    expected = np.zeros(num_class, np.float64)
    for t in range(num_trees):
        expected[t % num_class] += tree_expected_value(models[t])
    out[:, :, F] = expected[None, :]
    for r in range(n):
        row = X[r]
        for t in range(num_trees):
            phi = out[r, t % num_class]
            tree_shap_row(models[t], row, phi)
    return out


# ---- the batched walk ------------------------------------------------------

# bytes a row chunk may hold: each tree's leaf contributions ([L, depth,
# rows] f64) and as much again for the walk's own tensors
_CONTRIB_BUDGET = {"cuda": 12 << 30, "cpu": 256 << 20}


class _Div:
    """Division by a number as a device tensor: a CUDA division by a host
    scalar multiplies by its reciprocal, which rounds otherwise than the
    twin's division."""

    def __init__(self, device):
        self.device = device
        self._cache: Dict[float, torch.Tensor] = {}

    def __call__(self, x: torch.Tensor, d) -> torch.Tensor:
        if isinstance(d, torch.Tensor):
            return x / d
        d = float(d)
        t = self._cache.get(d)
        if t is None:
            t = self._cache[d] = torch.tensor(d, dtype=torch.float64,
                                              device=self.device)
        return x / t


class _BPath:
    """A unique path over rows: features and zero fractions are the
    tree's (row-independent), one fractions [n] tensors, pweights one
    [length, n] tensor."""

    __slots__ = ("feature", "zero", "one", "pweight")

    def __init__(self, feature, zero, one, pweight):
        self.feature = feature
        self.zero = zero
        self.one = one
        self.pweight = pweight


def _extend(path: Optional[_BPath], zero_fraction: float,
            one_fraction: torch.Tensor, feature: int, n: int,
            div: _Div) -> _BPath:
    """_Path.extend on a copy, every j of its loop at once: new[0] =
    z*old[0]*(l-1)/l, new[k] = z*old[k]*(l-k-1)/l + o*old[k-1]*k/l, and
    new[l-1] = 0 + o*old[l-2]*(l-1)/l, each product and quotient in the
    twin's order."""
    dev = one_fraction.device
    if path is None:
        return _BPath([feature], [zero_fraction], [one_fraction],
                      torch.ones((1, n), dtype=torch.float64, device=dev))
    old = path.pweight
    lo = old.shape[0]
    length = lo + 1
    ks = torch.arange(lo, dtype=torch.float64, device=dev)[:, None]
    a = div((old * zero_fraction) * (length - 1 - ks), length)
    b = div((old * one_fraction) * (ks + 1), length)
    new = torch.empty((length, n), dtype=torch.float64, device=dev)
    new[0] = a[0]
    if length > 2:
        new[1:length - 1] = a[1:] + b[:-1]
    new[length - 1] = torch.zeros_like(b[-1]) + b[-1]
    return _BPath(path.feature + [feature], path.zero + [zero_fraction],
                  path.one + [one_fraction], new)


def _unwind(path: _BPath, i: int, div: _Div) -> _BPath:
    """_Path.unwind(i) on a copy: both branches of the twin's `one != 0`
    test, chosen per row."""
    length = len(path.feature)
    one, zero = path.one[i], path.zero[i]
    nz = one != 0.0
    pw = path.pweight
    new = pw.clone()
    run = pw[length - 1]
    for j in range(length - 2, -1, -1):
        hot = div(run * length, (j + 1) * one)
        cold = div(pw[j] * length, zero * (length - j - 1))
        new[j] = torch.where(nz, hot, cold)
        run = torch.where(nz, pw[j] - div((hot * zero) * (length - j - 1),
                                          length), run)
    keep = [j for j in range(length) if j != i]
    return _BPath([path.feature[j] for j in keep],
                  [path.zero[j] for j in keep], [path.one[j] for j in keep],
                  new[:length - 1])


def _leaf_contribs(path: _BPath, leaf_value: float, div: _Div
                   ) -> torch.Tensor:
    """[length - 1, n]: w * (one - zero) * leaf_value of entries 1.. of the
    path, w each entry's _Path.unwound_sum, all entries at once."""
    length = len(path.feature)
    pw = path.pweight
    ones = torch.stack(path.one[1:])
    zeros = torch.tensor(path.zero[1:], dtype=torch.float64,
                         device=pw.device)[:, None]
    nz = ones != 0.0
    run = pw[length - 1].expand_as(ones)
    total = torch.zeros_like(ones)
    for j in range(length - 2, -1, -1):
        tmp = div(run * length, (j + 1) * ones)
        total = total + torch.where(
            nz, tmp, div(pw[j] * length, zeros * (length - j - 1)))
        run = torch.where(nz, pw[j] - div((tmp * zeros) * (length - j - 1),
                                          length), run)
    return (total * (ones - zeros)) * leaf_value


def _tree_shap_rows(tree: Tree, xt: torch.Tensor, phi: torch.Tensor,
                    div: _Div) -> None:
    """Add one tree's contributions for the rows `xt` [F, n] f64 into
    `phi` [n, F + 2] (column F + 1 takes nothing), every row in its own
    order of leaves."""
    from ..ops.predict import pack_raw_trees, raw_device_tables, raw_go_left

    if tree.num_leaves == 1:
        return
    dev = xt.device
    n = xt.shape[1]
    F = phi.shape[1] - 2
    ni = tree.num_leaves - 1
    tab = raw_device_tables(pack_raw_trees([tree])[0], dev)
    go_left = raw_go_left(
        torch.gather(xt, 0, tab["split_feature"][0, :ni, None].expand(ni, n)),
        *(tab[k][0, :ni, None] for k in ("decision_type", "threshold",
                                         "cat_start", "cat_width")),
        tab["cat_words"])
    icov, lcov = _covers(tree)

    def cover(node: int) -> float:
        return icov[node] if node >= 0 else lcov[~node]

    def leaves_under(node: int) -> int:
        return 1 if node < 0 else (leaves_under(int(tree.left_child[node]))
                                   + leaves_under(int(tree.right_child[node])))

    L = tree.num_leaves
    depth = tree.max_depth() + 1
    vals = torch.zeros((L, depth, n), dtype=torch.float64, device=dev)
    feats = torch.full((L, depth), F + 1, dtype=torch.int64)
    rank = torch.zeros((L, n), dtype=torch.int64, device=dev)
    zero_i = torch.zeros(n, dtype=torch.int64, device=dev)

    def recurse(node, path, zero_fraction, one_fraction, feature, offset):
        path = _extend(path, zero_fraction, one_fraction, feature, n, div)
        if node < 0:
            leaf = ~node
            vals[leaf, :len(path.feature) - 1] = _leaf_contribs(
                path, float(tree.leaf_value[leaf]), div)
            feats[leaf, :len(path.feature) - 1] = torch.tensor(
                path.feature[1:])
            rank[leaf] = offset
            return
        gl = go_left[node]
        lc, rc = int(tree.left_child[node]), int(tree.right_child[node])
        split_f = int(tree.split_feature[node])
        incoming_zero = 1.0
        incoming_one = torch.ones(n, dtype=torch.float64, device=dev)
        if split_f in path.feature:
            prev = path.feature.index(split_f)
            incoming_zero = path.zero[prev]
            incoming_one = path.one[prev]
            path = _unwind(path, prev, div)
        c = icov[node]
        denom = c if c > 0 else 1.0
        off = torch.zeros_like(incoming_one)
        # a row visits its hot child's leaves first
        recurse(lc, path, incoming_zero * cover(lc) / denom,
                torch.where(gl, incoming_one, off), split_f,
                offset + torch.where(gl, zero_i, leaves_under(rc)))
        recurse(rc, path, incoming_zero * cover(rc) / denom,
                torch.where(gl, off, incoming_one), split_f,
                offset + torch.where(gl, leaves_under(lc), zero_i))

    recurse(0, None, 1.0, torch.ones(n, dtype=torch.float64, device=dev),
            -1, zero_i)
    # each row adds its leaves' contributions in its visiting order;
    # within a leaf the features are distinct
    order = torch.empty((n, L), dtype=torch.int64, device=dev)
    order.scatter_(1, rank.T, torch.arange(L, device=dev).expand(n, L))
    feats = feats.to(dev)
    rows = torch.arange(n, device=dev)
    for s in range(L):
        leaf = order[:, s]
        idx = feats[leaf]
        phi.scatter_(1, idx, phi.gather(1, idx) + vals[leaf, :, rows])


def forest_contribs_t(models: List[Tree], X: np.ndarray, num_trees: int,
                      num_class: int, device) -> np.ndarray:
    """`forest_contribs` ([n, num_class, F+1] f64, the last slot the
    expected value) on `device`, batched over rows in chunks; bit for
    bit the twin's."""
    X = np.asarray(X, np.float64)
    n, F = X.shape
    out = np.zeros((n, num_class, F + 1), np.float64)
    expected = np.zeros(num_class, np.float64)
    for t in range(num_trees):
        expected[t % num_class] += tree_expected_value(models[t])
    out[:, :, F] = expected[None, :]
    dev = torch.device(device)
    L = max([models[t].num_leaves for t in range(num_trees)] + [1])
    depth = max([models[t].max_depth() for t in range(num_trees)] + [0]) + 1
    budget = _CONTRIB_BUDGET["cuda" if dev.type == "cuda" else "cpu"]
    chunk = max(int(budget // (L * depth * 8 * 2)), 1)
    div = _Div(dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        xt = torch.as_tensor(np.ascontiguousarray(X[lo:hi].T), device=dev)
        phi = torch.zeros((num_class, hi - lo, F + 2), dtype=torch.float64,
                          device=dev)
        for t in range(num_trees):
            _tree_shap_rows(models[t], xt, phi[t % num_class], div)
        out[lo:hi, :, :F] = phi[:, :, :F].permute(1, 0, 2).cpu().numpy()
    return out
