"""Device forest prediction: bin-space traversal as torch ops.

The port of `lightgbm_tpu/ops/predict.py`: `pack_trees` (host numpy,
copied) flattens `Tree` models into dense per-tree node tables, with the
categorical nodes' bitsets in one shared word pool (`cat_words`, word 0
kept zero, each categorical node a (start, width) window into it), and
`leaf_values` walks every row through every tree in bin space, one
gather step per depth level — the analog of `NumericalDecisionInner` and
`CategoricalDecisionInner` (reference tree.h:252-318) with NaN/zero
missing routing and the bitset override.  `PackedForest` appends the
trees trained since its last call to amortized host tables instead of
packing the forest anew.  The JAX package runs this as plain XLA, so the
port runs it as plain torch ops on the card; it has no hand kernel.

The raw-value walker (`pack_raw_trees`, `raw_leaf_index`,
`raw_forest_scores`) is the port of the JAX package's f64 host walker,
the OpenMP forest predictor (src/capi/forest_predictor.cpp:55-155) and
its numpy fallback (lightgbm_tpu/models/gbdt.py:1889-1929): the trees'
f64 thresholds against the raw f64 feature values, NaN and zero as
missing by `missing_type`, `default_left`, and the raw categories'
bitsets (a negative or NaN category goes right), every tree's leaf
values summed per row in f64 in tree order, with the prediction early
stop of forest_predictor.cpp:134-149.  It runs as torch ops on the
booster's device, and its plain twin is the numpy `Tree.predict` walk
(`raw_scores_plain`), which it equals bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# table keys that are [T, num_internal_nodes] int32
_NODE_KEYS = ("split_feature", "threshold", "decision_type",
              "left_child", "right_child", "cat_start", "cat_width")


def pack_trees(trees: Sequence, leaf_width: int = 0
               ) -> Tuple[Dict[str, np.ndarray], int]:
    """Flatten host Tree models into dense [T, ...] node tables.

    Returns (tables, max_depth).  Leaves stay encoded as `~leaf_idx` in
    the child columns; a constant tree starts at node `~0`.  Categorical
    nodes carry a (start, width) window into the shared `cat_words`
    bitset pool, whose word 0 stays zero so that numerical nodes point at
    it harmlessly.  `leaf_width` pins the leaf axis.  The table
    keys and layout are those of the JAX package's `pack_trees`, so its
    tables load here unchanged (`convert.py`)."""
    T = len(trees)
    L = max([t.num_leaves for t in trees] + [max(int(leaf_width), 1)])
    ni_w = max(L - 1, 1)
    sf = np.zeros((T, ni_w), np.int32)
    thr = np.zeros((T, ni_w), np.int32)
    dt = np.zeros((T, ni_w), np.int32)
    lc = np.zeros((T, ni_w), np.int32)
    rc = np.zeros((T, ni_w), np.int32)
    cs = np.zeros((T, ni_w), np.int32)
    cw = np.zeros((T, ni_w), np.int32)
    lv = np.zeros((T, L), np.float32)
    init = np.zeros(T, np.int32)
    words: List[np.ndarray] = [np.zeros(1, np.uint32)]
    woff = 1
    depth = 1
    for ti, t in enumerate(trees):
        nl = int(t.num_leaves)
        lv[ti, :nl] = t.leaf_value[:nl]
        ni = nl - 1
        if ni <= 0:
            init[ti] = -1  # ~0: already at leaf 0
            continue
        sf[ti, :ni] = t.split_feature_inner[:ni]
        thr[ti, :ni] = t.threshold_in_bin[:ni]
        dt[ti, :ni] = t.decision_type[:ni].astype(np.int32) & 0xF
        lc[ti, :ni] = t.left_child[:ni]
        rc[ti, :ni] = t.right_child[:ni]
        depth = max(depth, int(t.max_depth()))
        if t.num_cat > 0:
            cb = np.asarray(t.cat_boundaries_inner, np.int64)
            tw = np.asarray(t.cat_threshold_inner, np.uint32)
            is_cat = (dt[ti, :ni] & 1) != 0
            ci = np.clip(thr[ti, :ni], 0, max(len(cb) - 2, 0))
            cs[ti, :ni] = np.where(is_cat, woff + cb[ci], 0)
            cw[ti, :ni] = np.where(is_cat, cb[ci + 1] - cb[ci], 0)
            if len(tw):
                words.append(tw)
                woff += len(tw)
    pool = np.concatenate(words)
    tables = {"split_feature": sf, "threshold": thr, "decision_type": dt,
              "left_child": lc, "right_child": rc, "cat_start": cs,
              "cat_width": cw, "leaf_value": lv, "init_node": init,
              "cat_words": pool}
    return tables, depth


def upload(host: np.ndarray, device) -> torch.Tensor:
    """A small host array on `device` without a host wait: on the card,
    one copy from pinned memory queued on the stream (a blocking copy
    would wait for the work queued before it)."""
    t = torch.from_numpy(host)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_tables(tables: Dict[str, np.ndarray], device
                  ) -> Dict[str, torch.Tensor]:
    """Host tables -> device tensors, in one upload: every table packed
    into one int64 buffer (the leaf values by their f32 bits, the bitset
    words as their uint32 values), on the card copied from pinned memory
    without a host wait, then viewed apart on the device."""
    keys = _NODE_KEYS + ("init_node", "cat_words")
    lv = np.asarray(tables["leaf_value"], np.float32)
    parts = [np.asarray(tables[k], np.int64) for k in keys] + [
        lv.view(np.int32).astype(np.int64)]
    flat = upload(np.concatenate([p.ravel() for p in parts]), device)
    out, pos = {}, 0
    for k, p in zip(keys + ("leaf_value",), parts):
        out[k] = flat[pos:pos + p.size].view(p.shape)
        pos += p.size
    out["leaf_value"] = out["leaf_value"].to(torch.int32).view(torch.float32)
    return out


#: the [T, n] planes one step of `leaf_index` makes, the node it starts
#: from included: int64 planes and one-byte (bool) planes, and the
#: categorical branch's more; one plane of the bins' own dtype beside
#: them (the gathered bin before its widening).  Every plane a step makes
#: is counted, live or freed, so their bytes bound the step's peak.
WALK_STEP_PLANES = (15, 10)
WALK_CAT_PLANES = (10, 5)


def walk_step_bytes(num_trees: int, rows: int, bins_item: int,
                    has_cat: bool = False) -> int:
    """Bytes of the [T, rows] planes one step of `leaf_index` makes over
    T trees."""
    i64, b1 = WALK_STEP_PLANES
    if has_cat:
        i64, b1 = i64 + WALK_CAT_PLANES[0], b1 + WALK_CAT_PLANES[1]
    return int(num_trees) * int(rows) * (8 * i64 + b1 + int(bins_item))


#: trees `leaf_values` and `class_scores` walk at once: one window of
#: XLA:CPU's reduce (`sum_trees`), so a forest of any size walks in
#: groups whose planes stay bounded
WALK_GROUP = 32


def forest_walk_bytes(num_trees: int, num_class: int, rows: int,
                      bins_item: int, has_cat: bool = False) -> int:
    """Device bytes of `class_scores` over `num_trees` trees and `rows`
    rows, its [k, rows] scores aside (utils/membudget.py's
    predict_scratch): the planes of one group's walk step, the group's
    [G, rows] f32 leaf values, and for one class over more than a group
    its [ceil(T / 32), rows] f32 window sums."""
    T = int(num_trees)
    group = min(T, WALK_GROUP)
    windows = -(-T // _XLA_WINDOW) if num_class <= 1 and T > _XLA_WINDOW \
        else 0
    return (walk_step_bytes(group, rows, bins_item, has_cat)
            + (group + windows) * int(rows) * 4)


def leaf_index(tables: Dict[str, torch.Tensor], bins_t: torch.Tensor,
               num_bin: torch.Tensor, default_bin: torch.Tensor,
               missing_type: torch.Tensor, depth: int) -> torch.Tensor:
    """[T, n] int64 leaf indices: every tree walked over every row.

    bins_t: [F, n] bins; num_bin/default_bin/missing_type: [F] int64.
    Rows already at a leaf (node < 0) keep their state."""
    words = tables["cat_words"]
    has_cat = words.shape[0] > 1
    T = tables["leaf_value"].shape[0]
    n = bins_t.shape[1]
    node = tables["init_node"][:, None].expand(T, n).contiguous()
    for _ in range(depth):
        nid = node.clamp(min=0)
        f = torch.gather(tables["split_feature"], 1, nid)        # [T, n]
        fbin = torch.gather(bins_t, 0, f).long()                 # [T, n]
        mt = missing_type[f]
        is_missing = torch.where(mt == 2, fbin == num_bin[f] - 1,
                                 (mt == 1) & (fbin == default_bin[f]))
        dt = torch.gather(tables["decision_type"], 1, nid)
        thr = torch.gather(tables["threshold"], 1, nid)
        go_left = torch.where(is_missing, (dt & 2) != 0, fbin <= thr)
        if has_cat:
            # bitset membership in bin space: the bins in the node's set
            # go left, every other bin (the NaN bin too) right
            cs = torch.gather(tables["cat_start"], 1, nid)
            width = torch.gather(tables["cat_width"], 1, nid)
            word_idx = fbin // 32
            word = words[torch.clamp(cs + word_idx, 0, words.shape[0] - 1)]
            bit = (word >> (fbin % 32)) & 1
            go_cat = (word_idx < width) & (bit == 1)
            go_left = torch.where((dt & 1) != 0, go_cat, go_left)
        nxt = torch.where(go_left,
                          torch.gather(tables["left_child"], 1, nid),
                          torch.gather(tables["right_child"], 1, nid))
        node = torch.where(node >= 0, nxt, node)
    return torch.where(node < 0, ~node, 0)


def tree_group(tables: Dict[str, torch.Tensor], lo: int, hi: int
               ) -> Dict[str, torch.Tensor]:
    """The tables of trees [lo, hi) (the bitset word pool is shared)."""
    return {k: (v if k == "cat_words" else v[lo:hi])
            for k, v in tables.items()}


def group_values(tables: Dict[str, torch.Tensor], bins_t: torch.Tensor,
                 meta, depth: int, lo: int, hi: int) -> torch.Tensor:
    """[hi - lo, n] f32 leaf values of trees [lo, hi) over every row."""
    sub = tree_group(tables, lo, hi)
    return torch.gather(sub["leaf_value"], 1,
                        leaf_index(sub, bins_t, *meta, depth))


def leaf_values(tables: Dict[str, torch.Tensor], bins_t: torch.Tensor,
                num_bin: torch.Tensor, default_bin: torch.Tensor,
                missing_type: torch.Tensor, depth: int) -> torch.Tensor:
    """[T, n] f32 leaf values: every tree walked over every row, in
    groups of WALK_GROUP trees."""
    T = tables["leaf_value"].shape[0]
    meta = (num_bin, default_bin, missing_type)
    if T <= WALK_GROUP:
        return group_values(tables, bins_t, meta, depth, 0, T)
    out = torch.empty((T, bins_t.shape[1]), dtype=torch.float32,
                      device=bins_t.device)
    for lo in range(0, T, WALK_GROUP):
        hi = min(lo + WALK_GROUP, T)
        out[lo:hi] = group_values(tables, bins_t, meta, depth, lo, hi)
    return out


def subset_scores(trees: Sequence, scales: Sequence[float],
                  bins_t: torch.Tensor, meta: List[torch.Tensor]
                  ) -> torch.Tensor:
    """[n] f32: sum_i scales[i] * trees[i](row) over a binned [F, n] set,
    as the JAX package's binned subset walk computes it
    (src/capi/forest_predictor.cpp:270-285, the DART drop and restore):
    per row an f64 sum over the listed trees in list order of the f64
    leaf values times their scales, then one cast to f32.  One walk of
    every listed tree, on the set's device."""
    tables, depth = pack_trees(trees)
    dev = bins_t.device
    lv = np.zeros(tables["leaf_value"].shape, np.float64)
    for i, (t, sc) in enumerate(zip(trees, scales)):
        lv[i, :t.num_leaves] = (np.asarray(t.leaf_value[:t.num_leaves],
                                           np.float64) * float(sc))
    leaf = leaf_index(device_tables(tables, dev), bins_t, *meta, depth)
    vals = torch.gather(upload(lv, dev), 1, leaf)
    acc = torch.zeros(bins_t.shape[1], dtype=torch.float64, device=dev)
    for t in range(vals.shape[0]):
        acc = acc + vals[t]
    return acc.to(torch.float32)


def tree_leaf_values(tables: Dict[str, torch.Tensor], bins_t: torch.Tensor,
                     meta: List[torch.Tensor], depth: int) -> torch.Tensor:
    """[n] f32 leaf values of one packed tree over a binned [F, n] set:
    the per-tree delta of the validation scores (`forest_leaf_values`
    of the JAX package at one tree)."""
    return leaf_values(tables, bins_t, *meta, depth)[0]


# XLA:CPU's reduce window: a sum over more than this many trees goes in
# windows of this many
_XLA_WINDOW = 32


def sum_trees(vals: torch.Tensor) -> torch.Tensor:
    """[T, n] -> [n] f32 sum over trees in the order of XLA:CPU's
    `vals.sum(axis=0)`, the JAX package's device predict, so that both
    round alike.  Up to 32 trees add in sequence.  Past that XLA pads T
    with zeros to a multiple of 32 (half the padding, rounded down, in
    front), sums each window of 32 in sequence, and reduces the window
    sums by the same rule.  Every add is elementwise, so the order is the
    same on the card."""
    while vals.shape[0] > _XLA_WINDOW:
        T = vals.shape[0]
        nb = -(-T // _XLA_WINDOW)
        pad = nb * _XLA_WINDOW - T
        vals = torch.nn.functional.pad(vals, (0, 0, pad // 2, pad - pad // 2))
        win = vals.view(nb, _XLA_WINDOW, -1)
        acc = torch.zeros_like(win[:, 0])
        for j in range(_XLA_WINDOW):
            acc = acc + win[:, j]
        vals = acc
    acc = torch.zeros_like(vals[0])
    for t in range(vals.shape[0]):
        acc = acc + vals[t]
    return acc


def class_scores(tables: Dict[str, torch.Tensor], bins_t: torch.Tensor,
                 meta: List[torch.Tensor], k: int, depth: int
                 ) -> torch.Tensor:
    """[k, n] f32 per-class raw scores: tree i adds to class i % k.  One
    class sums in XLA:CPU's reduce order (`sum_trees`); several classes
    in the order of its `segment_sum(vals, i % k)` scatter, which adds
    the updates one by one in tree order onto zeros
    (lightgbm_tpu/ops/predict.py:318-330): each class's trees in
    sequence, as elementwise adds, so the card rounds alike.

    The trees are walked a group at a time (WALK_GROUP), so the walk's
    planes stay bounded at any tree count (`forest_walk_bytes`): one
    class takes each of the reduce's first windows of 32 trees as one
    group and keeps the window sums, several classes add each group's
    trees in turn; the sums go in the order above either way."""
    T = tables["leaf_value"].shape[0]
    n = bins_t.shape[1]
    if k == 1:
        if T <= _XLA_WINDOW:
            return sum_trees(group_values(tables, bins_t, meta, depth, 0,
                                          T))[None]
        # the first level of the reduce: window w sums the (front-padded)
        # trees [32 w - front, 32 w - front + 32)
        nb = -(-T // _XLA_WINDOW)
        front = (nb * _XLA_WINDOW - T) // 2
        win = torch.empty((nb, n), dtype=torch.float32, device=bins_t.device)
        for w in range(nb):
            lo = max(w * _XLA_WINDOW - front, 0)
            hi = min((w + 1) * _XLA_WINDOW - front, T)
            vals = group_values(tables, bins_t, meta, depth, lo, hi)
            acc = torch.zeros_like(vals[0])
            for j in range(vals.shape[0]):
                acc = acc + vals[j]
            win[w] = acc
        return sum_trees(win)[None]
    out = torch.zeros((k, n), dtype=torch.float32, device=bins_t.device)
    for lo in range(0, T, WALK_GROUP):
        hi = min(lo + WALK_GROUP, T)
        vals = group_values(tables, bins_t, meta, depth, lo, hi)
        for t in range(lo, hi):
            out[t % k] += vals[t - lo]
    return out


class PackedForest:
    """Appendable forest tables: amortized host buffers and a device copy
    (lightgbm_tpu/ops/predict.py:PackedForest).

    `sync(models)` packs only the trees added since the last call into
    capacity-doubling host buffers, rebasing their bitset windows past the
    pool's words; `device(n)` uploads the tables again only when the tree
    count changed.  A tree wider than any seen repacks the forest.  A
    change of leaf values in place (DART's shrinkage) or of the order
    (`shuffle_models`) must drop the instance."""

    def __init__(self, device):
        self._target = device
        self._count = 0
        self._cap = 0
        self._host: Optional[Dict[str, np.ndarray]] = None
        self._depth = 1
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._dev_count = -1

    @property
    def depth(self) -> int:
        return self._depth

    def sync(self, models: Sequence) -> int:
        """Append models[self._count:]; returns the packed tree count."""
        new = models[self._count:]
        if not new:
            return self._count
        width = max([t.num_leaves for t in new] + [1])
        if self._host is None or width > self._host["leaf_value"].shape[1]:
            # the first pack, or a wider tree: rebuild at full width
            tables, depth = pack_trees(list(models))
            self._host = tables
            self._depth = max(self._depth, depth)
            self._cap = self._count = len(models)
            return self._count
        tables, depth = pack_trees(
            list(new), leaf_width=self._host["leaf_value"].shape[1])
        self._depth = max(self._depth, depth)
        need = self._count + len(new)
        if need > self._cap:
            self._cap = max(need, 2 * self._cap)
            for key in _NODE_KEYS + ("leaf_value", "init_node"):
                old = self._host[key]
                grown = np.zeros((self._cap,) + old.shape[1:], old.dtype)
                grown[:self._count] = old[:self._count]
                self._host[key] = grown
        base = int(self._host["cat_words"].shape[0])
        for key in _NODE_KEYS + ("leaf_value", "init_node"):
            self._host[key][self._count:need] = tables[key]
        # the new trees' bitset windows, numbered from their own pack's
        # word 1, move past the words already pooled
        if tables["cat_words"].shape[0] > 1:
            cs = self._host["cat_start"][self._count:need]
            cs[cs > 0] += base - 1
            self._host["cat_words"] = np.concatenate(
                [self._host["cat_words"], tables["cat_words"][1:]])
        self._count = need
        return self._count

    def device(self, num_trees: int = -1) -> Dict[str, torch.Tensor]:
        """Device tables of the first `num_trees` trees (-1: all)."""
        if self._dev_count != self._count:
            host = {k: (v[:self._count] if k != "cat_words" else v)
                    for k, v in self._host.items()}
            self._dev = device_tables(host, self._target)
            self._dev_count = self._count
        if num_trees < 0 or num_trees >= self._count:
            return self._dev
        return {k: (v[:num_trees] if k != "cat_words" else v)
                for k, v in self._dev.items()}


# ---- the raw-value walker --------------------------------------------------

K_ZERO_THRESHOLD = 1e-35
# a categorical value is truncated to its category after a clamp into
# [-1, _CAT_CAP]: -1 and below go right, and so does anything past every
# bitset (the native walker's int64 cast, without its undefined range)
_CAT_CAP = float(2 ** 40)


def pack_raw_trees(trees: Sequence) -> Tuple[Dict[str, np.ndarray], int]:
    """Flatten host Tree models into the raw-value node tables of the
    native walker (lightgbm_tpu/native.py:ForestTables), padded to
    [T, ...] like `pack_trees`: real feature indices, f64 thresholds, the
    raw categories' bitset words in one pool (word 0 kept zero) with a
    (start, width) window a categorical node, f64 leaf values.  Leaves
    stay `~leaf` in the child columns; a constant tree starts at `~0`.
    Returns (tables, max_depth)."""
    T = len(trees)
    L = max([t.num_leaves for t in trees] + [1])
    ni_w = max(L - 1, 1)
    sf = np.zeros((T, ni_w), np.int64)
    thr = np.zeros((T, ni_w), np.float64)
    dt = np.zeros((T, ni_w), np.int64)
    lc = np.zeros((T, ni_w), np.int64)
    rc = np.zeros((T, ni_w), np.int64)
    cs = np.zeros((T, ni_w), np.int64)
    cw = np.zeros((T, ni_w), np.int64)
    lv = np.zeros((T, L), np.float64)
    init = np.zeros(T, np.int64)
    words: List[np.ndarray] = [np.zeros(1, np.int64)]
    woff = 1
    depth = 1
    for ti, t in enumerate(trees):
        nl = int(t.num_leaves)
        lv[ti, :nl] = t.leaf_value[:nl]
        ni = nl - 1
        if ni <= 0:
            init[ti] = -1
            continue
        sf[ti, :ni] = t.split_feature[:ni]
        thr[ti, :ni] = t.threshold[:ni]
        dt[ti, :ni] = t.decision_type[:ni].astype(np.int64) & 0xF
        lc[ti, :ni] = t.left_child[:ni]
        rc[ti, :ni] = t.right_child[:ni]
        depth = max(depth, int(t.max_depth()))
        if t.num_cat > 0:
            cb = np.asarray(t.cat_boundaries, np.int64)
            is_cat = (dt[ti, :ni] & 1) != 0
            # a categorical node's threshold is its bitset's index
            ci = np.clip(np.where(is_cat, thr[ti, :ni], 0.0).astype(np.int64),
                         0, max(len(cb) - 2, 0))
            cs[ti, :ni] = np.where(is_cat, woff + cb[ci], 0)
            cw[ti, :ni] = np.where(is_cat, cb[ci + 1] - cb[ci], 0)
            tw = np.asarray(t.cat_threshold, np.int64)
            if len(tw):
                words.append(tw)
                woff += len(tw)
    tables = {"split_feature": sf, "threshold": thr, "decision_type": dt,
              "left_child": lc, "right_child": rc, "cat_start": cs,
              "cat_width": cw, "leaf_value": lv, "init_node": init,
              "cat_words": np.concatenate(words)}
    return tables, depth


def raw_device_tables(tables: Dict[str, np.ndarray], device
                      ) -> Dict[str, torch.Tensor]:
    """`pack_raw_trees`' tables on `device`."""
    return {k: upload(np.ascontiguousarray(v), device)
            for k, v in tables.items()}


def raw_go_left(v: torch.Tensor, dt: torch.Tensor, thr: torch.Tensor,
                cs: torch.Tensor, cw: torch.Tensor, words: torch.Tensor
                ) -> torch.Tensor:
    """The native walker's decision (forest_predictor.cpp:59-97) for
    values `v` at nodes of decision types `dt`, f64 thresholds `thr` and
    bitset windows (cs, cw) into `words`, all of one shape.  Numerical:
    NaN is missing under missing type NaN and reads as 0 otherwise, and
    a missing value (NaN, or |v| <= 1e-35 under missing type zero) goes
    the default way; else v <= threshold goes left.  Categorical: NaN is
    category 0 unless the missing type is NaN (then right), a value is
    truncated toward 0 to its category, and a category goes left when its
    bit is set in the node's bitset."""
    mt = (dt >> 2) & 3
    isnan = torch.isnan(v)
    fv = torch.where(isnan & (mt != 2), torch.zeros_like(v), v)
    is_default = (((mt == 1) & (fv.abs() <= K_ZERO_THRESHOLD))
                  | ((mt == 2) & isnan))
    go_left = torch.where(is_default, (dt & 2) != 0, fv <= thr)
    is_cat = (dt & 1) != 0
    if words.shape[0] > 1:
        cat = torch.clamp(torch.nan_to_num(v, nan=0.0), -1.0,
                          _CAT_CAP).trunc().long()
        cat = torch.where(isnan & (mt == 2), torch.full_like(cat, -1), cat)
        word_idx = torch.div(cat.clamp(min=0), 32, rounding_mode="floor")
        word = words[torch.clamp(cs + word_idx, 0, words.shape[0] - 1)]
        bit = (word >> (cat.clamp(min=0) % 32)) & 1
        go_cat = (cat >= 0) & (word_idx < cw) & (bit == 1)
        go_left = torch.where(is_cat, go_cat, go_left)
    return go_left


def raw_leaf_index(tables: Dict[str, torch.Tensor], xt: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """[T, n] int64 leaf indices of every tree over the raw rows
    `xt` [F, n] f64 (the features along the first axis), one gather step
    a depth level; rows already at a leaf keep it."""
    T = tables["leaf_value"].shape[0]
    n = xt.shape[1]
    node = tables["init_node"][:, None].expand(T, n).contiguous()
    for _ in range(depth):
        nid = node.clamp(min=0)
        f = torch.gather(tables["split_feature"], 1, nid)
        v = torch.gather(xt, 0, f)
        go_left = raw_go_left(
            v, torch.gather(tables["decision_type"], 1, nid),
            torch.gather(tables["threshold"], 1, nid),
            torch.gather(tables["cat_start"], 1, nid),
            torch.gather(tables["cat_width"], 1, nid), tables["cat_words"])
        nxt = torch.where(go_left,
                          torch.gather(tables["left_child"], 1, nid),
                          torch.gather(tables["right_child"], 1, nid))
        node = torch.where(node >= 0, nxt, node)
    return torch.where(node < 0, ~node, 0)


def raw_forest_scores(leaf_value: torch.Tensor, leaf: torch.Tensor, k: int,
                      early_stop_freq: int = 0,
                      early_stop_margin: float = 0.0) -> torch.Tensor:
    """[k, n] f64 raw scores from the [T, n] leaf indices: tree t adds its
    f64 leaf value to class t % k, per row in tree order from 0, as the
    native walker adds (forest_predictor.cpp:129-155).  early_stop_freq >
    0: after every iteration i (its k trees) with i % freq == 0, a row
    whose margin (|score|, or for several classes the best minus the
    second best) is >= early_stop_margin takes no more trees."""
    vals = torch.gather(leaf_value, 1, leaf)
    T, n = vals.shape
    out = torch.zeros((k, n), dtype=torch.float64, device=vals.device)
    active = None
    if early_stop_freq > 0:
        active = torch.ones(n, dtype=torch.bool, device=vals.device)
    for t in range(T):
        c = t % k
        if active is None:
            out[c] = out[c] + vals[t]
            continue
        out[c] = torch.where(active, out[c] + vals[t], out[c])
        if c == k - 1 and (t // k + 1) % early_stop_freq == 0:
            if k == 1:
                margin = out[0].abs()
            else:
                top = torch.topk(out, 2, dim=0).values
                margin = top[0] - top[1]
            active = active & (margin < early_stop_margin)
    return out


def raw_scores_plain(trees: Sequence, X: np.ndarray, k: int,
                     early_stop_freq: int = 0,
                     early_stop_margin: float = 0.0) -> np.ndarray:
    """The plain twin of the raw walk: the JAX package's numpy fallback
    (lightgbm_tpu/models/gbdt.py:1907-1927), each tree's `Tree.predict`
    added to its class in tree order, in f64."""
    out = np.zeros((k, X.shape[0]), np.float64)
    active = np.ones(X.shape[0], bool)
    for i, tree in enumerate(trees):
        if early_stop_freq > 0 and not active.any():
            break
        if early_stop_freq > 0:
            out[i % k, active] += tree.predict(X[active])
        else:
            out[i % k] += tree.predict(X)
        if (early_stop_freq > 0 and i % k == k - 1
                and (i // k + 1) % early_stop_freq == 0):
            if k == 1:
                margin = np.abs(out[0])
            else:
                top2 = np.sort(out, axis=0)[-2:]
                margin = top2[1] - top2[0]
            active &= margin < early_stop_margin
    return out
