"""Device forest prediction: bin-space traversal as torch ops.

The port of `lightgbm_tpu/ops/predict.py`: `pack_trees` (host numpy,
copied) flattens `Tree` models into dense per-tree node tables, and
`leaf_values` walks every row through every tree in bin space, one
gather step per depth level — the analog of `NumericalDecisionInner`
(reference tree.h:252-318) with NaN/zero missing routing.  The JAX
package runs this as plain XLA, so the port runs it as plain torch ops
on the card; it has no hand kernel.  Categorical nodes are outside the
port's slice and refused.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def pack_trees(trees: Sequence, leaf_width: int = 0
               ) -> Tuple[Dict[str, np.ndarray], int]:
    """Flatten host Tree models into dense [T, ...] node tables.

    Returns (tables, max_depth).  Leaves stay encoded as `~leaf_idx` in
    the child columns; a constant tree starts at node `~0`.  The table
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
    lv = np.zeros((T, L), np.float32)
    init = np.zeros(T, np.int32)
    depth = 1
    for ti, t in enumerate(trees):
        nl = int(t.num_leaves)
        lv[ti, :nl] = t.leaf_value[:nl]
        ni = nl - 1
        if ni <= 0:
            init[ti] = -1  # ~0: already at leaf 0
            continue
        if t.num_cat > 0:
            raise NotImplementedError(
                "categorical splits are not ported to lightgbm_tpu_torch "
                "yet")
        sf[ti, :ni] = t.split_feature_inner[:ni]
        thr[ti, :ni] = t.threshold_in_bin[:ni]
        dt[ti, :ni] = t.decision_type[:ni].astype(np.int32) & 0xF
        lc[ti, :ni] = t.left_child[:ni]
        rc[ti, :ni] = t.right_child[:ni]
        depth = max(depth, int(t.max_depth()))
    zeros = np.zeros((T, ni_w), np.int32)
    tables = {"split_feature": sf, "threshold": thr, "decision_type": dt,
              "left_child": lc, "right_child": rc, "cat_start": zeros,
              "cat_width": zeros.copy(), "leaf_value": lv, "init_node": init,
              "cat_words": np.zeros(1, np.uint32)}
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
    """Host tables -> device tensors (numeric node tables only), in one
    upload: every table packed into one int64 buffer (the leaf values
    by their f32 bits), on the card copied from pinned memory without a
    host wait, then viewed apart on the device."""
    words = np.asarray(tables["cat_words"])
    if words.shape[0] > 1 or np.any(
            (np.asarray(tables["decision_type"]) & 1) != 0):
        raise NotImplementedError(
            "categorical splits are not ported to lightgbm_tpu_torch yet")
    keys = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child", "init_node")
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


def leaf_index(tables: Dict[str, torch.Tensor], bins_t: torch.Tensor,
               num_bin: torch.Tensor, default_bin: torch.Tensor,
               missing_type: torch.Tensor, depth: int) -> torch.Tensor:
    """[T, n] int64 leaf indices: every tree walked over every row.

    bins_t: [F, n] bins; num_bin/default_bin/missing_type: [F] int64.
    Rows already at a leaf (node < 0) keep their state."""
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
        nxt = torch.where(go_left,
                          torch.gather(tables["left_child"], 1, nid),
                          torch.gather(tables["right_child"], 1, nid))
        node = torch.where(node >= 0, nxt, node)
    return torch.where(node < 0, ~node, 0)


def leaf_values(tables: Dict[str, torch.Tensor], bins_t: torch.Tensor,
                num_bin: torch.Tensor, default_bin: torch.Tensor,
                missing_type: torch.Tensor, depth: int) -> torch.Tensor:
    """[T, n] f32 leaf values: every tree walked over every row."""
    return torch.gather(tables["leaf_value"], 1, leaf_index(
        tables, bins_t, num_bin, default_bin, missing_type, depth))


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
    sequence, as elementwise adds, so the card rounds alike."""
    vals = leaf_values(tables, bins_t, *meta, depth)
    if k == 1:
        return sum_trees(vals)[None]
    out = torch.zeros((k, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    for t in range(vals.shape[0]):
        out[t % k] += vals[t]
    return out
