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


def device_tables(tables: Dict[str, np.ndarray], device
                  ) -> Dict[str, torch.Tensor]:
    """Host tables -> device tensors (numeric node tables only)."""
    words = np.asarray(tables["cat_words"])
    if words.shape[0] > 1 or np.any(
            (np.asarray(tables["decision_type"]) & 1) != 0):
        raise NotImplementedError(
            "categorical splits are not ported to lightgbm_tpu_torch yet")
    keys = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child", "init_node")
    out = {k: torch.as_tensor(np.asarray(tables[k], np.int64),
                              device=device) for k in keys}
    out["leaf_value"] = torch.as_tensor(
        np.asarray(tables["leaf_value"], np.float32), device=device)
    return out


def leaf_values(tables: Dict[str, torch.Tensor], bins_t: torch.Tensor,
                num_bin: torch.Tensor, default_bin: torch.Tensor,
                missing_type: torch.Tensor, depth: int) -> torch.Tensor:
    """[T, n] f32 leaf values: every tree walked over every row.

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
    leaf = torch.where(node < 0, ~node, 0)
    return torch.gather(tables["leaf_value"], 1, leaf)


def class_scores(tables: Dict[str, torch.Tensor], bins_t: torch.Tensor,
                 meta: List[torch.Tensor], k: int, depth: int
                 ) -> torch.Tensor:
    """[k, n] f32 per-class raw scores: tree i adds to class i % k."""
    vals = leaf_values(tables, bins_t, *meta, depth)
    if k == 1:
        return vals.sum(dim=0, keepdim=True)
    cid = torch.arange(vals.shape[0], device=vals.device) % k
    out = torch.zeros((k, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, cid, vals)
