"""Carry a trained forest over from the JAX package, as plain arrays.

`booster_from_arrays` takes the JAX package's trained state as numpy
arrays and returns a port `Booster` that predicts the same on the card:

* the packed forest tables of `lightgbm_tpu/ops/predict.py:pack_trees`
  (a dict of numpy arrays; numerical splits only), and
* the per-used-feature bin mapper arrays: upper bounds, `num_bin`,
  `default_bin` and `missing_type`.

It needs no import of the JAX package: a caller extracts the arrays
there and hands them over.  Model text (the `Tree=` blocks plus the
`tpu_bin_mappers:` trailer) is the other way in: `Booster(model_str=...)`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .booster import Booster
from .config import Config, resolve_device
from .io.bin_mapper import BinMapper, BinType, MissingType
from .models.gbdt import GBDT, PredictContext
from .models.objectives import create_objective_from_model_string


def _tables_depth(tables: Dict[str, np.ndarray]) -> int:
    """Deepest leaf over all trees, walking the child tables."""
    lc, rc = tables["left_child"], tables["right_child"]
    depth = 1
    for t in range(lc.shape[0]):
        if int(tables["init_node"][t]) < 0:
            continue
        stack = [(0, 1)]
        while stack:
            node, d = stack.pop()
            depth = max(depth, d)
            for child in (int(lc[t, node]), int(rc[t, node])):
                if child >= 0:
                    stack.append((child, d + 1))
    return depth


def booster_from_arrays(tables: Dict[str, np.ndarray],
                        bin_upper_bounds: Sequence[np.ndarray],
                        num_bin: Sequence[int], default_bin: Sequence[int],
                        missing_type: Sequence[int],
                        used_feature_idx: Optional[Sequence[int]] = None,
                        num_total_features: Optional[int] = None,
                        objective: str = "binary sigmoid:1",
                        num_tree_per_iteration: Optional[int] = None,
                        params: Optional[Dict] = None) -> Booster:
    """A port Booster over packed forest tables and bin mapper arrays.

    The mapper arrays are per used feature, in the order of the tables'
    split_feature (inner) ids; `used_feature_idx` maps them to the raw
    matrix's columns (default: the first len(num_bin) columns).  A
    forest of k classes (`num_tree_per_iteration`, by default the
    objective's `num_class:`) sends tree i to class i % k, as the JAX
    package's predict does, and predicts [n, k].  Predict runs on the
    device of `params` (the card unless device_type='cpu')."""
    used = (list(range(len(num_bin))) if used_feature_idx is None
            else [int(c) for c in used_feature_idx])
    total = (max(used) + 1 if num_total_features is None
             else int(num_total_features))
    mappers = [BinMapper() for _ in range(total)]
    for j, col in enumerate(used):
        m = mappers[col]
        m.bin_type = BinType.NUMERICAL
        m.is_trivial = False
        m.num_bin = int(num_bin[j])
        m.default_bin = int(default_bin[j])
        m.missing_type = MissingType(int(missing_type[j]))
        m.bin_upper_bound = np.asarray(bin_upper_bounds[j], np.float64)
    driver = GBDT()
    driver.device = resolve_device(Config(dict(params or {})))
    driver.objective = create_objective_from_model_string(objective)
    if num_tree_per_iteration is None:
        num_tree_per_iteration = (
            1 if driver.objective is None
            else driver.objective.num_model_per_iteration())
    driver.num_class = driver.num_tree_per_iteration = int(
        num_tree_per_iteration)
    driver.max_feature_idx = total - 1
    driver._pred_ctx = PredictContext(mappers, used)
    tables = {k: np.asarray(v) for k, v in tables.items()}
    driver._preset = (tables, _tables_depth(tables))
    return Booster._from_driver(driver)
