"""`train`: the `lgb.train` entry point (reference engine.py).

The port of the subset of `lightgbm_tpu/engine.py:train` that
`lgb.train(params, train_set, num_boost_round)` needs.  Validation sets,
custom objectives and metrics, callbacks, early stopping, init models
and checkpoints are not ported yet and raise when given.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from .basic import Dataset
from .booster import Booster

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "n_iter", "num_tree", "num_trees", "num_round",
                  "num_rounds", "n_estimators")
_EARLY_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                       "early_stopping", "n_iter_no_change")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, **unported) -> Booster:
    """Train a booster for `num_boost_round` iterations on the card (or
    on the CPU when params say device_type='cpu')."""
    given = sorted(k for k, v in unported.items()
                   if v is not None and v is not False and v != "auto")
    if given:
        raise NotImplementedError(
            f"lgb.train({', '.join(given)}=...) is not ported to "
            "lightgbm_tpu_torch yet")
    params = copy.deepcopy(params)
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _EARLY_STOP_ALIASES:
        if params.get(alias) not in (None, 0, "0"):
            raise NotImplementedError(
                f"{alias}: early stopping is not ported to "
                "lightgbm_tpu_torch yet")
    booster = Booster(params=params, train_set=train_set)
    for _ in range(num_boost_round):
        booster.update()
    return booster
