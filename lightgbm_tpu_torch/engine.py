"""`train`: the `lgb.train` entry point (reference engine.py).

The port of `lightgbm_tpu/engine.py:train`: validation sets (the
training set among them, too), custom objectives (`fobj`) and metrics
(`feval`), callbacks run before and after each iteration in their
`order`, early stopping, evaluation logging and recording, and a
learning-rate schedule.  Init models, checkpoints, `resume` and
training snapshots are not ported yet and raise when given.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Union

from .basic import Dataset
from .booster import Booster
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       log_evaluation, record_evaluation, reset_parameter)
from .utils.log import Log

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "n_iter", "num_tree", "num_trees", "num_round",
                  "num_rounds", "n_estimators")
_EARLY_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                       "early_stopping", "n_iter_no_change")


def _refuse_unported(params: Dict[str, Any], init_model, resume: bool
                     ) -> None:
    given = []
    if init_model is not None:
        given.append("init_model")
    if resume:
        given.append("resume")
    if str(params.get("tpu_checkpoint_dir", "") or ""):
        given.append("tpu_checkpoint_dir")
    if int(params.get("snapshot_freq", -1) or -1) > 0:
        given.append("snapshot_freq")
    if given:
        raise NotImplementedError(
            f"lgb.train({', '.join(given)}=...) is not ported to "
            "lightgbm_tpu_torch yet")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
          init_model=None,
          feature_name: Union[str, List[str]] = "auto",
          categorical_feature: Union[str, List] = "auto",
          learning_rates=None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          early_stopping_rounds: Optional[int] = None,
          verbose_eval: Union[bool, int] = True,
          evals_result: Optional[Dict] = None,
          resume: bool = False) -> Booster:
    """Train a booster for `num_boost_round` iterations on the card (or
    on the CPU when params say device_type='cpu').  Without
    keep_training_booster the returned booster is predict-only, as the
    JAX package's is."""
    params = copy.deepcopy(params)
    _refuse_unported(params, init_model, resume)
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature not in ("auto", None, [], ()):
        raise NotImplementedError(
            "categorical_feature: categorical features are not ported to "
            "lightgbm_tpu_torch yet")
    if fobj is not None:
        params["objective"] = "none"
    for alias in _ROUND_ALIASES:
        if alias in params:
            Log.warning(f"Found `{alias}` in params. Will use it instead of "
                        "argument")
            num_boost_round = int(params.pop(alias))
    for alias in _EARLY_STOP_ALIASES:
        if alias in params and params[alias] is not None:
            early_stopping_rounds = int(params.pop(alias))
    first_metric_only = bool(params.get("first_metric_only", False))

    booster = Booster(params=params, train_set=train_set)
    booster.set_train_data_name(params.get("train_data_name", "training"))

    valid_sets = valid_sets or []
    if valid_names is None:
        valid_names = [f"valid_{i}" for i in range(len(valid_sets))]
    is_valid_contain_train = False
    for vs, name in zip(valid_sets, valid_names):
        if vs is train_set:
            is_valid_contain_train = True
            continue
        booster.add_valid(vs, name)

    callbacks = list(callbacks) if callbacks else []
    if learning_rates is not None:
        if not isinstance(learning_rates, list) \
                and not callable(learning_rates):
            raise ValueError("learning_rates must be a list or a callable")
        callbacks.append(reset_parameter(learning_rate=learning_rates))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.append(early_stopping(early_stopping_rounds,
                                        first_metric_only,
                                        verbose=bool(verbose_eval)))
    if verbose_eval is True:
        callbacks.append(log_evaluation(1))
    elif isinstance(verbose_eval, int) and verbose_eval >= 1:
        callbacks.append(log_evaluation(verbose_eval))
    if evals_result is not None:
        callbacks.append(record_evaluation(evals_result))
    cb_before = sorted((cb for cb in callbacks
                        if getattr(cb, "before_iteration", False)),
                       key=lambda cb: getattr(cb, "order", 0))
    cb_after = sorted((cb for cb in callbacks
                       if not getattr(cb, "before_iteration", False)),
                      key=lambda cb: getattr(cb, "order", 0))

    evaluation_result_list: List = []
    for i in range(num_boost_round):
        for cb in cb_before:
            cb(CallbackEnv(model=booster, params=params, iteration=i,
                           begin_iteration=0, end_iteration=num_boost_round,
                           evaluation_result_list=None))
        booster.update(fobj=fobj)
        evaluation_result_list = []
        if valid_sets:
            if is_valid_contain_train:
                evaluation_result_list.extend(booster.eval_train(feval))
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in cb_after:
                cb(CallbackEnv(model=booster, params=params, iteration=i,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=evaluation_result_list))
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            evaluation_result_list = e.best_score
            break

    booster.best_score = {}
    for item in evaluation_result_list:
        booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    if booster.best_iteration < 0:
        booster.best_iteration = -1
    if not keep_training_booster:
        booster.free_dataset()
    return booster
