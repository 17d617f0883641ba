"""`train` and `cv`: the `lgb.train` and `lgb.cv` entry points
(reference engine.py).

The port of `lightgbm_tpu/engine.py`.  `train`: validation sets (the
training set among them, too), custom objectives (`fobj`) and metrics
(`feval`), callbacks run before and after each iteration in their
`order`, early stopping, evaluation logging and recording, and a
learning-rate schedule, continuation from an init model (a path or a
Booster, its trees first and replayed onto the scores) and training
snapshots (`snapshot_freq`: `<output_model>.snapshot_iter_N` every N
rounds).  `cv`: k folds (whole queries for ranking data,
stratified for binary and multiclass labels, shuffled from a numpy
generator of `seed`), one booster a fold trained
in turns on a row subset of the dataset (`Dataset.subset`), the mean
and standard deviation of each metric over the folds after each round,
early stopping on the first metric, and the fold boosters as a
`CVBooster`.  Fault tolerance, after lightgbm_tpu/engine.py:111-283:
`tpu_checkpoint_dir` adds the atomic checkpoint callback (every
`tpu_checkpoint_interval` rounds, `tpu_checkpoint_keep` kept),
`resume=True` restarts from the newest valid bundle (either package's),
SIGTERM becomes a KeyboardInterrupt in the main thread, and an
interrupted or finished run flushes a final checkpoint, then dumps the
flight recorder's blackbox on the way out of an interrupt.  `cv`'s
`init_model` and `callbacks` raise (the JAX package's `cv` never reads
them).
"""

from __future__ import annotations

import copy
import signal
import threading
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import obs
from .basic import Dataset
from .booster import Booster
from .callback import (CallbackEnv, EarlyStopException, _Checkpoint,
                       early_stopping, log_evaluation, record_evaluation,
                       reset_parameter)
from .utils.checkpoint import flush_checkpoint, restore_checkpoint
from .utils.log import Log

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "n_iter", "num_tree", "num_trees", "num_round",
                  "num_rounds", "n_estimators")
_EARLY_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                       "early_stopping", "n_iter_no_change")


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
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)
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

    init_model_str = None
    if init_model is not None:
        init_booster = (Booster(model_file=init_model, params=params)
                        if isinstance(init_model, str) else init_model)
        init_model_str = init_booster.model_to_string()

    booster = Booster(params=params, train_set=train_set)
    if init_model_str is not None:
        booster._driver.merge_from_model_string(init_model_str)
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

    # atomic interval checkpoints (tpu_checkpoint_dir) and resume=True;
    # the callback is added unless the caller gave one
    ckpt_dir = str(params.get("tpu_checkpoint_dir", "") or "")
    ckpt_cb = next((cb for cb in callbacks if isinstance(cb, _Checkpoint)),
                   None)
    if ckpt_cb is None and ckpt_dir:
        ckpt_cb = _Checkpoint(
            ckpt_dir,
            interval=int(params.get("tpu_checkpoint_interval", 1) or 1),
            keep=int(params.get("tpu_checkpoint_keep", 3) or 3))
        callbacks.append(ckpt_cb)
    ckpt_manager = None
    if ckpt_cb is not None:
        ckpt_manager = ckpt_cb.manager
        ckpt_cb.peers = [cb for cb in callbacks if cb is not ckpt_cb]
    if resume and ckpt_manager is None:
        raise ValueError("resume=True needs tpu_checkpoint_dir (or an "
                         "explicit checkpoint callback)")
    cb_before = sorted((cb for cb in callbacks
                        if getattr(cb, "before_iteration", False)),
                       key=lambda cb: getattr(cb, "order", 0))
    cb_after = sorted((cb for cb in callbacks
                       if not getattr(cb, "before_iteration", False)),
                      key=lambda cb: getattr(cb, "order", 0))

    start_iteration = 0
    if resume:
        restored = restore_checkpoint(booster, ckpt_manager,
                                      callbacks=callbacks)
        if restored is not None:
            # the stored iteration counts init_model trees too; the loop
            # counts only new rounds
            start_iteration = (int(restored["iteration"])
                               - int(restored.get("num_init_iteration", 0)))

    # training snapshots (reference GBDT::Train, gbdt.cpp:290-294)
    snapshot_freq = int(params.get("snapshot_freq", -1) or -1)
    snapshot_out = str(params.get("output_model", "LightGBM_model.txt"))

    # graceful preemption: with checkpointing configured, SIGTERM becomes
    # a KeyboardInterrupt, so the iteration's rollback and the final
    # flush below run before the process goes
    prev_sigterm = None
    if ckpt_manager is not None and \
            threading.current_thread() is threading.main_thread():
        def _on_sigterm(signum, frame):
            raise KeyboardInterrupt("SIGTERM")

        try:
            prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):  # pragma: no cover - exotic host
            prev_sigterm = None

    def _dump_trace() -> None:
        # the Chrome trace and the JSONL flush at the end of train
        # (success, early stop or interrupt: the trace of a failed run
        # is the one worth reading), after the final checkpoint flush so
        # its spans and events make the dump; nothing without
        # tpu_trace_dir
        if obs.tracing_on():
            obs.write_chrome_trace()
            obs.flush()

    evaluation_result_list: List = []
    try:
        for i in range(start_iteration, num_boost_round):
            # the blackbox of a dying run names the round it died in
            # (recorded at the round's start: the span's mirror lands at
            # its exit, which a death mid-round never reaches)
            obs.flightrecorder.note("round", "train/round", iteration=i)
            # the round's span covers callbacks, update and evaluation:
            # under tpu_telemetry=trace the round spans cover >= 95% of
            # the loop's wall
            with obs.span("train/round", iteration=i):
                for cb in cb_before:
                    cb(CallbackEnv(model=booster, params=params,
                                   iteration=i, begin_iteration=0,
                                   end_iteration=num_boost_round,
                                   evaluation_result_list=None))
                booster.update(fobj=fobj)
                if snapshot_freq > 0 and (i + 1) % snapshot_freq == 0:
                    booster.save_model(
                        f"{snapshot_out}.snapshot_iter_{i + 1}")
                evaluation_result_list = []
                if valid_sets:
                    if is_valid_contain_train:
                        evaluation_result_list.extend(
                            booster.eval_train(feval))
                    evaluation_result_list.extend(booster.eval_valid(feval))
                    if obs.metrics_on():
                        # the metric curves, in the registry's sample
                        # ring (engine.py:218-229 of the JAX package)
                        for item in evaluation_result_list:
                            obs.REGISTRY.observe(
                                "lgbm_train_metric", float(item[2]),
                                help="per-iteration train/valid metric "
                                     "values (ring = learning curve)",
                                dataset=str(item[0]),
                                metric=str(item[1]))
                try:
                    for cb in cb_after:
                        cb(CallbackEnv(
                            model=booster, params=params, iteration=i,
                            begin_iteration=0,
                            end_iteration=num_boost_round,
                            evaluation_result_list=evaluation_result_list))
                except EarlyStopException as e:
                    booster.best_iteration = e.best_iteration + 1
                    evaluation_result_list = e.best_score
                    break
    except BaseException as exc:
        # the partial iteration was rolled back inside update(): flush a
        # final checkpoint so the run restarts from the last complete
        # iteration, then dump the blackbox (after the flush, so its
        # metric snapshot shows the checkpoint landed) and re-raise
        if ckpt_manager is not None:
            flush_checkpoint(booster, ckpt_manager, callbacks=callbacks)
        obs.flightrecorder.note("crash", "train_interrupted",
                                type=type(exc).__name__,
                                iteration=booster.current_iteration())
        obs.flightrecorder.dump(f"train_interrupt:{type(exc).__name__}",
                                exc=exc)
        _dump_trace()
        raise
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    if ckpt_manager is not None:
        # early stop (or a zero-round run) can end between interval
        # marks: one final bundle covers the completed state
        flush_checkpoint(booster, ckpt_manager, callbacks=callbacks)
    _dump_trace()

    booster.best_score = {}
    for item in evaluation_result_list:
        booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    if booster.best_iteration < 0:
        booster.best_iteration = -1
    if not keep_training_booster:
        booster.free_dataset()
    return booster


class CVBooster:
    """The fold boosters of `cv` (reference engine.py:296): any Booster
    method called on it runs on every fold and returns one result a
    fold."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _FoldFanout(self.boosters, name)


class _FoldFanout:
    """A Booster method mapped over every fold."""

    def __init__(self, boosters: List[Booster], method: str):
        self._boosters = boosters
        self._method = method

    def __call__(self, *args: Any, **kwargs: Any) -> List[Any]:
        return [getattr(b, self._method)(*args, **kwargs)
                for b in self._boosters]


def _make_n_folds(full_data: Dataset, nfold: int, seed: int,
                  stratified: bool, shuffle: bool):
    """(train indices, test indices) of each fold, drawn as
    lightgbm_tpu/engine.py:_make_n_folds draws them: whole queries for
    ranking data, else stratified by label class, or plain; shuffled by
    a numpy generator of `seed`."""
    full_data.construct()
    num_data = full_data.num_data()
    rng = np.random.default_rng(seed)
    boundaries = full_data.get_field("group")
    if boundaries is not None:
        num_queries = len(boundaries) - 1
        q_idx = np.arange(num_queries)
        if shuffle:
            rng.shuffle(q_idx)
        flat_group = np.zeros(num_data, dtype=np.int64)
        for q in range(num_queries):
            flat_group[boundaries[q]:boundaries[q + 1]] = q
        folds = []
        for k in range(nfold):
            test_mask = np.isin(flat_group, q_idx[k::nfold])
            folds.append((np.where(~test_mask)[0], np.where(test_mask)[0]))
        return folds
    if stratified:
        label = full_data.get_field("label")
        idx_by_class: List[np.ndarray] = []
        for c in np.unique(label):
            ci = np.where(label == c)[0]
            if shuffle:
                rng.shuffle(ci)
            idx_by_class.append(ci)
        folds = []
        for k in range(nfold):
            test_idx = np.concatenate([ci[k::nfold] for ci in idx_by_class])
            mask = np.zeros(num_data, dtype=bool)
            mask[test_idx] = True
            folds.append((np.where(~mask)[0], np.where(mask)[0]))
        return folds
    idx = np.arange(num_data)
    if shuffle:
        rng.shuffle(idx)
    return [(np.setdiff1d(idx, idx[k::nfold], assume_unique=False),
             idx[k::nfold]) for k in range(nfold)]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, early_stopping_rounds: Optional[int] = None,
       verbose_eval: Union[bool, int, None] = None, show_stdv: bool = True,
       seed: int = 0, callbacks=None, return_cvbooster: bool = False
       ) -> Dict:
    """k-fold cross-validation: {"<metric>-mean": [...], "<metric>-stdv":
    [...]} over the rounds (cut at the best round when early stopping
    fires), with "cvbooster" when return_cvbooster."""
    params = copy.deepcopy(params)
    given = [name for name, v in (("init_model", init_model),
                                  ("callbacks", callbacks)) if v]
    if given:
        raise NotImplementedError(
            f"lgb.cv({', '.join(given)}=...) is not ported to "
            "lightgbm_tpu_torch yet")
    if metrics is not None:
        params["metric"] = metrics
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    if train_set._inner is None:
        # the dataset is binned with its own params, as the JAX package's
        # cv bins it, on the device the training params name
        train_set.params = {**train_set.params,
                            **{k: params[k] for k in ("device_type",
                                                      "device")
                               if k in params}}
    if folds is None:
        stratified = stratified and str(params.get("objective", "")
                                        ).startswith(("binary",
                                                      "multiclass"))
        folds = _make_n_folds(train_set, nfold, seed, stratified, shuffle)
    elif hasattr(folds, "split"):
        label = train_set.get_field("label")
        folds = list(folds.split(np.zeros(train_set.num_data()), label))

    cvbooster = CVBooster()
    for train_idx, test_idx in folds:
        tr = train_set.subset(np.sort(train_idx))
        te = train_set.subset(np.sort(test_idx))
        bst = Booster(params=params, train_set=tr)
        bst.add_valid(te, "valid")
        cvbooster._append(bst)

    results: Dict[str, List[float]] = {}
    for i in range(num_boost_round):
        all_evals = []
        for bst in cvbooster.boosters:
            bst.update(fobj=fobj)
            all_evals.append(bst.eval_valid(feval))
        agg: Dict[str, List[float]] = {}
        higher: Dict[str, bool] = {}
        for evals in all_evals:
            for item in evals:
                agg.setdefault(item[1], []).append(item[2])
                higher[item[1]] = item[3]
        for key, vals in agg.items():
            results.setdefault(f"{key}-mean", []).append(
                float(np.mean(vals)))
            results.setdefault(f"{key}-stdv", []).append(float(np.std(vals)))
        if verbose_eval:
            print(f"[{i + 1}]\t" + "\t".join(
                f"{k}: {np.mean(v):g} + {np.std(v):g}"
                for k, v in agg.items()))
        stop = False
        if early_stopping_rounds and i >= early_stopping_rounds:
            # the first metric decides
            key = next(iter(agg))
            series = results[f"{key}-mean"]
            best = np.argmax(series) if higher[key] else np.argmin(series)
            if i - best >= early_stopping_rounds:
                cvbooster.best_iteration = int(best) + 1
                stop = True
        if stop:
            for key in list(results):
                results[key] = results[key][:cvbooster.best_iteration]
            break

    out: Dict[str, Any] = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
