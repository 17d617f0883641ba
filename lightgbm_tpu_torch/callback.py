"""Training callbacks (the port's own copy of `lightgbm_tpu/callback.py`).

Plays the role of reference python-package/lightgbm/callback.py (the
engine's per-iteration hook system), re-derived for this framework:
callbacks here are small callable OBJECTS carrying their own state, not
closure bundles.  The engine contract is shared with the reference so user
callbacks port over unchanged:

* a callback is called with a `CallbackEnv` after (or, when its
  `before_iteration` attribute is true, before) every boosting iteration;
* `order` sorts multiple callbacks within one iteration;
* raising `EarlyStopException` stops the training loop, carrying the best
  iteration + its evaluation snapshot.

Evaluation entries are `(dataset_name, metric_name, value,
higher_is_better)` tuples, with a 5th stdv element in cv runs.

The checkpoint callback (`_Checkpoint`, `checkpoint`) writes the JAX
package's bundle through `utils/checkpoint.py`; the early-stopping
state rides it (`snapshot_state`/`restore_state`).
"""

from __future__ import annotations

import collections
import math
from typing import Any, Callable, Dict, List, Optional

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score: List):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _entry_text(entry, show_stdv: bool = True) -> str:
    """One eval tuple -> report text (cv entries carry a trailing stdv)."""
    name, metric, value = entry[0], entry[1], entry[2]
    if len(entry) == 5 and show_stdv:
        return f"{name}'s {metric}: {value:g} + {entry[4]:g}"
    if len(entry) not in (4, 5):
        raise ValueError("Wrong metric value")
    return f"{name}'s {metric}: {value:g}"


def _report(entries, show_stdv: bool = True) -> str:
    return "\t".join(_entry_text(e, show_stdv) for e in entries)


class _LogEvaluation:
    order = 10
    before_iteration = False

    def __init__(self, period: int, show_stdv: bool):
        self.period = period
        self.show_stdv = show_stdv

    def __call__(self, env: CallbackEnv) -> None:
        if self.period <= 0 or not env.evaluation_result_list:
            return
        done = env.iteration + 1
        if done % self.period == 0:
            print(f"[{done}]\t"
                  f"{_report(env.evaluation_result_list, self.show_stdv)}")


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    return _LogEvaluation(period, show_stdv)


# reference-era alias of log_evaluation (reference callback.py:55)
print_evaluation = log_evaluation


class _RecordEvaluation:
    order = 20
    before_iteration = False

    def __init__(self, target: Dict[str, Dict[str, List[float]]]):
        self.target = target

    def __call__(self, env: CallbackEnv) -> None:
        for entry in env.evaluation_result_list:
            series = self.target.setdefault(
                entry[0], collections.OrderedDict()).setdefault(entry[1], [])
            series.append(entry[2])


def record_evaluation(eval_result: Dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dict")
    eval_result.clear()
    return _RecordEvaluation(eval_result)


class _ResetParameter:
    order = 10
    before_iteration = True

    def __init__(self, schedules: Dict[str, Any]):
        self.schedules = schedules

    def __call__(self, env: CallbackEnv) -> None:
        step = env.iteration - env.begin_iteration
        updates = {}
        for key, sched in self.schedules.items():
            if isinstance(sched, list):
                if len(sched) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"length of list {key!r} must equal num_boost_round")
                updates[key] = sched[step]
            elif callable(sched):
                updates[key] = sched(step)
        if updates:
            env.model.reset_parameter(updates)


def reset_parameter(**kwargs: Any) -> Callable:
    return _ResetParameter(kwargs)


class _SeriesState:
    """Best-so-far tracker for one (dataset, metric) series."""

    __slots__ = ("maximize", "value", "round", "snapshot")

    def __init__(self, maximize: bool):
        self.maximize = maximize
        self.value = -math.inf if maximize else math.inf
        self.round = 0
        self.snapshot = None

    def offer(self, value: float, iteration: int, entries) -> None:
        better = (value > self.value) if self.maximize else (value < self.value)
        if self.snapshot is None or better:
            self.value = value
            self.round = iteration
            self.snapshot = list(entries)


class _EarlyStopping:
    """Stop when no watched series improves for `stopping_rounds` rounds.

    Matches the reference semantics (dart disables stopping; the training
    set's own metrics never trigger a stop while validation sets exist;
    `first_metric_only` restricts triggering to the first metric) without
    its code shape: state lives in per-series `_SeriesState` objects
    created on the first evaluated iteration.

    snapshot_state/restore_state (keyed "early_stopping") ride the
    training checkpoint bundle so a resumed run keeps the best-so-far
    rounds and stops at the SAME iteration an uninterrupted run would.
    """

    order = 30
    before_iteration = False
    state_key = "early_stopping"

    def __init__(self, stopping_rounds: int, first_metric_only: bool,
                 verbose: bool):
        if stopping_rounds <= 0:
            raise ValueError("stopping_rounds must be > 0")
        self.patience = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.series: List[_SeriesState] = []
        self.active = True
        self.primed = False
        self.first_metric = ""

    def _say(self, text: str) -> None:
        if self.verbose:
            print(text)

    def _prime(self, env: CallbackEnv) -> None:
        self.primed = True
        booster_mode = next(
            (env.params[a] for a in ("boosting", "boosting_type", "boost")
             if a in env.params), "gbdt")
        if booster_mode == "dart":
            self.active = False
            self._say("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one validation set is required")
        self.first_metric = env.evaluation_result_list[0][1]
        self.series = [_SeriesState(maximize=bool(e[3]))
                       for e in env.evaluation_result_list]
        self._say(f"Training until validation scores don't improve for "
                  f"{self.patience} rounds")

    def _halt(self, state: _SeriesState, reason: str) -> None:
        self._say(f"{reason}\n[{state.round + 1}]\t"
                  f"{_report(state.snapshot)}")
        raise EarlyStopException(state.round, state.snapshot)

    def __call__(self, env: CallbackEnv) -> None:
        if not self.primed:
            self._prime(env)
        if not self.active:
            return
        last_round = env.iteration == env.end_iteration - 1
        for state, entry in zip(self.series, env.evaluation_result_list):
            state.offer(entry[2], env.iteration, env.evaluation_result_list)
            if self.first_metric_only and entry[1] != self.first_metric:
                continue
            if entry[0] == "training" and len(self.series) > 1:
                # train metrics are reported but never trigger a stop
                # while real validation sets exist
                continue
            if env.iteration - state.round >= self.patience:
                self._halt(state, "Early stopping, best iteration is:")
            if last_round:
                self._halt(state,
                           "Did not meet early stopping. Best iteration is:")

    # -- state round trip (the JAX package's checkpoint bundle) ---------
    def snapshot_state(self) -> Dict[str, Any]:
        return {
            "primed": self.primed,
            "active": self.active,
            "first_metric": self.first_metric,
            "series": [{"maximize": s.maximize, "value": s.value,
                        "round": s.round,
                        "snapshot": ([list(e) for e in s.snapshot]
                                     if s.snapshot is not None else None)}
                       for s in self.series],
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        self.primed = bool(state.get("primed", False))
        self.active = bool(state.get("active", True))
        self.first_metric = str(state.get("first_metric", ""))
        self.series = []
        for d in state.get("series", []):
            s = _SeriesState(maximize=bool(d["maximize"]))
            s.value = float(d["value"])
            s.round = int(d["round"])
            s.snapshot = ([tuple(e) for e in d["snapshot"]]
                          if d.get("snapshot") is not None else None)
            self.series.append(s)


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    return _EarlyStopping(stopping_rounds, first_metric_only, verbose)


class _Checkpoint:
    """Write an atomic training checkpoint every `interval` iterations
    (and at the final one).  Runs after early stopping (order) so a
    bundle never snapshots a half-evaluated iteration; sibling callbacks
    exposing snapshot_state/restore_state (early stopping) ride the
    bundle via `peers`."""

    order = 40
    before_iteration = False

    def __init__(self, directory: Optional[str] = None, interval: int = 1,
                 keep: int = 3, manager=None):
        from .utils.checkpoint import make_manager

        if manager is None:
            manager = make_manager(directory, keep=keep)
        self.manager = manager
        self.interval = max(int(interval), 1)
        self.peers: list = []  # sibling callbacks; engine.train fills it

    def __call__(self, env: CallbackEnv) -> None:
        from .utils.checkpoint import save_checkpoint

        done = env.iteration + 1
        if done % self.interval == 0 or done == env.end_iteration:
            save_checkpoint(env.model, self.manager, callbacks=self.peers)


def checkpoint(directory: str, interval: int = 1, keep: int = 3) -> Callable:
    """Create the atomic-checkpoint callback (the engine adds one
    automatically when `tpu_checkpoint_dir` is configured)."""
    return _Checkpoint(directory, interval=interval, keep=keep)
