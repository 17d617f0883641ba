"""scikit-learn API wrappers (reference python-package/lightgbm/sklearn.py).

The port of `lightgbm_tpu/sklearn.py`: `LGBMModel` / `LGBMRegressor` /
`LGBMClassifier` / `LGBMRanker` with the reference constructor surface
(sklearn.py:172-180) and fit/predict semantics, over this package's
`train`.  Like the JAX package's wrappers they need no scikit-learn
(`get_params`/`set_params` are what `sklearn.base.clone` reads), and
`fit` passes `categorical_feature` to the Dataset, so a DataFrame's
`category` columns train as categorical features.  Extra keyword
arguments become parameters: `device_type="cpu"` runs on the CPU, and
without it the estimators train and predict on the card.  `predict`
passes `pred_leaf` and `pred_contrib` to the booster, as the JAX
wrapper does (sklearn.py:251-257, 330-342).  `fit(init_model=...)`, a
model file or a Booster, continues training from it, as the
reference's wrapper does; the JAX wrapper's `fit` has no such argument.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Dataset
from .booster import Booster
from .engine import train


class _ObjectiveFunctionWrapper:
    """Adapt sklearn-style fobj(y_true, y_pred[, weight[, group]]) to the
    engine's fobj(scores, dataset) contract
    (reference sklearn.py:21-97 _ObjectiveFunctionWrapper)."""

    def __init__(self, func):
        self.func = func

    def __call__(self, scores, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        preds = scores.reshape(-1)
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_weight())
        elif argc == 4:
            grad, hess = self.func(labels, preds, dataset.get_weight(),
                                   dataset.get_group())
        else:
            raise TypeError(f"Self-defined objective should have 2-4 "
                            f"arguments, got {argc}")
        return grad, hess


class _EvalFunctionWrapper:
    """Adapt feval(y_true, y_pred[, weight[, group]]) -> (name, value,
    is_higher_better) (reference sklearn.py:100-166)."""

    def __init__(self, func):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError(f"Self-defined eval function should have 2-4 "
                        f"arguments, got {argc}")


class LGBMModel:
    """Implementation of the scikit-learn API (reference sklearn.py:169)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Any] = None,
                 class_weight: Optional[Any] = None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 silent: bool = True, importance_type: str = "split",
                 **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = {}
        self._Booster: Optional[Booster] = None
        self._evals_result: Optional[Dict] = None
        self._best_score: Optional[Dict] = None
        self._best_iteration: Optional[int] = None
        self._n_features: Optional[int] = None
        self._classes = None
        self._n_classes: Optional[int] = None
        self._objective = objective
        self._fobj = None
        self.set_params(**kwargs)

    # -- sklearn plumbing ----------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type, "num_leaves": self.num_leaves,
            "max_depth": self.max_depth, "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective, "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample, "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha, "reg_lambda": self.reg_lambda,
            "random_state": self.random_state, "n_jobs": self.n_jobs,
            "silent": self.silent, "importance_type": self.importance_type,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    # -- fitting -------------------------------------------------------
    def _prepare_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        params.pop("importance_type", None)
        params.pop("silent", None)
        params.pop("n_jobs", None)
        obj = params.pop("objective", None)
        if callable(obj):
            self._fobj = _ObjectiveFunctionWrapper(obj)
            params["objective"] = "none"
        else:
            self._fobj = None
            params["objective"] = obj if obj is not None else self._objective
        if params.get("random_state") is None:
            params.pop("random_state", None)
        else:
            params["seed"] = params.pop("random_state")
        params["boosting"] = params.pop("boosting_type")
        params["learning_rate"] = self.learning_rate
        params["min_gain_to_split"] = params.pop("min_split_gain")
        params["min_sum_hessian_in_leaf"] = params.pop("min_child_weight")
        params["min_data_in_leaf"] = params.pop("min_child_samples")
        params["bagging_fraction"] = params.pop("subsample")
        params["bagging_freq"] = params.pop("subsample_freq")
        params["feature_fraction"] = params.pop("colsample_bytree")
        params["lambda_l1"] = params.pop("reg_alpha")
        params["lambda_l2"] = params.pop("reg_lambda")
        params["bin_construct_sample_cnt"] = params.pop("subsample_for_bin")
        return params

    def _class_sample_weight(self, y, sample_weight):
        if self.class_weight is None:
            return sample_weight
        from collections import Counter
        y = np.asarray(y)
        classes = np.unique(y)
        if self.class_weight == "balanced":
            counts = Counter(y.tolist())
            n = len(y)
            cw = {c: n / (len(classes) * counts[c]) for c in classes}
        elif isinstance(self.class_weight, dict):
            cw = {c: self.class_weight.get(c, 1.0) for c in classes}
        else:
            raise ValueError("class_weight must be 'balanced' or a dict")
        w = np.asarray([cw[c] for c in y], np.float64)
        if sample_weight is not None:
            w = w * np.asarray(sample_weight, np.float64)
        return w

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            early_stopping_rounds=None, verbose=False,
            feature_name="auto", categorical_feature="auto",
            callbacks=None, init_model=None) -> "LGBMModel":
        params = self._prepare_params()
        if eval_metric is not None and not callable(eval_metric):
            metrics = eval_metric if isinstance(eval_metric, list) \
                else [eval_metric]
            named = [m for m in metrics if not callable(m)]
            if named:
                params["metric"] = named
        feval = None
        if callable(eval_metric):
            feval = _EvalFunctionWrapper(eval_metric)
        elif isinstance(eval_metric, list):
            fevals = [_EvalFunctionWrapper(m) for m in eval_metric
                      if callable(m)]
            if fevals:
                feval = lambda preds, ds: [f(preds, ds) for f in fevals]  # noqa: E731

        sample_weight = self._class_sample_weight(y, sample_weight)
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params)
        valid_sets: List[Dataset] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vw = (eval_sample_weight[i]
                      if eval_sample_weight is not None else None)
                vg = eval_group[i] if eval_group is not None else None
                vi = (eval_init_score[i]
                      if eval_init_score is not None else None)
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    valid_sets.append(train_set.create_valid(
                        vx, label=vy, weight=vw, group=vg, init_score=vi))

        evals_result: Dict = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=eval_names,
            fobj=self._fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            verbose_eval=verbose, evals_result=evals_result,
            callbacks=callbacks, init_model=init_model)
        self._evals_result = evals_result if evals_result else None
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        # a scipy matrix has no array form: read its shape directly
        self._n_features = (X.shape[1] if hasattr(X, "shape")
                            else np.asarray(X).shape[1])
        return self

    # -- prediction ----------------------------------------------------
    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        if self._Booster is None:
            raise ValueError("Estimator not fitted, call fit first")
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib, **kwargs)

    # -- attributes ----------------------------------------------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise ValueError("No booster found, call fit first")
        return self._Booster

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def best_score_(self):
        return self._best_score

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def n_features_(self) -> int:
        if self._n_features is None:
            raise ValueError("No n_features found, call fit first")
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(self.importance_type)

    @property
    def objective_(self):
        return self._objective


class LGBMRegressor(LGBMModel):
    """LightGBM regressor (reference sklearn.py:733)."""

    def fit(self, X, y, **kwargs):
        if self.objective is None:
            self._objective = "regression"
        return super().fit(X, y, **kwargs)


class LGBMClassifier(LGBMModel):
    """LightGBM classifier (reference sklearn.py:760)."""

    def fit(self, X, y, sample_weight=None, **kwargs):
        y = np.asarray(y)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        self._class_map = {c: i for i, c in enumerate(self._classes)}
        y_enc = np.asarray([self._class_map[v] for v in y], np.float64)
        if self._n_classes > 2:
            if self.objective is None or not callable(self.objective):
                obj = self.objective or "multiclass"
                if obj not in ("multiclass", "multiclassova", "softmax",
                               "multiclass_ova", "ova", "ovr"):
                    obj = "multiclass"
                self._objective = obj
            self._other_params["num_class"] = self._n_classes
        elif self.objective is None:
            self._objective = "binary"
        if kwargs.get("eval_set") is not None:
            es = kwargs["eval_set"]
            if isinstance(es, tuple):
                es = [es]
            kwargs["eval_set"] = [
                (vx, np.asarray([self._class_map[v] for v in np.asarray(vy)],
                                np.float64)) for vx, vy in es]
        return super().fit(X, y_enc, sample_weight=sample_weight, **kwargs)

    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        result = self.predict_proba(X, raw_score=raw_score,
                                    num_iteration=num_iteration,
                                    pred_leaf=pred_leaf,
                                    pred_contrib=pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 2:
            idx = np.argmax(result, axis=1)
        else:
            idx = (result > 0.5).astype(np.int64)
        return self._classes[idx]

    def predict_proba(self, X, raw_score=False, num_iteration=None,
                      pred_leaf=False, pred_contrib=False, **kwargs):
        result = LGBMModel.predict(self, X, raw_score=raw_score,
                                   num_iteration=num_iteration,
                                   pred_leaf=pred_leaf,
                                   pred_contrib=pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes is not None and self._n_classes <= 2 \
                and result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self):
        if self._classes is None:
            raise ValueError("No classes found, call fit first")
        return self._classes

    @property
    def n_classes_(self) -> int:
        if self._n_classes is None:
            raise ValueError("No classes found, call fit first")
        return self._n_classes


class LGBMRanker(LGBMModel):
    """LightGBM ranker (reference sklearn.py:902)."""

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_at=(1, 2, 3, 4, 5), **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if kwargs.get("eval_set") is not None \
                and kwargs.get("eval_group") is None:
            raise ValueError("Eval_group cannot be None when eval_set "
                             "is not None")
        if self.objective is None:
            self._objective = "lambdarank"
        self._other_params["eval_at"] = list(eval_at)
        return super().fit(X, y, sample_weight=sample_weight,
                           init_score=init_score, group=group, **kwargs)
