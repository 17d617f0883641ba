"""The `Booster` front end (reference basic.py Booster).

The port of the subset of `lightgbm_tpu/booster.py:Booster` that
`lgb.train`, `lgb.cv` and the callbacks need: update (with custom
gradients), validation sets and evaluation, `best_iteration`/
`best_score` (predict and model text default to the best iteration),
`reset_parameter` of the learning rate, `free_dataset`, predict, and
model-text save and load.  The boosting driver follows `boosting`
(gbdt, goss, dart, rf: `models.create_boosting`).  Rollback is not
ported and raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .config import Config, canonical_name, resolve_device


class Booster:
    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set=None, model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        from .basic import Dataset
        from .models import create_boosting
        from .models.gbdt import GBDT

        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._valid_names: List[str] = []
        self._train_data_name = "training"
        self._train_set = None
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("train_set must be a Dataset")
            if train_set._inner is None:
                # training-level params that shape the dataset (max_bin,
                # device_type, ...) apply before the lazy construction
                train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            self._train_set = train_set
            cfg = Config(self.params)
            self._driver = create_boosting(cfg)
            self._driver.init(cfg, train_set._inner)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self._driver = GBDT.from_model_string(
                model_str, resolve_device(Config(self.params)))
        else:
            raise ValueError("need train_set, model_file or model_str")

    @classmethod
    def _from_driver(cls, driver) -> "Booster":
        self = cls.__new__(cls)
        self.params = {}
        self.best_iteration = -1
        self.best_score = {}
        self._valid_names = []
        self._train_data_name = "training"
        self._train_set = None
        self._driver = driver
        return self

    # ------------------------------------------------------------------
    def add_valid(self, data, name: str) -> "Booster":
        data.construct()
        self._driver.add_valid(data._inner, name)
        self._valid_names.append(name)
        return self

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True once no further splits occur.
        fobj(scores [k, n] f64, train_set) -> (grad, hess) gives custom
        gradients, which train through the sync path."""
        if train_set is not None and train_set is not self._train_set:
            raise NotImplementedError(
                "update(train_set=...) with another dataset is not ported "
                "to lightgbm_tpu_torch yet")
        if fobj is None:
            return self._driver.train_one_iter()
        grad, hess = fobj(self._driver.current_score_for_fobj(),
                          self._train_set)
        return self._driver.train_one_iter(np.asarray(grad, np.float32),
                                           np.asarray(hess, np.float32))

    def rollback_one_iter(self) -> "Booster":
        """Not ported: the rollback of an iteration (and of DART's and
        RF's state with it) waits for a later slice."""
        cfg = self._driver.config
        raise NotImplementedError(
            "Booster.rollback_one_iter (boosting="
            f"{cfg.boosting if cfg is not None else 'gbdt'}) is not ported "
            "to lightgbm_tpu_torch yet")

    def current_iteration(self) -> int:
        return self._driver.current_iteration()

    def num_trees(self) -> int:
        return self._driver.current_iteration() \
            * self._driver.num_tree_per_iteration

    def eval_train(self, feval=None) -> List[Tuple]:
        return self._driver.eval("training", -1, feval=feval)

    def eval_valid(self, feval=None) -> List[Tuple]:
        out: List[Tuple] = []
        for i, name in enumerate(self._valid_names):
            out.extend(self._driver.eval(name, i, feval=feval))
        return out

    def eval(self, data, name: str, feval=None) -> List[Tuple]:
        """Metrics on a dataset built with reference=the training set,
        without registering it as a validation set."""
        data.construct()
        return self._driver.eval_for_data(data._inner, name, feval=feval)

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Take new parameters between iterations; only the learning rate
        is ported (the train step is rebuilt with the new shrinkage)."""
        other = sorted(k for k in params
                       if canonical_name(str(k)) != "learning_rate")
        if other:
            raise NotImplementedError(
                f"reset_parameter({', '.join(other)}=...) is not ported to "
                "lightgbm_tpu_torch yet (ported: learning_rate)")
        self.params.update(params)
        self._driver.reset_config(Config(self.params))
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def free_dataset(self) -> "Booster":
        """Drop the training and validation data (reference
        basic.py:1808): the model stays usable for predict and model
        text, further update()/eval calls need data and fail."""
        self._driver.free_dataset()
        self._train_set = None
        return self

    # ------------------------------------------------------------------
    def _default_iteration(self, num_iteration: Optional[int]) -> int:
        if num_iteration is None:
            return self.best_iteration if self.best_iteration >= 0 else -1
        return int(num_iteration)

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        X = np.asarray(data, dtype=np.float64)
        return self._driver.predict(
            X, self._default_iteration(num_iteration), raw_score=raw_score)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        """The model text, ending, as the JAX package's and the reference
        package's do, with the Python layer's `pandas_categorical:` line
        (always null here: the port takes no pandas frames)."""
        return self._driver.save_model_to_string(
            self._default_iteration(num_iteration),
            start_iteration) + "\npandas_categorical:null\n"
