"""The `Booster` front end (reference basic.py Booster).

The port of the subset of `lightgbm_tpu/booster.py:Booster` that
`lgb.train(params, ds, num_boost_round)` and `booster.predict(X)` need,
plus model-text save and load.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .config import Config, resolve_device


class Booster:
    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set=None, model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        from .basic import Dataset
        from .models.gbdt import GBDT

        self.params = dict(params) if params else {}
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
            self._driver = GBDT()
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
        self._train_set = None
        self._driver = driver
        return self

    def update(self) -> bool:
        """One boosting iteration; True once no further splits occur."""
        return self._driver.train_one_iter()

    def current_iteration(self) -> int:
        return self._driver.current_iteration()

    def num_trees(self) -> int:
        return self._driver.current_iteration() \
            * self._driver.num_tree_per_iteration

    def eval_train(self) -> List[Tuple]:
        return [("training", name, val, hib)
                for name, val, hib in self._driver.eval_train()]

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        X = np.asarray(data, dtype=np.float64)
        return self._driver.predict(
            X, -1 if num_iteration is None else int(num_iteration),
            raw_score=raw_score)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        """The model text, ending, as the JAX package's and the reference
        package's do, with the Python layer's `pandas_categorical:` line
        (always null here: the port takes no pandas frames)."""
        return self._driver.save_model_to_string(
            -1 if num_iteration is None else int(num_iteration),
            start_iteration) + "\npandas_categorical:null\n"
