"""The `Dataset` front end (reference basic.py:712-1040).

The port of the subset of `lightgbm_tpu/basic.py:Dataset` that
`lgb.train` needs: a lazily constructed, binned, dense numeric matrix.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .io.dataset import TrainingData


class Dataset:
    """Lazily-constructed binned dataset on the config's device."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 reference: Optional["Dataset"] = None, group=None):
        if reference is not None:
            raise NotImplementedError(
                "Dataset(reference=...) (validation sets) is not ported to "
                "lightgbm_tpu_torch yet")
        if group is not None:
            raise NotImplementedError(
                "Dataset(group=...) (ranking) is not ported to "
                "lightgbm_tpu_torch yet")
        if categorical_feature not in ("auto", None, [], ()):
            raise NotImplementedError(
                "categorical_feature: categorical features are not ported "
                "to lightgbm_tpu_torch yet")
        self.data = data
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.params = dict(params) if params else {}
        self._inner: Optional[TrainingData] = None

    def construct(self) -> "Dataset":
        if self._inner is not None:
            return self
        if isinstance(self.data, str) or hasattr(self.data, "tocsc"):
            raise NotImplementedError(
                "file and sparse Dataset input is not ported to "
                "lightgbm_tpu_torch yet")
        names = (None if self.feature_name == "auto"
                 else list(self.feature_name))
        self._inner = TrainingData.from_matrix(
            np.asarray(self.data, dtype=np.float64),
            None if self.label is None else np.asarray(self.label),
            Config(self.params), weight=self.weight,
            init_score=self.init_score, feature_names=names)
        return self
