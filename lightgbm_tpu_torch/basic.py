"""The `Dataset` front end (reference basic.py:712-1040).

The port of the subset of `lightgbm_tpu/basic.py:Dataset` that
`lgb.train` needs: a lazily constructed, binned, dense numeric matrix,
and validation sets binned with a training set's mappers
(`reference=`, `create_valid`).
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
        self.reference = reference
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
        ref_inner = None
        if self.reference is not None:
            # a reference not yet constructed is constructed first
            ref_inner = self.reference.construct()._inner
        names = (None if self.feature_name == "auto"
                 else list(self.feature_name))
        self._inner = TrainingData.from_matrix(
            np.asarray(self.data, dtype=np.float64),
            None if self.label is None else np.asarray(self.label),
            Config(self.params), weight=self.weight,
            init_score=self.init_score,
            reference=ref_inner, feature_names=names)
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params if params is not None else self.params)

    def get_label(self):
        """The f32 labels (what a custom objective reads)."""
        return self.construct()._inner.metadata.label
