"""The `Dataset` front end (reference basic.py:712-1040).

The port of the subset of `lightgbm_tpu/basic.py:Dataset` that
`lgb.train` and `lgb.cv` need: a lazily constructed, binned, dense
numeric matrix, validation sets binned with a training set's mappers
(`reference=`, `create_valid`), the fields (`get_field`, `num_data`)
and row subsets (`subset`, the folds of `cv`), which share the parent's
mappers and slice its binned rows on its device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .io.dataset import Metadata, TrainingData


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

    def get_field(self, name: str):
        """label, weight, group (query boundaries) or init_score."""
        return self.construct()._inner.metadata.get_field(name)

    def get_label(self):
        """The f32 labels (what a custom objective reads)."""
        return self.get_field("label")

    def num_data(self) -> int:
        return self.construct()._inner.num_data

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows `used_indices` as a dataset of their own (the folds
        of `cv`): it shares this dataset's mappers, and its bins are this
        dataset's binned rows, gathered on the device; nothing is binned
        again (lightgbm_tpu/basic.py:317-360)."""
        import torch

        self.construct()
        idx = np.asarray(used_indices, dtype=np.int64)
        src = self._inner
        inner = TrainingData()
        inner.num_data = len(idx)
        inner.num_total_features = src.num_total_features
        inner.used_feature_idx = list(src.used_feature_idx)
        inner.mappers = src.mappers
        inner.device = src.device
        inner.bins_t = src.bins_t.index_select(
            1, torch.as_tensor(idx, device=src.device))
        inner.feature_names = src.feature_names
        inner.config = src.config
        inner.monotone_constraints = src.monotone_constraints
        inner.feature_penalty = src.feature_penalty
        md = src.metadata
        init = md.init_score
        if init is not None:
            init = (init[idx] if init.ndim == 1 and len(init) == md.num_data
                    else init.reshape(md.num_data, -1)[idx].reshape(-1))
        inner.metadata = Metadata(
            len(idx), md.label[idx],
            None if md.weight is None else md.weight[idx], None, init)
        sub = Dataset(None, reference=self, feature_name=self.feature_name,
                      params=params if params else self.params)
        sub._inner = inner
        return sub
