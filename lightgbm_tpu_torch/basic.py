"""The `Dataset` front end (reference basic.py:712-1040).

The port of the subset of `lightgbm_tpu/basic.py:Dataset` that
`lgb.train` and `lgb.cv` need: a lazily constructed, binned, dense
numeric matrix (a numpy array or a numeric pandas DataFrame, whose
column names become the feature names), validation sets binned with a
training set's mappers (`reference=`, `create_valid`), the query groups
of ranking data (`group=`, `set_group`, `get_group`), the fields
(`get_field`, `set_field`, `num_data`) and row subsets (`subset`, the
folds of `cv`), which share the parent's mappers, slice its binned rows
on its device and keep whole queries.  pandas `category` columns wait
for the categorical port and are refused by name.
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
        if categorical_feature not in ("auto", None, [], ()):
            raise NotImplementedError(
                "categorical_feature: categorical features are not ported "
                "to lightgbm_tpu_torch yet")
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.params = dict(params) if params else {}
        self._inner: Optional[TrainingData] = None
        # the category tables of a pandas training frame: always empty
        # here (category columns are refused), written to the model text
        # as the JAX package writes them
        self.pandas_categorical: Optional[List[List]] = None

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
        if _is_pandas_df(self.data):
            X, pd_names, self.pandas_categorical = _pandas_to_matrix(
                self.data)
            if names is None:
                names = pd_names
        else:
            X = np.asarray(self.data, dtype=np.float64)
        self._inner = TrainingData.from_matrix(
            X, None if self.label is None else np.asarray(self.label),
            Config(self.params), weight=self.weight,
            init_score=self.init_score,
            reference=ref_inner, feature_names=names,
            group_sizes=self.group)
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

    def set_field(self, name: str, data) -> "Dataset":
        self.construct()._inner.metadata.set_field(name, data)
        return self

    def get_label(self):
        """The f32 labels (what a custom objective reads)."""
        return self.get_field("label")

    def set_group(self, group) -> "Dataset":
        """The query sizes of ranking data (rows of a query consecutive)."""
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_field("group", group)
        return self

    def get_group(self):
        """The query sizes, or None."""
        b = self.get_field("group")
        return None if b is None else np.diff(b)

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
        group_sizes = None
        if md.query_boundaries is not None:
            # whole queries only (cv's group folds take them so): each
            # query's size is the run length of its id over the rows
            qid = np.searchsorted(md.query_boundaries, idx, side="right") - 1
            if np.any(np.diff(qid) < 0):
                raise ValueError("subset indices must be sorted for grouped "
                                 "data")
            change = np.flatnonzero(np.diff(qid)) + 1
            group_sizes = np.diff(np.concatenate([[0], change, [len(idx)]]))
        inner.metadata = Metadata(
            len(idx), md.label[idx],
            None if md.weight is None else md.weight[idx], group_sizes, init)
        sub = Dataset(None, reference=self, feature_name=self.feature_name,
                      params=params if params else self.params)
        sub.pandas_categorical = self.pandas_categorical
        sub._inner = inner
        return sub


def _is_pandas_df(data) -> bool:
    import sys

    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(data, pd.DataFrame)


def _pandas_to_matrix(df):
    """A numeric DataFrame -> (X float64, feature names, pandas
    categorical tables), as `lightgbm_tpu/basic.py:_pandas_to_matrix`
    converts it: the column names become the feature names, missing
    values NaN, and object (string) columns are refused as the JAX
    package refuses them.  `category` columns are refused by name until
    categorical features are ported; the tables are then `[]`, which is
    what the JAX package writes for a frame without such columns."""
    from pandas.api.types import is_numeric_dtype

    names = [str(c) for c in df.columns]
    cat_cols = [names[i] for i in range(len(names))
                if str(df.dtypes.iloc[i]) == "category"]
    if cat_cols:
        raise NotImplementedError(
            f"pandas category columns {cat_cols} (categorical features) "
            "are not ported to lightgbm_tpu_torch yet")
    bad = [f"{names[i]} ({df.dtypes.iloc[i]})" for i in range(len(names))
           if not is_numeric_dtype(df.iloc[:, i])]
    if bad:
        raise ValueError(
            f"DataFrame columns [{', '.join(bad)}] have non-numeric "
            "(object/string/...) dtype; cast them to 'category' or "
            "numeric before constructing a Dataset")
    X = np.empty((len(df), len(names)), dtype=np.float64)
    for i in range(len(names)):
        X[:, i] = df.iloc[:, i].to_numpy(dtype=np.float64, na_value=np.nan)
    return X, names, []


def _to_2d_array(data) -> np.ndarray:
    """The rows to predict as a float64 matrix; a DataFrame goes through
    `_pandas_to_matrix`, with its refusals."""
    if _is_pandas_df(data):
        return _pandas_to_matrix(data)[0]
    return np.asarray(data, dtype=np.float64)
