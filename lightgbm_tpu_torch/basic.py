"""The `Dataset` front end (reference basic.py:712-1040).

The port of the subset of `lightgbm_tpu/basic.py:Dataset` that
`lgb.train` and `lgb.cv` need: a lazily constructed, binned matrix (a
numpy array, a pandas DataFrame, whose column names become the feature
names, or a scipy CSR/CSC matrix, binned without densifying it:
`TrainingData.from_sparse`), categorical features
(`categorical_feature=` by index or name, `set_categorical_feature`, and
every pandas `category` column, which goes in as its codes, with the
frame's category tables kept as `pandas_categorical` for valid sets and
predict to remap through), validation sets binned with a training set's
mappers (`reference=`, `create_valid`), the query groups
of ranking data (`group=`, `set_group`, `get_group`), the fields
(`get_field`, `set_field`, `num_data`) and row subsets (`subset`, the
folds of `cv`), which share the parent's mappers, slice its binned rows
on its device and keep whole queries.  Object (string) columns are
refused as the JAX package refuses them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .io.dataset import Metadata, TrainingData, _is_scipy_sparse


class Dataset:
    """Lazily-constructed binned dataset on the config's device."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 reference: Optional["Dataset"] = None, group=None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._inner: Optional[TrainingData] = None
        # the category tables of a pandas training frame, one list a
        # category column (None: the data was not a frame); written to the
        # model text as the JAX package writes them
        self.pandas_categorical: Optional[List[List]] = None

    def construct(self) -> "Dataset":
        if self._inner is not None:
            return self
        if isinstance(self.data, str):
            raise NotImplementedError(
                "file Dataset input is not ported to lightgbm_tpu_torch yet")
        ref_inner = None
        if self.reference is not None:
            # a reference not yet constructed is constructed first
            ref_inner = self.reference.construct()._inner
        names = (None if self.feature_name == "auto"
                 else list(self.feature_name))
        pd_cat_idx: List[int] = []
        if _is_pandas_df(self.data):
            # valid sets take the training frame's category tables, so
            # their codes line up with the training bins
            ref_pc = (self.reference.pandas_categorical
                      if self.reference is not None else None)
            X, pd_names, pd_cat_idx, self.pandas_categorical = \
                _pandas_to_matrix(self.data, ref_pc)
            if names is None:
                names = pd_names
        elif _is_scipy_sparse(self.data):
            X = self.data
        else:
            X = np.asarray(self.data, dtype=np.float64)
        cat: List[int] = []
        spec = self.categorical_feature
        if isinstance(spec, (list, tuple)):
            if all(isinstance(c, (int, np.integer)) for c in spec):
                cat = [int(c) for c in spec]
            elif names:
                cat = [names.index(c) for c in spec]
        # pandas category columns are categorical whatever the setting
        cat = sorted(set(cat) | set(pd_cat_idx))
        # sparse input bins in O(nnz) without the [n, F] f64 matrix
        factory = (TrainingData.from_sparse if _is_scipy_sparse(X)
                   else TrainingData.from_matrix)
        self._inner = factory(
            X, None if self.label is None else np.asarray(self.label),
            Config(self.params), weight=self.weight,
            init_score=self.init_score,
            reference=ref_inner, feature_names=names,
            categorical_features=cat, group_sizes=self.group)
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """The categorical columns, by index or name (lightgbm_tpu/basic.py:
        set_categorical_feature): bin types are fixed when the bins are
        found, so a constructed dataset takes no other setting."""
        if self._inner is not None \
                and list(categorical_feature) != list(
                    self.categorical_feature or []):
            raise RuntimeError(
                "cannot change categorical_feature after the dataset is "
                "constructed")
        self.categorical_feature = categorical_feature
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
                      categorical_feature=self.categorical_feature,
                      params=params if params else self.params)
        sub.pandas_categorical = self.pandas_categorical
        sub._inner = inner
        return sub


def _is_pandas_df(data) -> bool:
    import sys

    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(data, pd.DataFrame)


def _pandas_to_matrix(df, pandas_categorical=None, training=True):
    """DataFrame -> (X float64, feature names, category column indices,
    pandas_categorical), as `lightgbm_tpu/basic.py:_pandas_to_matrix`
    converts it: the column names become the feature names, missing values
    NaN, and `category` columns their integer codes (missing and unseen
    values -1, which the categorical bins route like a negative category).
    At training time (`pandas_categorical` None) each category column's
    categories are captured; later (valid sets, predict) the stored tables
    re-index the frame's values, so codes line up with training whatever
    order or content the new frame's categories have.  Object (string)
    columns are refused as the JAX package refuses them."""
    from pandas.api.types import is_numeric_dtype

    names = [str(c) for c in df.columns]
    cat_cols = [i for i in range(len(names))
                if str(df.dtypes.iloc[i]) == "category"]
    bad = [f"{names[i]} ({df.dtypes.iloc[i]})" for i in range(len(names))
           if i not in cat_cols and not is_numeric_dtype(df.iloc[:, i])]
    if bad:
        raise ValueError(
            f"DataFrame columns [{', '.join(bad)}] have non-numeric "
            "(object/string/...) dtype; cast them to 'category' or "
            "numeric before constructing a Dataset")
    if pandas_categorical is None:
        if cat_cols and not training:
            raise ValueError(
                "this model has no stored pandas category tables "
                "(trained on non-pandas data or an old model file); "
                "cannot map the DataFrame's category-dtype columns "
                f"{[names[i] for i in cat_cols]} onto trained bins — "
                "pass integer codes instead")
        pandas_categorical = [list(df.iloc[:, i].cat.categories)
                              for i in cat_cols]
    elif len(pandas_categorical) != len(cat_cols):
        raise ValueError(
            f"train/predict DataFrames disagree on categorical columns: "
            f"model has {len(pandas_categorical)}, data has {len(cat_cols)}")
    X = np.empty((len(df), len(names)), dtype=np.float64)
    ci = 0
    for i in range(len(names)):
        col = df.iloc[:, i]
        if i in cat_cols:
            cats = pandas_categorical[ci]
            ci += 1
            if list(col.cat.categories) != cats:
                # re-index onto the training table by value (unseen -> -1)
                col = col.cat.set_categories(cats)
            X[:, i] = col.cat.codes.to_numpy(dtype=np.float64)
        else:
            X[:, i] = col.to_numpy(dtype=np.float64, na_value=np.nan)
    return X, names, cat_cols, pandas_categorical


def _to_2d_array(data, pandas_categorical=None) -> np.ndarray:
    """The rows to predict as a float64 matrix; a DataFrame goes through
    `_pandas_to_matrix` with the model's category tables."""
    if _is_pandas_df(data):
        return _pandas_to_matrix(data, pandas_categorical,
                                 training=False)[0]
    return np.asarray(data, dtype=np.float64)
