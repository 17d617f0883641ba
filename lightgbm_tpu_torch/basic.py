"""The `Dataset` front end (reference basic.py:712-1040).

The port of `lightgbm_tpu/basic.py:Dataset`: a lazily constructed,
binned matrix (a numpy array, a pandas DataFrame, whose column names
become the feature names, a scipy CSR/CSC matrix, binned without
densifying it: `TrainingData.from_sparse`, or the path of a CSV, TSV or
LibSVM file, `TrainingData.from_file`, with its binary cache:
`save_binary`), categorical features
(`categorical_feature=` by index or name, `set_categorical_feature`, and
every pandas `category` column, which goes in as its codes, with the
frame's category tables kept as `pandas_categorical` for valid sets and
predict to remap through), validation sets binned with a training set's
mappers (`reference=`, `create_valid`), the query groups
of ranking data (`group=`, `set_group`, `get_group`), the fields
(`get_field`, `set_field`, `num_data`) and row subsets (`subset`, the
folds of `cv`), which share the parent's mappers, slice its binned rows
on its device and keep whole queries.  Object (string) columns are
refused as the JAX package refuses them.  The rest of the JAX package's
surface: the setters and getters of the metadata (`set_label`,
`set_weight`, `set_init_score`, `get_weight`, `get_init_score`; a
constructed dataset's `Metadata` is written through), `set_reference`,
`set_feature_name`, `get_data`, `num_feature`, `get_feature_penalty`,
`get_monotone_constraints`, `get_ref_chain` and `add_features_from`
(the other dataset's columns appended: mappers on the host, bins on the
device).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .io.dataset import Metadata, TrainingData, _is_scipy_sparse
from .utils.log import LightGBMError, Log


class Dataset:
    """Lazily-constructed binned dataset on the config's device."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 reference: Optional["Dataset"] = None, group=None,
                 free_raw_data: bool = True, silent: bool = False):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self.free_raw_data = free_raw_data
        self._inner: Optional[TrainingData] = None
        # the rows of the parent a subset() took (get_data's map back)
        self.used_indices: Optional[np.ndarray] = None
        # the category tables of a pandas training frame, one list a
        # category column (None: the data was not a frame); written to the
        # model text as the JAX package writes them
        self.pandas_categorical: Optional[List[List]] = None

    def construct(self) -> "Dataset":
        if self._inner is not None:
            return self
        cfg = Config(self.params)
        if bool(cfg.two_round) and not isinstance(self.data, str):
            # two_round is a way of reading a file; in-memory data has
            # nothing to read twice
            Log.warning("two_round=true ignored for in-memory data")
        ref_inner = None
        if self.reference is not None:
            # a reference not yet constructed is constructed first
            ref_inner = self.reference.construct()._inner
        if isinstance(self.data, str):
            self._inner = TrainingData.from_file(self.data, cfg,
                                                 reference=ref_inner)
            md = self._inner.metadata
            # arguments given to the Dataset win over the side-car files
            if self.label is not None:
                md.set_field("label", self.label)
            if self.group is not None and md.query_boundaries is None:
                md.set_field("group", np.asarray(self.group))
            if self.weight is not None and md.weight is None:
                md.set_field("weight", np.asarray(self.weight))
            return self
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
            cfg, weight=self.weight,
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

    def save_binary(self, filename: str) -> "Dataset":
        """Write the constructed bins, mappers and metadata as a binary
        cache (`TrainingData.save_binary`): a `<data>.bin` beside a data
        file is loaded in place of parsing it."""
        self.construct()
        self._inner.save_binary(filename)
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin this (not yet constructed) dataset with `reference`'s
        mappers."""
        if self._inner is not None and self.reference is not reference:
            raise RuntimeError(
                "cannot change reference after the dataset is constructed")
        self.reference = reference
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        """The feature names, one a column ("auto": Column_i)."""
        if feature_name == "auto":
            self.feature_name = feature_name
            return self
        names = list(feature_name)
        if self._inner is not None:
            if len(names) != self._inner.num_total_features:
                raise ValueError(
                    f"{len(names)} names for "
                    f"{self._inner.num_total_features} features")
            self._inner.feature_names = list(names)
        self.feature_name = names
        return self

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._inner is not None:
            self._inner.metadata.set_field("label", label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.set_field("weight", weight)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.set_field("init_score", init_score)
        return self

    def get_weight(self):
        return self.get_field("weight")

    def get_init_score(self):
        return self.get_field("init_score")

    def get_data(self):
        """The raw data this dataset was built from.  A subset's rows are
        its parent's, taken by `used_indices` through every level of a
        subset-of-subset chain; where no parent holds raw data it
        raises, as lightgbm_tpu/basic.py:get_data does."""
        freed = LightGBMError(
            "Cannot call `get_data` after freed raw data, set "
            "free_raw_data=False when construct Dataset to avoid this.")
        if self.data is not None or self.used_indices is None:
            if self.data is None and self._inner is not None:
                raise freed
            return self.data
        idx = np.asarray(self.used_indices)
        parent = self.reference
        while parent is not None and parent.data is None \
                and parent.used_indices is not None \
                and parent.reference is not None:
            idx = np.asarray(parent.used_indices)[idx]
            parent = parent.reference
        if parent is None or parent.data is None:
            raise freed
        pdata = parent.data
        if _is_pandas_df(pdata):
            return pdata.iloc[idx]
        if isinstance(pdata, (list, tuple)):
            pdata = np.asarray(pdata, dtype=np.float64)
        return pdata[idx]

    def get_feature_penalty(self):
        """The split penalty of each used feature (feature_contri), or
        None."""
        self.construct()
        return self._inner.feature_penalty

    def get_monotone_constraints(self):
        """The monotone constraint of each used feature, or None."""
        self.construct()
        return self._inner.monotone_constraints

    def get_ref_chain(self, ref_limit: int = 100):
        """The datasets reachable through `reference` links, this one
        included."""
        head = self
        ref_chain = set()
        while len(ref_chain) < ref_limit and isinstance(head, Dataset):
            ref_chain.add(head)
            if head.reference is None or head.reference in ref_chain:
                break
            head = head.reference
        return ref_chain

    def num_feature(self) -> int:
        """The columns of the data, used or not."""
        return self.construct()._inner.num_total_features

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append `other`'s columns after this dataset's (reference
        Dataset::AddFeaturesFrom, c_api.h:297): both are constructed and
        must have the same rows; `other`'s mappers, names and per-feature
        metadata follow this dataset's, and its bins are appended on the
        device (int32 when either side is)."""
        import torch

        self.construct()
        other.construct()
        ia, ib = self._inner, other._inner
        if ia.num_data != ib.num_data:
            raise ValueError("datasets have different row counts")
        na = ia.num_total_features
        n_used_a = len(ia.used_feature_idx)
        n_used_b = len(ib.used_feature_idx)
        dtype = (torch.uint8 if ia.bins_t.dtype == ib.bins_t.dtype
                 == torch.uint8 else torch.int32)
        ia.bins_t = torch.cat([ia.bins_t.to(dtype),
                               ib.bins_t.to(device=ia.device, dtype=dtype)])
        ia.used_feature_idx = list(ia.used_feature_idx) + \
            [na + c for c in ib.used_feature_idx]
        ia.mappers = list(ia.mappers) + list(ib.mappers)
        ia.feature_names = list(ia.feature_names) + list(ib.feature_names)
        ia.num_total_features = na + ib.num_total_features

        def merge_per_used(attr, dtype, fill):
            va, vb = getattr(ia, attr), getattr(ib, attr)
            if va is None and vb is None:
                return
            if va is None:
                va = np.full(n_used_a, fill, dtype)
            if vb is None:
                vb = np.full(n_used_b, fill, dtype)
            setattr(ia, attr, np.concatenate([va, vb]))

        merge_per_used("monotone_constraints", np.int32, 0)
        merge_per_used("feature_penalty", np.float32, 1.0)
        # the category tables follow the category columns in order, and
        # every column of this dataset comes before other's
        if self.pandas_categorical or other.pandas_categorical:
            self.pandas_categorical = ((self.pandas_categorical or [])
                                       + (other.pandas_categorical or []))
        return self

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
        sub.used_indices = idx
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
