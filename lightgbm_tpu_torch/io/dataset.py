"""Binned training data: metadata and the dense numeric matrix ingest.

The port of `lightgbm_tpu/io/dataset.py`'s `Metadata` (copied) and of
`TrainingData.from_matrix` for dense numeric matrices.  Bin finding runs
on the host with the copied `BinMapper`; the value->bin step runs as torch
ops on the dataset's device (`ops/binning.py`) and leaves the transposed
`[F, n]` bin matrix there, the layout the grower reads.

A validation set (`reference=` the training data) takes the training
set's mappers, the same objects, and is binned with them on the training
set's device.

`Metadata` carries the query boundaries of ranking data
(`group_sizes`, the `group`/`query` field) and their per-query weights.

Outside this slice, and refused loudly: categorical features, sparse
input and file ingest.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config, resolve_device
from .bin_mapper import BinMapper, BinType, K_ZERO_THRESHOLD


def _parallel_columns(fn, count: int, config: Optional[Config]) -> None:
    """Fan per-column host work out on a thread pool (numpy's sort and
    searchsorted release the GIL).  Every column writes only its own
    slot, so the result does not depend on the schedule."""
    workers = int(getattr(config, "num_threads", 0) or 0) if config else 0
    if workers <= 0:
        workers = os.cpu_count() or 1
    workers = min(workers, count)
    if workers <= 1 or count <= 1:
        for j in range(count):
            fn(j)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(fn, range(count)))


class Metadata:
    """Labels, weights, query boundaries, init scores (reference dataset.h:87)."""

    def __init__(self, num_data: int, label: Optional[np.ndarray] = None,
                 weight: Optional[np.ndarray] = None,
                 group_sizes: Optional[np.ndarray] = None,
                 init_score: Optional[np.ndarray] = None):
        self.num_data = num_data
        self.label = (np.zeros(num_data, dtype=np.float32) if label is None
                      else np.asarray(label, dtype=np.float32))
        self.weight = None if weight is None else np.asarray(weight, dtype=np.float32)
        self.init_score = (None if init_score is None
                           else np.asarray(init_score, dtype=np.float64))
        if group_sizes is not None:
            gs = np.asarray(group_sizes, dtype=np.int64)
            self.query_boundaries = np.concatenate([[0], np.cumsum(gs)]).astype(np.int64)
            if self.query_boundaries[-1] != num_data:
                raise ValueError(
                    f"sum of query sizes ({self.query_boundaries[-1]}) != num_data ({num_data})")
        else:
            self.query_boundaries = None

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1

    def query_weights(self) -> Optional[np.ndarray]:
        """Per-query weight = mean of row weights inside the query; None when
        rows are unweighted (reference src/io/metadata.cpp:461-470)."""
        if self.query_boundaries is None or self.weight is None:
            return None
        w = np.asarray(self.weight, np.float64)
        sums = np.add.reduceat(w, self.query_boundaries[:-1])
        return sums / np.diff(self.query_boundaries)

    def set_field(self, name: str, data: Optional[np.ndarray]) -> None:
        if name == "label":
            self.label = np.asarray(data, dtype=np.float32)
        elif name == "weight":
            self.weight = None if data is None else np.asarray(data, dtype=np.float32)
        elif name in ("group", "query"):
            if data is None:
                self.query_boundaries = None
            else:
                gs = np.asarray(data, dtype=np.int64)
                self.query_boundaries = np.concatenate([[0], np.cumsum(gs)]).astype(np.int64)
        elif name == "init_score":
            self.init_score = None if data is None else np.asarray(data, dtype=np.float64)
        else:
            raise ValueError(f"unknown field {name}")

    def get_field(self, name: str) -> Optional[np.ndarray]:
        if name == "label":
            return self.label
        if name == "weight":
            return self.weight
        if name in ("group", "query"):
            return self.query_boundaries
        if name == "init_score":
            return self.init_score
        raise ValueError(f"unknown field {name}")


def _parse_column_spec(spec: str, feature_names: List[str]) -> List[int]:
    """Parse '0,1,2' or 'name:a,b,c' into column indices."""
    if not spec:
        return []
    s = str(spec)
    if s.startswith("name:"):
        names = [x.strip() for x in s[5:].split(",") if x.strip()]
        return [feature_names.index(n) for n in names if n in feature_names]
    return [int(x) for x in s.replace(";", ",").split(",") if x != ""]


class TrainingData:
    """Binned dataset + metadata: the unit the tree learner consumes.

    `bins_t` is the device-resident transposed `[F_used, n]` bin matrix
    (uint8 when every feature has at most 256 bins, else int32)."""

    def __init__(self) -> None:
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.used_feature_idx: List[int] = []     # used col -> original col
        self.mappers: List[BinMapper] = []        # one per ORIGINAL column
        self.bins_t = None                        # torch [F_used, n]
        self.device = None
        self.metadata: Optional[Metadata] = None
        self.feature_names: List[str] = []
        self.config: Optional[Config] = None
        self.monotone_constraints: Optional[np.ndarray] = None
        self.feature_penalty: Optional[np.ndarray] = None

    @property
    def bins(self) -> np.ndarray:
        """Host `[n, F_used]` copy of the bin matrix (tests and host
        consumers; the training path reads `bins_t` on the device)."""
        return self.bins_t.T.cpu().numpy()

    @property
    def num_features(self) -> int:
        return len(self.used_feature_idx)

    @property
    def max_num_bin(self) -> int:
        if not self.used_feature_idx:
            return 1
        return max(self.mappers[i].num_bin for i in self.used_feature_idx)

    def feature_arrays(self) -> Dict[str, np.ndarray]:
        """Per-used-feature static arrays consumed by the grower."""
        idx = self.used_feature_idx
        num_bin = np.array([self.mappers[i].num_bin for i in idx], dtype=np.int32)
        missing = np.array([int(self.mappers[i].missing_type) for i in idx],
                           dtype=np.int32)
        default_bin = np.array([self.mappers[i].default_bin for i in idx],
                               dtype=np.int32)
        mono = (self.monotone_constraints if self.monotone_constraints is not None
                else np.zeros(len(idx), dtype=np.int32))
        penalty = (self.feature_penalty if self.feature_penalty is not None
                   else np.ones(len(idx), dtype=np.float32))
        return {"num_bin": num_bin, "missing_type": missing,
                "default_bin": default_bin,
                "monotone": mono.astype(np.int32),
                "penalty": penalty.astype(np.float32)}

    def column_zero_fraction(self) -> np.ndarray:
        """Per-used-column fraction of rows at bin 0 (the EFB candidate
        gate), reduced on the device."""
        import torch

        cnt = (self.bins_t == 0).sum(dim=1, dtype=torch.int64).cpu().numpy()
        return cnt.astype(np.float64) / max(self.num_data, 1)

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix(cls, X: np.ndarray, label: Optional[np.ndarray] = None,
                    config: Optional[Config] = None,
                    weight: Optional[np.ndarray] = None,
                    init_score: Optional[np.ndarray] = None,
                    reference: Optional["TrainingData"] = None,
                    feature_names: Optional[List[str]] = None,
                    categorical_features: Optional[Sequence[int]] = None,
                    group_sizes: Optional[np.ndarray] = None,
                    ) -> "TrainingData":
        """Bin a raw dense float matrix on the config's device.

        With `reference` given, reuses its BinMappers and its device
        (validation-set alignment, reference dataset.h:501 CreateValid)."""
        from ..ops.binning import bin_matrix_t

        config = config or Config()
        if categorical_features or str(config.categorical_feature):
            raise NotImplementedError(
                "categorical_feature: categorical features are not ported "
                "to lightgbm_tpu_torch yet")
        device = (reference.device if reference is not None
                  else resolve_device(config))
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2:
            raise ValueError("X must be 2-D")
        n, nf = X.shape
        self = cls()
        self.config = config
        self.device = device
        self.num_data = n
        self.num_total_features = nf
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(nf)])
        if reference is not None:
            self._adopt_reference_mappers(reference)
        else:
            self._find_mappers(X, config)
        self.bins_t = bin_matrix_t(X, self.mappers, self.used_feature_idx,
                                   device, int(config.tpu_ingest_chunk_rows))
        self.metadata = Metadata(n, label, weight, group_sizes, init_score)
        self._set_constraints(config)
        return self

    def _adopt_reference_mappers(self, reference: "TrainingData") -> None:
        """Share the reference's BinMappers for validation-set alignment
        (reference dataset.h:501 CreateValid)."""
        self.mappers = reference.mappers
        self.used_feature_idx = list(reference.used_feature_idx)
        self.monotone_constraints = reference.monotone_constraints
        self.feature_penalty = reference.feature_penalty
        if reference.num_total_features != self.num_total_features:
            raise ValueError("validation data feature count mismatch")

    def create_valid(self, X, label: Optional[np.ndarray] = None,
                     **kw) -> "TrainingData":
        return TrainingData.from_matrix(X, label, self.config,
                                        reference=self, **kw)

    def _find_mappers(self, X: np.ndarray, config: Config) -> None:
        """Greedy bin finding per column on a row sample, as the JAX
        package does it (reference dataset_loader.cpp:599-600,696)."""
        n, nf = X.shape
        sample_cnt = min(n, int(config.bin_construct_sample_cnt))
        if sample_cnt < n:
            rng = np.random.default_rng(int(config.data_random_seed))
            sample_idx = np.sort(rng.choice(n, size=sample_cnt, replace=False))
            Xs = X[sample_idx]
        else:
            Xs = X
        total = Xs.shape[0]
        ignore = set(_parse_column_spec(config.ignore_column,
                                        self.feature_names))
        max_bin_by_feature = list(config.max_bin_by_feature)
        # near-unsplittable feature filter (dataset_loader.cpp:599-600)
        filter_cnt = int(float(config.min_data_in_leaf) * total / n)
        self.mappers = [BinMapper() for _ in range(nf)]

        def _find_col(col: int) -> None:
            m = self.mappers[col]
            if col in ignore:
                m.num_bin = 1
                m.is_trivial = True
                return
            colv = Xs[:, col]
            nonzero = colv[~((np.abs(colv) <= K_ZERO_THRESHOLD)
                             & ~np.isnan(colv))]
            mb = int(config.max_bin)
            if max_bin_by_feature and col < len(max_bin_by_feature):
                mb = int(max_bin_by_feature[col])
            m.find_bin(nonzero, total, mb,
                       min_data_in_bin=int(config.min_data_in_bin),
                       min_split_data=filter_cnt,
                       bin_type=BinType.NUMERICAL,
                       use_missing=bool(config.use_missing),
                       zero_as_missing=bool(config.zero_as_missing))

        _parallel_columns(_find_col, nf, config)
        self.used_feature_idx = [c for c in range(nf)
                                 if not self.mappers[c].is_trivial]

    def _set_constraints(self, config: Config) -> None:
        mono = list(config.monotone_constraints)
        if mono:
            self.monotone_constraints = np.array(
                [mono[c] if c < len(mono) else 0 for c in self.used_feature_idx],
                dtype=np.int32)
        contri = list(config.feature_contri)
        if contri:
            self.feature_penalty = np.array(
                [contri[c] if c < len(contri) else 1.0
                 for c in self.used_feature_idx], dtype=np.float32)
