"""Binned training data: metadata and the dense numeric matrix ingest.

The port of `lightgbm_tpu/io/dataset.py`'s `Metadata` (copied) and of
`TrainingData.from_matrix` for dense matrices, with categorical features
(`categorical_features`, column indices: their mappers bin categories by
count, reference bin.cpp:425-497).  Bin finding runs on the host with the
copied `BinMapper`; the value->bin step runs as torch ops on the
dataset's device (`ops/binning.py`) and leaves the transposed `[F, n]`
bin matrix there, the layout the grower reads.

A scipy CSR/CSC matrix goes through `TrainingData.from_sparse`, the
port of the JAX package's: bin finding reads each column's stored values
off the CSC arrays, and binning fills one column at a time on the host
(its zero bin, then the stored values' bins), so the `[n, F]` f64 matrix
is never made.  The bins then go to the device as for dense input.

A validation set (`reference=` the training data) takes the training
set's mappers, the same objects, and is binned with them on the training
set's device; a sparse one through `from_sparse`.

`Metadata` carries the query boundaries of ranking data
(`group_sizes`, the `group`/`query` field) and their per-query weights.

A text file (CSV, TSV, LibSVM, `io/parser.py`) goes through `from_file`,
the port of the JAX package's: a `<path>.bin` binary cache beside it is
loaded instead (`from_binary`); else the file is parsed whole and binned
as a matrix, or with `two_round` read twice in chunks (pass 1 samples
rows by algorithm R for bin finding, pass 2 bins chunk by chunk on the
device, so the `[n, F]` f64 matrix is never held).  The parameters
`categorical_feature`, `ignore_column`, `label_column`, `header` and
`forcedbins_filename` are read on this path; `save_binary` writes the
cache in the JAX package's layout and token, so either package loads the
other's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import obs
from ..config import Config, resolve_device
from ..utils import timer
from .bin_mapper import BinMapper, BinType, K_ZERO_THRESHOLD
from .parser import (NoStreamingReader, TextChunkReader, load_sidecars,
                     load_text_file)


@contextlib.contextmanager
def _ingest_phase(data: "TrainingData", name: str):
    """`timer.PHASE(name)` around an ingest step (a span under
    tpu_telemetry=trace; "binning" is the ingest memory watermark), its
    wall kept in ``data.ingest_s[name]`` whatever the telemetry mode."""
    t0 = time.perf_counter()
    with timer.PHASE(name):
        yield
    data.ingest_s[name] = time.perf_counter() - t0


def _is_scipy_sparse(data) -> bool:
    """scipy.sparse matrix/array, detected without importing scipy."""
    return hasattr(data, "tocsc") and hasattr(data, "nnz")


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


def _load_forced_bins(config: Config) -> Dict[int, List[float]]:
    """forcedbins_filename's JSON, [{"feature": i, "bin_upper_bound":
    [...]}] -> {feature: bounds} (reference dataset_loader.cpp:1246
    GetForcedBins)."""
    path = config.forcedbins_filename
    if not path:
        return {}
    import json

    with open(path) as f:
        entries = json.load(f)
    return {int(e["feature"]): [float(x) for x in e["bin_upper_bound"]]
            for e in entries}


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
        # host seconds of the ingest phases of from_sparse and from_file:
        # "parse" (reading the text), "sketch" (bin finding) and
        # "binning" (the bins made on or sent to the device); "binary"
        # (a cache load) and "two_round" (1.0) also mark the loader
        self.ingest_s: Dict[str, float] = {}
        # bytes of the largest binning chunk's device tensors
        # (ops/binning.py:bin_chunks_t), None where the bins were not
        # made on the device in chunks (host binning, a cache load)
        self.ingest_scratch_bytes: Optional[int] = None

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
        is_categorical = np.array(
            [self.mappers[i].bin_type == BinType.CATEGORICAL for i in idx],
            dtype=bool)
        mono = (self.monotone_constraints if self.monotone_constraints is not None
                else np.zeros(len(idx), dtype=np.int32))
        penalty = (self.feature_penalty if self.feature_penalty is not None
                   else np.ones(len(idx), dtype=np.float32))
        return {"num_bin": num_bin, "missing_type": missing,
                "default_bin": default_bin, "is_categorical": is_categorical,
                "monotone": mono.astype(np.int32),
                "penalty": penalty.astype(np.float32)}

    def column_zero_fraction(self) -> np.ndarray:
        """Per-used-column fraction of rows at bin 0 (the EFB candidate
        gate), reduced on the device."""
        import torch

        cnt = (self.bins_t == 0).sum(dim=1, dtype=torch.int64).cpu().numpy()
        return cnt.astype(np.float64) / max(self.num_data, 1)

    def column_nonzero_counts(self, zero_bins: np.ndarray) -> np.ndarray:
        """Per-used-column count of rows off that column's zero bin (the
        sparse-storage gate), reduced on the device in column blocks that
        bound the boolean temporary."""
        import torch

        zb = torch.as_tensor(np.asarray(zero_bins),
                             device=self.bins_t.device).to(self.bins_t.dtype)
        F, n = self.bins_t.shape
        step = max((1 << 26) // max(n, 1), 1)
        out = [(self.bins_t[lo:lo + step] != zb[lo:lo + step, None])
               .sum(dim=1) for lo in range(0, F, step)]
        return torch.cat(out).cpu().numpy().astype(np.int64)

    def strided_row_sample(self, quota: int) -> np.ndarray:
        """The deterministic strided row sample `bundling._stride_sample`
        takes, as a host `[rows, F]` array: a strided slice of the device
        matrix, so EFB planning never fetches the whole matrix."""
        n = self.num_data
        cols = self.bins_t
        if n > quota:
            cols = cols[:, ::n // quota][:, :quota]
        return cols.T.cpu().numpy()

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
                    forced_bins: Optional[Dict[int, List[float]]] = None,
                    ) -> "TrainingData":
        """Bin a raw dense float matrix on the config's device.

        With `reference` given, reuses its BinMappers and its device
        (validation-set alignment, reference dataset.h:501 CreateValid).
        `categorical_features` are column indices; as in the JAX package,
        the `categorical_feature` parameter is read only by file ingest."""
        from ..ops.binning import bin_matrix_t

        config = config or Config()
        # the telemetry policy before the ingest phases run: the training
        # set is made before the GBDT, and its sketch and binning spans
        # must not be lost (lightgbm_tpu/io/dataset.py:300-306)
        obs.configure_from_config(config)
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
        with _ingest_phase(self, "sketch"):
            if reference is not None:
                self._adopt_reference_mappers(reference)
            else:
                self._find_mappers_maybe_distributed(
                    X, config, categorical_features or [], forced_bins)
        scratch = {"chunk_bytes": 0}
        with _ingest_phase(self, "binning"):
            self.bins_t = bin_matrix_t(
                X, self.mappers, self.used_feature_idx, device,
                int(config.tpu_ingest_chunk_rows), scratch)
        self.ingest_scratch_bytes = scratch["chunk_bytes"]
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

    @classmethod
    def from_sparse(cls, sp, label: Optional[np.ndarray] = None,
                    config: Optional[Config] = None,
                    weight: Optional[np.ndarray] = None,
                    init_score: Optional[np.ndarray] = None,
                    reference: Optional["TrainingData"] = None,
                    feature_names: Optional[List[str]] = None,
                    categorical_features: Optional[Sequence[int]] = None,
                    group_sizes: Optional[np.ndarray] = None,
                    ) -> "TrainingData":
        """Bin a scipy CSR/CSC matrix in O(nnz) host memory beside the
        bins (lightgbm_tpu/io/dataset.py:from_sparse).

        Bin finding reads the stored values off the CSC arrays; binning
        fills each column with its zero-value bin (`default_bin`, which
        is `value_to_bin(0.0)`) and puts the bins of the column's stored
        values over it.  Stored zeros and NaNs bin as the values they
        are.  The `[F, n]` bins then go to the device."""
        import torch

        config = config or Config()
        device = (reference.device if reference is not None
                  else resolve_device(config))
        self = cls()
        with _ingest_phase(self, "sketch"):
            sp = sp.tocsc()
            # duplicate coordinates must add up, as scipy's own toarray()
            # adds them, not let the last one win in the bin scatter
            sp.sum_duplicates()
            n, nf = sp.shape
            self.config = config
            self.device = device
            self.num_data = n
            self.num_total_features = nf
            self.feature_names = (list(feature_names) if feature_names
                                  else [f"Column_{i}" for i in range(nf)])
            if reference is not None:
                self._adopt_reference_mappers(reference)
            else:
                self._find_mappers_maybe_distributed(
                    sp, config, categorical_features or [])
        with _ingest_phase(self, "binning"):
            dtype = np.uint8 if self.max_num_bin <= 256 else np.int32
            bins = np.empty((self.num_features, n), dtype=dtype)
            indptr, indices, data = sp.indptr, sp.indices, sp.data
            for j, col in enumerate(self.used_feature_idx):
                m = self.mappers[col]
                lo, hi = int(indptr[col]), int(indptr[col + 1])
                bins[j] = m.default_bin
                if hi > lo:
                    vals = np.asarray(data[lo:hi], dtype=np.float64)
                    bins[j, indices[lo:hi]] = \
                        m.values_to_bins(vals).astype(dtype)
            self.bins_t = torch.from_numpy(bins).to(device)
        self.metadata = Metadata(n, label, weight, group_sizes, init_score)
        self._set_constraints(config)
        return self

    @classmethod
    def from_file(cls, path: str, config: Optional[Config] = None,
                  reference: Optional["TrainingData"] = None
                  ) -> "TrainingData":
        """A text data file, binned (lightgbm_tpu/io/dataset.py:from_file):
        a `<path>.bin` cache beside it is loaded instead of parsing (not
        for a validation set, which must take its reference's mappers);
        `two_round` reads the file twice in chunks; `save_binary` writes
        the cache after the load."""
        import zipfile

        from ..utils.log import Log
        from .distributed_binning import (config_wants_distributed,
                                          ensure_distributed)

        config = config or Config()
        obs.configure_from_config(config)
        # the rendezvous before anything else; a binary cache present on
        # one host only must not let that host skip the collective bin
        # finding its peers enter (lightgbm_tpu/io/dataset.py:454-460)
        ensure_distributed(config)
        skip_cache = config_wants_distributed(config)
        if reference is None and not skip_cache \
                and os.path.exists(path + ".bin"):
            try:
                return cls.from_binary(path + ".bin", config)
            except (OSError, ValueError, KeyError,
                    zipfile.BadZipFile) as exc:
                Log.warning(f"ignoring stale binary cache {path}.bin: {exc}")
        if bool(config.two_round):
            try:
                data = cls._from_file_two_round(path, config, reference)
            except NoStreamingReader as exc:  # libsvm
                Log.warning(f"two_round fell back to one-pass load: {exc}")
            else:
                if bool(config.save_binary):
                    data.save_binary(path + ".bin")
                return data
        t0 = time.perf_counter()
        X, y, w, group, init, names = load_text_file(
            path, label_column=config.label_column,
            header=True if config.header else None)
        parse_s = time.perf_counter() - t0
        cat = _parse_column_spec(config.categorical_feature, names)
        data = cls.from_matrix(X, y, config, weight=w, group_sizes=group,
                               init_score=init, reference=reference,
                               feature_names=names, categorical_features=cat,
                               forced_bins=_load_forced_bins(config))
        data.ingest_s["parse"] = parse_s
        if bool(config.save_binary):
            data.save_binary(path + ".bin")
        return data

    @classmethod
    def _from_file_two_round(cls, path: str, config: Config,
                             reference: Optional["TrainingData"],
                             chunk_rows: int = 200_000) -> "TrainingData":
        """Two passes over the file in chunks of `chunk_rows` rows
        (lightgbm_tpu/io/dataset.py:_from_file_two_round; reference
        dataset_loader.cpp:188-216).  Pass 1 counts the rows, keeps the
        labels and draws `bin_construct_sample_cnt` of them by algorithm
        R with `np.random.default_rng(data_random_seed)`, as the JAX
        package draws them, for bin finding; pass 2 bins each chunk on
        the device into the `[F, n]` matrix.  The raw f64 matrix is never
        held, only one chunk of it."""
        from ..ops.binning import bin_chunks_t

        t0 = time.perf_counter()
        reader = TextChunkReader(path, label_column=config.label_column,
                                 header=True if config.header else None,
                                 chunk_rows=chunk_rows)
        names = reader.feature_names
        sample_cnt = max(int(config.bin_construct_sample_cnt), 2)
        rng = np.random.default_rng(int(config.data_random_seed))
        n = 0
        ncols = 0
        sample: Optional[np.ndarray] = None
        labels_parts: List[np.ndarray] = []
        for Xc, yc in reader.chunks():
            m = len(yc)
            labels_parts.append(yc)
            ncols = Xc.shape[1]
            if reference is None:
                if sample is None:
                    sample = Xc[:sample_cnt].copy()
                elif len(sample) < sample_cnt:
                    # the reservoir is not full yet: the chunk's leading
                    # rows are the next positions below sample_cnt
                    sample = np.vstack([sample, Xc[:sample_cnt
                                                   - len(sample)]])
                start = max(n, sample_cnt)
                if start < n + m:
                    pos = np.arange(start, n + m)
                    accept = rng.random(len(pos)) < sample_cnt / (pos + 1.0)
                    slots = rng.integers(0, sample_cnt,
                                         size=int(accept.sum()))
                    sample[slots] = Xc[(pos - n)[accept]]
            n += m
        if n == 0:
            raise ValueError(f"empty data file {path}")
        label = np.concatenate(labels_parts)
        self = cls()
        self.config = config
        self.device = (reference.device if reference is not None
                       else resolve_device(config))
        self.num_data = n
        self.num_total_features = ncols
        self.feature_names = list(names)
        self.ingest_s = {"parse": time.perf_counter() - t0}
        with _ingest_phase(self, "sketch"):
            if reference is not None:
                self._adopt_reference_mappers(reference)
            else:
                self._find_mappers_maybe_distributed(
                    sample, config,
                    _parse_column_spec(config.categorical_feature, names),
                    _load_forced_bins(config), total_rows=n)
        scratch = {"chunk_bytes": 0}
        # pass 2 parses the file again inside "binning"
        with _ingest_phase(self, "binning"):
            self.bins_t = bin_chunks_t(
                (Xc for Xc, _ in reader.chunks()), n, self.mappers,
                self.used_feature_idx, self.device,
                int(config.tpu_ingest_chunk_rows), scratch)
        self.ingest_scratch_bytes = scratch["chunk_bytes"]
        weight, group, init_score = load_sidecars(path)
        self.metadata = Metadata(n, label, weight, group, init_score)
        self._set_constraints(config)
        # "two_round" marks this loader's result
        self.ingest_s["two_round"] = 1.0
        return self

    # the binary cache's token, shared with the JAX package
    _BINARY_TOKEN = "lightgbm_tpu.binned.v1"

    def save_binary(self, path: str) -> None:
        """The binned dataset as a compressed npz (reference
        Dataset::SaveBinaryFile, src/io/dataset.cpp:695), in the JAX
        package's layout: `[n, F]` bins (uint8, or uint16 past 256 bins
        a feature), mappers, names and metadata, so either package loads
        the other's file and skips parsing and bin finding."""
        import json

        md = self.metadata
        dtype = np.uint8 if self.max_num_bin <= 256 else np.uint16
        np.savez_compressed(
            path,
            token=np.frombuffer(self._BINARY_TOKEN.encode(), np.uint8),
            bins=np.ascontiguousarray(self.bins.astype(dtype, copy=False)),
            used_feature_idx=np.asarray(self.used_feature_idx, np.int64),
            num_total_features=np.int64(self.num_total_features),
            mappers=np.frombuffer(json.dumps(
                [m.to_dict() for m in self.mappers]).encode(), np.uint8),
            feature_names=np.frombuffer(
                json.dumps(self.feature_names).encode(), np.uint8),
            label=md.label,
            weight=(md.weight if md.weight is not None
                    else np.zeros(0, np.float32)),
            query_boundaries=(md.query_boundaries
                              if md.query_boundaries is not None
                              else np.zeros(0, np.int64)),
            init_score=(md.init_score if md.init_score is not None
                        else np.zeros(0, np.float64)),
            monotone=(self.monotone_constraints
                      if self.monotone_constraints is not None
                      else np.zeros(0, np.int32)),
            penalty=(self.feature_penalty
                     if self.feature_penalty is not None
                     else np.zeros(0, np.float32)))
        # numpy appends .npz; keep the requested name
        if not path.endswith(".npz") and os.path.exists(path + ".npz"):
            os.replace(path + ".npz", path)

    @classmethod
    def from_binary(cls, path: str, config: Optional[Config] = None
                    ) -> "TrainingData":
        """A binary cache of either package (`save_binary`), its bins
        sent to the config's device."""
        import json

        import torch

        config = config or Config()
        t0 = time.perf_counter()
        with np.load(path, allow_pickle=False) as z:
            token = bytes(z["token"]).decode()
            if token != cls._BINARY_TOKEN:
                raise ValueError(f"unrecognized binary dataset token "
                                 f"{token!r}")
            self = cls()
            self.config = config
            self.device = resolve_device(config)
            bins = z["bins"]
            self.used_feature_idx = [int(i) for i in z["used_feature_idx"]]
            self.num_total_features = int(z["num_total_features"])
            self.mappers = [BinMapper.from_dict(d) for d in
                            json.loads(bytes(z["mappers"]).decode())]
            self.feature_names = json.loads(
                bytes(z["feature_names"]).decode())
            self.num_data = int(bins.shape[0])
            md = Metadata(self.num_data, label=z["label"])
            if z["weight"].size:
                md.weight = z["weight"]
            if z["query_boundaries"].size:
                md.query_boundaries = z["query_boundaries"]
            if z["init_score"].size:
                md.init_score = z["init_score"]
            self.metadata = md
            if z["monotone"].size:
                self.monotone_constraints = z["monotone"]
            if z["penalty"].size:
                self.feature_penalty = z["penalty"]
        dtype = np.uint8 if self.max_num_bin <= 256 else np.int32
        self.bins_t = torch.from_numpy(
            np.ascontiguousarray(bins.T.astype(dtype))).to(self.device)
        self.ingest_s = {"binary": time.perf_counter() - t0}
        return self

    def create_valid(self, X, label: Optional[np.ndarray] = None,
                     **kw) -> "TrainingData":
        factory = (TrainingData.from_sparse if _is_scipy_sparse(X)
                   else TrainingData.from_matrix)
        return factory(X, label, self.config, reference=self, **kw)

    def _find_mappers_maybe_distributed(self, X, config: Config,
                                        categorical: Sequence[int],
                                        forced_bins=None,
                                        total_rows: Optional[int] = None
                                        ) -> None:
        """Feature-sharded multi-host bin finding where this process is
        part of a pre-partitioned group (io/distributed_binning.py,
        reference dataset_loader.cpp:959-1042); the local find
        otherwise.  One predicate decides (`config_wants_distributed`), so
        no rank skips a collective that its peers enter."""
        from .distributed_binning import (config_wants_distributed,
                                          ensure_distributed,
                                          find_mappers_multihost)

        ensure_distributed(config)
        if config_wants_distributed(config):
            self.mappers = find_mappers_multihost(
                X, config, categorical, forced_bins,
                local_total_rows=total_rows,
                feature_names=self.feature_names)
            self.used_feature_idx = [i for i, m in enumerate(self.mappers)
                                     if not m.is_trivial]
            return
        self._find_mappers(X, config, categorical, forced_bins,
                           total_rows=total_rows)

    def _find_mappers(self, X, config: Config,
                      categorical_features: Sequence[int],
                      forced_bins: Optional[Dict[int, List[float]]] = None,
                      total_rows: Optional[int] = None,
                      feature_subset: Optional[Sequence[int]] = None
                      ) -> None:
        """Greedy bin finding per column on a row sample, as the JAX
        package does it (reference dataset_loader.cpp:599-600,696); the
        columns of `categorical_features` bin as categories, and those of
        `forced_bins` take its upper bounds first.  X is a dense matrix
        or a scipy sparse one, whose columns' stored values are read off
        the CSC arrays of the sample (reference sparse-aware sampling,
        dataset_loader.cpp:959-1042).  `total_rows`: the whole data's
        rows where X is already a sample (two-round loading), which
        scales the near-unsplittable filter.  `feature_subset`: X's
        columns' global feature ids (the feature-sharded distributed
        find), which key the per-feature settings."""
        forced_bins = forced_bins or {}
        n, nf = X.shape
        full_n = max(int(total_rows), n) if total_rows is not None else n
        sample_cnt = min(n, int(config.bin_construct_sample_cnt))
        if sample_cnt < n:
            rng = np.random.default_rng(int(config.data_random_seed))
            sample_idx = np.sort(rng.choice(n, size=sample_cnt, replace=False))
            Xs = X[sample_idx]
        else:
            Xs = X
        sp_csc = None
        if _is_scipy_sparse(Xs):
            sp_csc = Xs.tocsc()
            sp_csc.sum_duplicates()
        total = Xs.shape[0]
        ignore = set(_parse_column_spec(config.ignore_column,
                                        self.feature_names))
        cat_set = set(int(c) for c in categorical_features)
        max_bin_by_feature = list(config.max_bin_by_feature)
        # near-unsplittable feature filter (dataset_loader.cpp:599-600)
        filter_cnt = int(float(config.min_data_in_leaf) * total / full_n)
        self.mappers = [BinMapper() for _ in range(nf)]

        def _find_col(col: int) -> None:
            gcol = int(feature_subset[col]) if feature_subset is not None \
                else col
            m = self.mappers[col]
            if gcol in ignore:
                m.num_bin = 1
                m.is_trivial = True
                return
            if sp_csc is not None:
                colv = np.asarray(sp_csc.data[sp_csc.indptr[col]:
                                              sp_csc.indptr[col + 1]],
                                  dtype=np.float64)
            else:
                colv = Xs[:, col]
            # (near-)zeros are implied by the sample's row count, stored
            # sparse zeros as much as dense ones
            nonzero = colv[~((np.abs(colv) <= K_ZERO_THRESHOLD)
                             & ~np.isnan(colv))]
            mb = int(config.max_bin)
            if max_bin_by_feature and gcol < len(max_bin_by_feature):
                mb = int(max_bin_by_feature[gcol])
            m.find_bin(nonzero, total, mb,
                       min_data_in_bin=int(config.min_data_in_bin),
                       min_split_data=filter_cnt,
                       bin_type=(BinType.CATEGORICAL if gcol in cat_set
                                 else BinType.NUMERICAL),
                       use_missing=bool(config.use_missing),
                       zero_as_missing=bool(config.zero_as_missing),
                       forced_bounds=forced_bins.get(gcol))

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
