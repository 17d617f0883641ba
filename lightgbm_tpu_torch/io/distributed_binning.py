"""Multi-host bin finding: feature-sharded mapper search + all-gather.

The port of `lightgbm_tpu/io/distributed_binning.py`.  The reference's
distributed loader pre-partitions rows across machines and splits BIN
FINDING by feature: each machine runs FindBin for its assigned feature
range on its sample, then `Network::Allgather` exchanges the serialized
BinMappers so every machine ends with the full mapper set (reference
src/io/dataset_loader.cpp:959-1042).  Here the processes of a
`torch.distributed` group first gather one global row sample (each
contributes an equal quota of its rows, `gather_row_samples`), find
their features' mappers on it and exchange the mapper dicts as JSON
through the topology layer's ragged all-gather.  The assignment and the
merge are pure functions, so single-process tests hold them against the
JAX package's.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from .bin_mapper import BinMapper


def ensure_distributed(config: Config) -> None:
    """Join the process group when the config asks for a machine group
    with pre-partitioned rows.  A pre-partitioned Dataset is built
    before any learner, and its bin finding is already a collective, so
    the rendezvous runs before anything else.  Explicitly a
    SIDE-EFFECTING entry-point call (it can block on peers or raise on an
    unresolvable machine list); the config_wants_distributed predicate
    below stays pure.  init_multihost is idempotent."""
    if (bool(config.pre_partition) and str(config.machines)
            and int(config.num_machines) > 1):
        from ..parallel.collective import configure_from_config
        from ..parallel.mesh import init_multihost

        # the rendezvous is the FIRST collective: arm the process-wide
        # watchdog defaults before it (Network::Init ordering)
        configure_from_config(config)
        init_multihost(str(config.machines),
                       int(config.local_listen_port),
                       int(config.num_machines))


def config_wants_distributed(config: Config) -> bool:
    """Single predicate for every site that must agree on whether this
    process joins the collective bin-finding path — the cache-skip in
    from_file and the routing in _find_mappers_maybe_distributed must
    never diverge, or one host deadlocks the group's allgather."""
    if not bool(config.pre_partition):
        return False
    from ..parallel.topology import process_count

    return process_count() > 1


def assign_features(num_features: int, num_machines: int) -> List[List[int]]:
    """Contiguous per-machine feature ranges, balanced by count (the
    reference balances by bin count after a first pass; contiguous ranges
    keep the allgather order deterministic)."""
    base = num_features // num_machines
    extra = num_features % num_machines
    out: List[List[int]] = []
    start = 0
    for m in range(num_machines):
        width = base + (1 if m < extra else 0)
        out.append(list(range(start, start + width)))
        start += width
    return out


def merge_mapper_payloads(payloads: Sequence[str],
                          num_features: int) -> List[BinMapper]:
    """Allgathered JSON payloads -> full mapper list.

    Each payload is `{"features": [...], "mappers": [dict, ...]}` from one
    machine; every feature must be covered exactly once.
    """
    mappers: List[Optional[BinMapper]] = [None] * num_features
    for payload in payloads:
        obj = json.loads(payload)
        for f, md in zip(obj["features"], obj["mappers"]):
            if mappers[f] is not None:
                raise ValueError(f"feature {f} assigned to two machines")
            mappers[f] = BinMapper.from_dict(md)
    missing = [f for f, m in enumerate(mappers) if m is None]
    if missing:
        raise ValueError(f"features {missing[:5]}... missing from allgather")
    return mappers  # type: ignore[return-value]


def local_payload(X_local: np.ndarray, features: Sequence[int],
                  config: Config, categorical: Sequence[int] = (),
                  forced_bins: Optional[Dict[int, List[float]]] = None,
                  total_rows: Optional[int] = None,
                  feature_names: Optional[Sequence[str]] = None) -> str:
    """Find this machine's assigned features' mappers on its local rows.

    Per-feature config (ignore_column, max_bin_by_feature, categorical,
    forced bins) stays keyed by GLOBAL feature id via feature_subset;
    feature_names must be the dataset's REAL names so name-based
    ignore_column specs resolve identically on every host."""
    from .dataset import TrainingData

    td = TrainingData()
    td.feature_names = (list(feature_names) if feature_names is not None
                        else [f"Column_{i}"
                              for i in range(X_local.shape[1])])
    td._find_mappers(X_local[:, list(features)], config,
                     list(categorical), dict(forced_bins or {}),
                     total_rows=total_rows,
                     feature_subset=list(features))
    return json.dumps({
        "features": list(features),
        "mappers": [m.to_dict() for m in td.mappers]})


def gather_row_samples(X_local: np.ndarray, quota: int,
                       seed: int) -> np.ndarray:
    """Deterministic per-host row sample, allgathered into ONE global
    bin-finding sample every host holds identically.

    The ragged transport (per-host lengths allgather, zero-padded
    payload block, per-host slices back out in process order) is
    `topology.ragged_all_gather` — ONE logical collective under ONE
    watchdog, on binning's own fault point so chaos runs can target
    ingest separately from train-loop sync.  The result is
    deterministic given (data, seed, process layout).  Each host
    contributes at most `quota` of its local rows (sorted deterministic
    choice, the same sampler `_find_mappers` uses)."""
    from ..parallel.topology import ragged_all_gather

    n = X_local.shape[0]
    if n > quota:
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(n, size=quota, replace=False))
        samp = np.ascontiguousarray(
            np.asarray(X_local, np.float64)[idx])
    else:
        samp = np.asarray(X_local, np.float64)
    return ragged_all_gather(samp, name="gather_row_samples",
                             point="binning_allgather")


def find_mappers_multihost(X_local: np.ndarray, config: Config,
                           categorical: Sequence[int] = (),
                           forced_bins: Optional[Dict[int, List[float]]]
                           = None,
                           local_total_rows: Optional[int] = None,
                           feature_names: Optional[Sequence[str]] = None
                           ) -> List[BinMapper]:
    """Distributed bin finding across the process group.

    Single-process runs degrade to a plain local find over all features.
    local_total_rows is THIS host's full row count when X_local is already
    a sample (two-round); the near-unsplittable filter always scales
    against the allgather-summed GLOBAL count.

    Dense inputs first gather a `bin_construct_sample_cnt`-bounded
    GLOBAL row sample (each host contributes an equal quota of its local
    rows), so feature f's mapper no longer depends on which host owned f
    — boundaries are consistent with what a single-host find over the
    same sample would produce.  Sparse inputs keep the reference's
    local-rows behavior (densifying a wide sparse sample for transport
    would defeat the O(nnz) ingest path).
    """
    from ..parallel.topology import process_count, process_index

    nproc = process_count()
    nf = X_local.shape[1]
    if nproc <= 1:
        payload = local_payload(X_local, list(range(nf)), config,
                                categorical, forced_bins,
                                total_rows=local_total_rows,
                                feature_names=feature_names)
        return merge_mapper_payloads([payload], nf)
    from ..parallel.topology import host_allgather, ragged_all_gather

    local_n = int(local_total_rows if local_total_rows is not None
                  else X_local.shape[0])
    global_rows = int(host_allgather(
        np.asarray([local_n], np.int64),
        name="global_row_count", point="binning_allgather").sum())
    assignment = assign_features(nf, nproc)
    mine = assignment[process_index()]
    from .dataset import _is_scipy_sparse

    X_find = X_local
    if not _is_scipy_sparse(X_local):
        quota = max(1, int(config.bin_construct_sample_cnt) // nproc)
        X_find = gather_row_samples(np.asarray(X_local, np.float64),
                                    quota, int(config.data_random_seed))
    payload = local_payload(X_find, mine, config, categorical, forced_bins,
                            total_rows=global_rows,
                            feature_names=feature_names)

    # ragged byte transport, split back per host so each serialized
    # payload decodes at its own boundary
    raw = np.frombuffer(payload.encode(), np.uint8)
    parts = ragged_all_gather(raw, name="mapper_exchange",
                              point="binning_allgather", split=True)
    payloads = [bytes(p).decode() for p in parts]
    return merge_mapper_payloads(payloads, nf)
