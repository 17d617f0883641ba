"""Cross-process reduction of metric sufficient statistics.

The port of `lightgbm_tpu/parallel/metric_sync.py`, the analog of the
reference's ``Network::GlobalSyncUpBySum`` helpers
(include/LightGBM/network.h:168-275).  Where each process holds only its
rows of a train or validation set (`pre_partition`), a metric reduces its
sufficient statistics across processes before the final division:
averaged losses their (weighted loss sum, weight sum) pair
(`sync_sums`), AUC-type metrics an exact merge of the per-rank (score,
label, weight) arrays (`sync_concat`).  Both ride the topology layer's
bit-safe transport, so every rank gets the same bits.  Ratio statistics
are safe in the all-data mode too (every rank's numerator and
denominator scale alike); sum-type metrics reduce only where
`topology.rows_partitioned()` says the rows are distinct.

These are process-level collectives: every rank calls them in the same
order (the engine's eval cadence is the same on all ranks).  Each runs
under the collective watchdog and fires its fault points, also on the
world-size-1 identity path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .collective import guarded_collective
from .topology import _bitsafe_gather, host_sum
from .topology import process_count as _process_count


def process_count() -> int:
    return _process_count()


def sync_sums(vals: Sequence[float]) -> np.ndarray:
    """Elementwise sum across processes of a small f64 vector."""
    return host_sum(vals, name="sync_sums")


def sync_concat(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Concatenate per-rank 1-D arrays across processes, rank order: one
    logical collective (one watchdog, one fault point) for all of them.
    Ranks may hold different lengths: the lengths travel first and every
    array is padded to the longest.  All inputs share this rank's local
    length (parallel columns of one local table)."""
    if process_count() == 1:
        return guarded_collective(
            lambda: tuple(np.asarray(a, np.float64).ravel()
                          for a in arrays),
            name="sync_concat", local=True)
    arrs = [np.ascontiguousarray(np.asarray(a, np.float64).ravel())
            for a in arrays]
    n_local = arrs[0].shape[0]
    for a in arrs[1:]:
        if a.shape[0] != n_local:
            raise ValueError("sync_concat inputs must share the local "
                             f"length: {a.shape[0]} != {n_local}")

    def _merge() -> Tuple[np.ndarray, ...]:
        lens = _bitsafe_gather(np.asarray([n_local], np.int64),
                               "sync_concat")[:, 0]
        n_max = int(lens.max()) if len(lens) else 0
        block = np.zeros((len(arrs), n_max), np.float64)
        for i, a in enumerate(arrs):
            block[i, :n_local] = a
        g = _bitsafe_gather(block, "sync_concat")      # [P, k, n_max]
        return tuple(np.concatenate([g[p, i, :int(lens[p])]
                                     for p in range(len(lens))])
                     for i in range(len(arrs)))

    return guarded_collective(_merge, name="sync_concat")
