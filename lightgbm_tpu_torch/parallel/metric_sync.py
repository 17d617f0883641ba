"""Cross-process reduction of metric sufficient statistics.

The port of `lightgbm_tpu/parallel/metric_sync.py`, the analog of the
reference's ``Network::GlobalSyncUpBySum`` helpers
(include/LightGBM/network.h:168-275).  Where each process holds only its
rows of a train or validation set, a metric reduces its sufficient
statistics across processes before the final division: averaged losses
their (weighted loss sum, weight sum) pair (`sync_sums`), AUC-type
metrics an exact merge of the per-rank (score, label, weight) arrays
(`sync_concat`).  Metrics are computed on the host from global score
vectors in one process, so both helpers are identities here; each still
runs under the collective watchdog and fires its fault points, and a
world of more than one process is refused by name until ROADMAP A9b adds
the transport under them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .collective import guarded_collective
from .topology import host_sum, one_process


def sync_sums(vals: Sequence[float]) -> np.ndarray:
    """Elementwise sum across processes of a small f64 vector."""
    return host_sum(vals, name="sync_sums")


def sync_concat(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Concatenate per-rank 1-D arrays across processes, rank order: one
    logical collective (one watchdog, one fault point) for all of them."""
    one_process("sync_concat")
    arrs = tuple(np.asarray(a, np.float64).ravel() for a in arrays)
    return guarded_collective(lambda: arrs, name="sync_concat", local=True)
