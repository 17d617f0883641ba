"""Shard-grid plumbing: placement of row shards, row offsets, and the cost
models of histogram aggregation.

The port of `lightgbm_tpu/parallel/mesh.py`.  The reference builds an
all-to-all TCP/MPI mesh of machines (reference src/network/
network.cpp:68-318); the JAX package declares a `jax.sharding.Mesh` and
lets XLA place the transport.  The port keeps one process and its shards
(`parallel/topology.py`): `put_global` places each shard's part of a
tensor on that shard's device, the role of JAX's `device_put` onto a
`NamedSharding`.  The multi-process half (`init_multihost` over
`machines`, `put_local` of pre-partitioned rows) is ROADMAP A9b and is
refused by name.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .topology import Topology


def init_multihost(machines: str = "", local_listen_port: int = 0,
                   num_machines: int = 1) -> bool:
    """The reference's machine-list rendezvous (linkers_socket.cpp:
    165-220).  A list naming one host (or none) needs no rendezvous and
    returns False; a list of several hosts is the multi-process layer,
    not ported yet."""
    entries = [m.strip() for m in str(machines).split(",") if m.strip()]
    if len(entries) <= 1 or num_machines <= 1:
        return False
    raise NotImplementedError(
        f"machines={machines!r} (a machine list of {len(entries)} hosts, "
        "multi-process training) is not ported to lightgbm_tpu_torch yet "
        "(ROADMAP A9b)")


def available_devices() -> int:
    """Cards this process sees (1 on the CPU)."""
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() \
        else 1


def put_global(t: torch.Tensor, topology: Topology, axes: Tuple[str, ...],
               dim: int = -1) -> List[torch.Tensor]:
    """Each shard's part of `t` on its device: with `axes` the row axes,
    shard i takes its row shard's contiguous slice of `dim` (its own
    contiguous tensor); with no axes every shard takes the whole tensor
    (one copy a device, shared by the shards on it)."""
    out: List[torch.Tensor] = []
    copies = {}
    P = topology.data_shards
    for rank, dev in enumerate(topology.devices):
        if axes:
            w = t.shape[dim] // P
            r = topology.row_shard(rank)
            key = (r, dev)
            if key not in copies:
                copies[key] = t.narrow(dim, r * w, w).to(dev).contiguous()
        else:
            key = dev
            if key not in copies:
                copies[key] = t if t.device == dev else t.to(dev)
        out.append(copies[key])
    return out


def put_local(local_arr, topology: Topology, global_shape):
    """Pre-partitioned rows (reference pre_partition: each machine holds
    only its own rows): the multi-process layer."""
    raise NotImplementedError(
        "pre_partition (rows placed per process) is not ported to "
        "lightgbm_tpu_torch yet (ROADMAP A9b)")


def shard_rows(n: int, num_shards: int) -> int:
    """Rows per shard, padded so every shard is equal-size."""
    return (n + num_shards - 1) // num_shards


def row_offsets(rows_per_host: Sequence[int]) -> Tuple[np.ndarray, int]:
    """Per-host global row offsets (process order) and the total count."""
    rows = np.asarray(list(rows_per_host), np.int64)
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)
    return offsets, int(rows.sum())


def local_row_offset(local_n: int) -> Tuple[int, int]:
    """(this process's global row offset, global total rows): (0,
    local_n) in one process."""
    from .topology import host_allgather

    lens = host_allgather(np.asarray([int(local_n)], np.int64),
                          name="row_offsets")[:, 0]
    offsets, total = row_offsets(lens)
    return int(offsets[0]), total


# --------------------------------------------------------------------------
# Aggregation cost model (tpu_hist_agg): predicted per-shard receive bytes
# of the two histogram aggregation modes under bandwidth-optimal ring
# algorithms (reference Network::ReduceScatter, network.cpp:68-318):
#
#   all-reduce (psum)          2 * (P-1)/P * nbytes   per shard
#   reduce-scatter (scatter)       (P-1)/P * nbytes   per shard
#
# so scatter halves the traffic and shrinks what each shard keeps by P.
# --------------------------------------------------------------------------

def allreduce_recv_bytes(nbytes: int, shards: int) -> int:
    """Per-shard receive bytes of a ring all-reduce (psum) of `nbytes`."""
    if shards <= 1:
        return 0
    return 2 * (shards - 1) * nbytes // shards


def reduce_scatter_recv_bytes(nbytes: int, shards: int) -> int:
    """Per-shard receive bytes of a ring reduce-scatter (psum_scatter)."""
    if shards <= 1:
        return 0
    return (shards - 1) * nbytes // shards


def tiered_allreduce_recv_bytes(nbytes: int, hosts: int,
                                devices_per_host: int) -> Tuple[int, int]:
    """(within-host, across-host) per-shard receive bytes of a
    hierarchical all-reduce: reduce-scatter inside each host, the
    all-reduce of the 1/D partials across hosts, the all-gather back.
    Degenerates to the flat ring models at either tier = 1."""
    d, h = max(devices_per_host, 1), max(hosts, 1)
    return allreduce_recv_bytes(nbytes, d), allreduce_recv_bytes(nbytes // d,
                                                                 h)


def tiered_reduce_scatter_recv_bytes(nbytes: int, hosts: int,
                                     devices_per_host: int
                                     ) -> Tuple[int, int]:
    """(within-host, across-host) per-shard receive bytes of a
    hierarchical reduce-scatter down to the 1/(H*D) slices."""
    d, h = max(devices_per_host, 1), max(hosts, 1)
    return (reduce_scatter_recv_bytes(nbytes, d),
            reduce_scatter_recv_bytes(nbytes // d, h))
