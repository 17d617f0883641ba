"""Shard-grid plumbing: the process group's rendezvous, placement of row
shards, row offsets, and the cost models of histogram aggregation.

The port of `lightgbm_tpu/parallel/mesh.py`.  The reference builds an
all-to-all TCP/MPI mesh of machines (reference src/network/
network.cpp:68-318); the JAX package declares a `jax.sharding.Mesh` over
`jax.distributed`'s processes and lets XLA place the transport.  The port
joins a `torch.distributed` group over gloo (`init_multihost`, from the
reference's `machines` list) and runs each process's shards
(`parallel/topology.py`): `put_global` places each local shard's part of
a tensor every process holds whole (the reference's all-data mode), and
`put_local` each local shard's part of the rows only this process holds
(`pre_partition`), the roles of JAX's `device_put` onto a
`NamedSharding` and `make_array_from_process_local_data`.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .topology import Topology

# a timed-out or failed rendezvous cannot be re-entered: the watchdog
# abandons a thread that may still complete init_process_group later, so
# a failed init is terminal for the process, recorded here to fail
# retries with a structured message
_distributed_init_failed: Optional[str] = None


def _process_id(entries: List[str]) -> int:
    """This host's position in `machines`: the entry whose address is
    LIGHTGBM_TPU_HOST_IP, else LIGHTGBM_TPU_PROCESS_ID."""
    my_ip = os.environ.get("LIGHTGBM_TPU_HOST_IP", "")
    if my_ip:
        for i, e in enumerate(entries):
            if e.split(":")[0] == my_ip:
                return i
    env_pid = os.environ.get("LIGHTGBM_TPU_PROCESS_ID", "")
    if env_pid:
        return int(env_pid)
    raise ValueError(
        "multi-host init: cannot determine this host's position in "
        "`machines`; set LIGHTGBM_TPU_HOST_IP or "
        "LIGHTGBM_TPU_PROCESS_ID")


def init_multihost(machines: str = "", local_listen_port: int = 0,
                   num_machines: int = 1) -> bool:
    """Join the process group of the reference's machine list
    (`machines` = "ip0:port0,ip1:port1,...", reference src/network/
    linkers_socket.cpp:165-220) over `torch.distributed` with gloo: the
    first entry is the TCP rendezvous (``tcp://ip0:port0``, its store
    hosted by process 0), the world is the entry count and this
    process's rank its position in the list (`_process_id`).  Returns
    True once the group is up (idempotent); a list of one host (or none)
    needs no group and returns False.  The rendezvous is the group's
    first collective: it runs under `guarded_collective` with no retry
    and the group's deadline (`tpu_collective_timeout_s`, also the
    group's own timeout), and a failure is terminal for the process."""
    global _distributed_init_failed
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return True
    if _distributed_init_failed is not None:
        raise RuntimeError(
            "a previous multi-host rendezvous failed in this process "
            f"({_distributed_init_failed}); torch.distributed cannot be "
            "re-initialized — restart the process to rejoin the group")
    entries = [m.strip() for m in str(machines).split(",") if m.strip()]
    if len(entries) <= 1 or num_machines <= 1:
        return False
    pid = _process_id(entries)
    from .collective import defaults, guarded_collective

    timeout = float(defaults()["timeout_s"])
    kw = {}
    if timeout > 0:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    try:
        guarded_collective(
            dist.init_process_group, name="init_multihost", retries=0,
            backend="gloo", init_method=f"tcp://{entries[0]}",
            world_size=len(entries), rank=pid, **kw)
    except BaseException as exc:
        _distributed_init_failed = f"{type(exc).__name__}: {exc}"
        raise
    return True


def available_devices() -> int:
    """Cards this process sees (1 on the CPU)."""
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() \
        else 1


def put_global(t: torch.Tensor, topology: Topology, axes: Tuple[str, ...],
               dim: int = -1) -> List[torch.Tensor]:
    """Each local shard's part of `t`, which every process holds whole,
    on its device (in `topology.local_ranks` order): with `axes` the row
    axes, shard i takes its row shard's contiguous slice of `dim` (its
    own contiguous tensor); with no axes every shard takes the whole
    tensor (one copy a device, shared by the shards on it)."""
    out: List[torch.Tensor] = []
    copies = {}
    P = topology.data_shards
    for rank, dev in zip(topology.local_ranks, topology.devices):
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


def put_local(local_arr: torch.Tensor, topology: Topology, global_shape,
              axes: Tuple[str, ...] = ("hosts", "data"), dim: int = -1
              ) -> List[torch.Tensor]:
    """Each local shard's part of rows only this process holds
    (reference pre_partition: each machine holds its own rows,
    dataset_loader.cpp row distribution): `local_arr` spans this
    process's row shards, ``global_shape[dim] / data_shards`` rows each,
    in their order.  The complement of `put_global`, whose input every
    process holds whole."""
    if not axes or topology.processes == 1:
        return put_global(local_arr, topology, axes, dim)
    w = int(global_shape[dim]) // topology.data_shards
    r0 = topology.row_shard(topology.first)
    out: List[torch.Tensor] = []
    copies = {}
    for rank, dev in zip(topology.local_ranks, topology.devices):
        j = topology.row_shard(rank) - r0
        key = (j, dev)
        if key not in copies:
            copies[key] = local_arr.narrow(dim, j * w, w).to(dev) \
                .contiguous()
        out.append(copies[key])
    return out


def shard_rows(n: int, num_shards: int) -> int:
    """Rows per shard, padded so every shard is equal-size."""
    return (n + num_shards - 1) // num_shards


def row_offsets(rows_per_host: Sequence[int]) -> Tuple[np.ndarray, int]:
    """Per-host global row offsets (process order) and the total count."""
    rows = np.asarray(list(rows_per_host), np.int64)
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)
    return offsets, int(rows.sum())


def local_row_offset(local_n: int) -> Tuple[int, int]:
    """(this process's global row offset, global total rows) in the live
    group: an all-gather of the processes' row counts under the
    watchdog; (0, local_n) in one process."""
    from .topology import host_allgather, process_count, process_index

    if process_count() == 1:
        return 0, int(local_n)
    lens = host_allgather(np.asarray([int(local_n)], np.int64),
                          name="row_offsets")[:, 0]
    offsets, total = row_offsets(lens)
    return int(offsets[process_index()]), total


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
