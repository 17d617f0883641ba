"""One declarative topology: the (hosts, data, feature) shard grid and the
complete collective vocabulary, each written exactly once.

The port of `lightgbm_tpu/parallel/topology.py`.  The JAX package builds
one `jax.sharding.Mesh` over the named axes ``("hosts", "data",
"feature")`` and runs the grower once per device under `shard_map`; its
collectives are `lax` ones addressed by axis name.  Here the grid is a
list of shards, each a host thread with its own device and CUDA stream,
all running the same grower (SPMD), and every collective is an exchange
at a barrier of one in-process group (`ShardGroup`):

* **The grid.**  `make_topology` lays the shards out row-major over
  ``(hosts, data, feature)``; shard i lives on ``cuda:(i % cards)``, or
  on the CPU.  Rows partition over the axis tuple ``ROW_AXES = ("hosts",
  "data")``, and an index over a tuple is row-major over it, as in JAX,
  so the linearized row-shard index is the flat data index.  The hosts
  axis is simulated in one process (`tpu_topology_hosts`); the JAX
  package proves its grid the same way, on virtual CPU devices.

* **Device collectives** (`axis_psum`, `axis_psum_scatter`,
  `axis_pmax`, `axis_all_gather`, `axis_index`, `axis_size`,
  `axis_best_split_sync`): called by every shard of the group in the
  same order.  Each shard puts its tensor in its slot (on the card with
  an event recorded on its stream), the group meets at the barrier, and
  each shard reads its peers' tensors in the peers' order along the
  axes (its stream waits on their events first), then the group meets
  again before a slot is reused.  Sums go in that order, so every shard
  gets the same bits, and integer sums equal any other order's.  The
  barrier waits under the collective watchdog's deadline
  (`collective.defaults()["timeout_s"]`): a missed deadline raises
  `CollectiveTimeout`, and a shard that raises aborts the barrier, so
  its peers raise `ShardAborted` instead of waiting.

* **Host collectives** (`host_allgather`, `host_sum`,
  `ragged_all_gather`): the process-level
  exchanges.  One process is a world of one, so each is an identity
  that still rides `guarded_collective` and fires its fault points.  A
  world of more than one process (ROADMAP A9b) is refused by name.

* **Row ownership.**  The learner `activate()`s its topology;
  `rows_partitioned()` is derived from where the rows were placed, and
  is False in one process.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .collective import CollectiveTimeout, defaults, guarded_collective

# the canonical axis names; every placement and collective addresses these
HOSTS = "hosts"
DATA = "data"
FEATURE = "feature"
# row-sharded tensors partition over the (hosts, data) product
ROW_AXES: Tuple[str, str] = (HOSTS, DATA)

AxisNames = Union[str, Tuple[str, ...]]


class ShardAborted(RuntimeError):
    """A peer shard of the group failed, so this shard's collective was
    abandoned; the group's caller raises the peer's own error."""


class Topology(NamedTuple):
    """One resolved training topology.

    `data_shards` is the total row-shard count (hosts x row shards a
    host); `devices` holds each shard's device, row-major over
    (hosts, data, feature)."""
    devices: Tuple[torch.device, ...]
    hosts: int
    data_shards: int        # total row shards across all hosts
    feature_shards: int
    partitioned_rows: bool  # rows placed per process (never, in one)

    @property
    def local_data_shards(self) -> int:
        """Row shards a host (the grid's 'data' axis size)."""
        return self.data_shards // self.hosts

    @property
    def shape(self) -> dict:
        return {HOSTS: self.hosts, DATA: self.local_data_shards,
                FEATURE: self.feature_shards}

    @property
    def size(self) -> int:
        return self.data_shards * self.feature_shards

    def coords(self, rank: int) -> dict:
        """{axis: index} of shard `rank` (row-major over (hosts, data,
        feature))."""
        d, f = self.local_data_shards, self.feature_shards
        return {HOSTS: rank // (d * f), DATA: (rank // f) % d,
                FEATURE: rank % f}

    def rank_of(self, coords: dict) -> int:
        d, f = self.local_data_shards, self.feature_shards
        return (coords[HOSTS] * d + coords[DATA]) * f + coords[FEATURE]

    def row_shard(self, rank: int) -> int:
        """The linearized (hosts, data) index of shard `rank`."""
        return rank // self.feature_shards


def process_count() -> int:
    """Processes in the group: the `torch.distributed` world where one is
    initialized, else 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def one_process(what: str) -> None:
    """Refuse, by name, a world of more than one process."""
    if process_count() > 1:
        raise NotImplementedError(
            f"{what} across {process_count()} processes is not ported to "
            "lightgbm_tpu_torch yet (ROADMAP A9b: the torch.distributed "
            "transport)")


def resolve_hosts(num_hosts: int = 0) -> int:
    """The hosts-axis size: an explicit positive value wins (simulated
    multi-host grids in one process), else the live process count."""
    if num_hosts > 0:
        return int(num_hosts)
    return process_count()


def shard_devices(count: int, base: Optional[torch.device] = None
                  ) -> List[torch.device]:
    """The device of each of `count` shards: ``cuda:(i % cards)`` on the
    card, or the CPU where `base` is the CPU."""
    base = torch.device("cuda", 0) if base is None else torch.device(base)
    if base.type != "cuda":
        return [base] * count
    cards = max(torch.cuda.device_count(), 1)
    first = base.index or 0
    return [torch.device("cuda", (first + i) % cards) for i in range(count)]


def make_topology(num_data_shards: int = 1, num_feature_shards: int = 1,
                  num_hosts: int = 0, partitioned_rows: bool = False,
                  devices: Optional[Sequence] = None) -> Topology:
    """Lay out the (hosts, data, feature) grid.  `devices`: the shards'
    devices (cycled where fewer than the shards are given; the default is
    `shard_devices` on the card).  Unlike the JAX package, which refuses
    more shards than devices, shards may share a device: one card then
    carries a simulated grid."""
    hosts = resolve_hosts(num_hosts)
    if num_data_shards % hosts != 0:
        raise ValueError(
            f"num_machines={num_data_shards * num_feature_shards} row "
            f"shards must split evenly across the {hosts} hosts "
            f"(row shards {num_data_shards} % hosts {hosts} != 0)")
    need = num_data_shards * num_feature_shards
    devs = list(devices) if devices is not None else shard_devices(need)
    if not devs:
        raise ValueError("make_topology needs at least one device")
    devs = [torch.device(devs[i % len(devs)]) for i in range(need)]
    return Topology(devices=tuple(devs), hosts=hosts,
                    data_shards=int(num_data_shards),
                    feature_shards=int(num_feature_shards),
                    partitioned_rows=bool(partitioned_rows))


# --------------------------------------------------------------------------
# active topology: the learner registers what it built, so row-ownership
# questions are answered from placement, not configuration
# --------------------------------------------------------------------------

_ACTIVE: Optional[Topology] = None


def activate(topology: Optional[Topology]) -> None:
    """Register the live training topology (learner init; None clears)."""
    global _ACTIVE
    _ACTIVE = topology


def active() -> Optional[Topology]:
    return _ACTIVE


def rows_partitioned() -> bool:
    """Does each PROCESS hold a distinct row shard (so cross-rank sums of
    row statistics are partial)?  False with no live topology or in one
    process, where every shard's rows belong to the same process."""
    t = _ACTIVE
    return bool(t is not None and t.partitioned_rows
                and process_count() > 1)


# --------------------------------------------------------------------------
# the in-process group and the shard context of each shard thread
# --------------------------------------------------------------------------

class ShardGroup:
    """The collective group of one topology's shards in one process: one
    barrier and one slot a shard.  Every shard calls every collective in
    the same order (SPMD), so a round of the barrier is one collective."""

    def __init__(self, topology: Topology):
        self.topology = topology
        self.size = topology.size
        self._barrier = threading.Barrier(self.size)
        self._slots: List[Any] = [None] * self.size
        self._failed: Optional[BaseException] = None
        self._lock = threading.Lock()
        # host seconds each shard waited at the barrier, and collectives
        self.wait_s = [0.0] * self.size
        self.collectives = 0

    def abort(self, exc: BaseException) -> None:
        """A shard failed: record why and break the barrier, so that its
        peers' waits raise instead of hanging."""
        with self._lock:
            if self._failed is None:
                self._failed = exc
        self._barrier.abort()

    @property
    def failed(self) -> Optional[BaseException]:
        return self._failed

    def wait(self, name: str) -> None:
        timeout = float(defaults()["timeout_s"])
        try:
            self._barrier.wait(timeout if timeout > 0 else None)
        except threading.BrokenBarrierError:
            with self._lock:
                if self._failed is None:
                    # this shard's wait ran out: the deadline expired
                    from ..utils import faultline

                    self._failed = CollectiveTimeout(
                        name, timeout, 1, faultline.host_index())
                    raise self._failed from None
            raise ShardAborted(
                f"collective {name!r} abandoned: a peer shard failed "
                f"({type(self._failed).__name__}: {self._failed})") from None

    def members(self, rank: int, axes: AxisNames) -> List[int]:
        """The ranks of `rank`'s subgroup along `axes` (those sharing its
        coordinates on every other axis), row-major over `axes`."""
        axes = _axes(axes)
        t = self.topology
        me = t.coords(rank)
        sizes = [t.shape[a] for a in axes]
        out = []
        for flat in range(int(np.prod(sizes)) if sizes else 1):
            c = dict(me)
            rem = flat
            for a, s in zip(reversed(axes), reversed(sizes)):
                c[a] = rem % s
                rem //= s
            out.append(t.rank_of(c))
        return out


class ShardContext(NamedTuple):
    """The shard a thread runs: its group, rank, device and stream."""
    group: ShardGroup
    rank: int
    device: torch.device
    stream: Any


_LOCAL = threading.local()


def current() -> ShardContext:
    ctx = getattr(_LOCAL, "shard", None)
    if ctx is None:
        raise RuntimeError("a device collective ran outside a shard thread "
                           "(parallel/strategies.py:run_shards)")
    return ctx


def enter_shard(ctx: Optional[ShardContext]) -> None:
    """Bind (or, with None, unbind) the calling thread's shard."""
    _LOCAL.shard = ctx


def _axes(axes: AxisNames) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _ready(x: torch.Tensor):
    """(tensor, event of its producing stream) for a peer to read."""
    if x.device.type != "cuda":
        return x, None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return x, ev


def _take(item, ctx: ShardContext) -> torch.Tensor:
    """A peer's tensor, readable on this shard's stream and device."""
    x, ev = item
    if ev is None:
        return x if x.device == ctx.device else x.to(ctx.device)
    if x.device == ctx.device:
        torch.cuda.current_stream(ctx.device).wait_event(ev)
        # the allocator must not hand x's memory out before this shard's
        # stream has read it
        x.record_stream(torch.cuda.current_stream(ctx.device))
        return x
    # another card: its stream of this thread orders the copy after the
    # producer's work
    torch.cuda.current_stream(x.device).wait_event(ev)
    return x.to(ctx.device, non_blocking=True)


def _exchange(tensors: Sequence[torch.Tensor], axes: AxisNames,
              name: str) -> List[List[torch.Tensor]]:
    """One collective round: every shard offers `tensors`; returns, for
    each member of this shard's subgroup along `axes` (in their order),
    its tensors on this shard's device."""
    ctx = current()
    g = ctx.group
    g._slots[ctx.rank] = [_ready(t) for t in tensors]
    t0 = time.perf_counter()
    g.wait(name)
    t1 = time.perf_counter()
    out = [[_take(item, ctx) for item in g._slots[r]]
           for r in g.members(ctx.rank, axes)]
    # no slot is written again before every member has read it
    t2 = time.perf_counter()
    g.wait(name)
    g.wait_s[ctx.rank] += (t1 - t0) + (time.perf_counter() - t2)
    if ctx.rank == 0:
        g.collectives += 1
    return out


# --------------------------------------------------------------------------
# device collectives: the vocabulary the grower uses inside shard threads
# --------------------------------------------------------------------------

def _sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def axis_psum(x: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    """All-reduce sum over the named axes (their product for a tuple),
    added in the members' order."""
    return _sum_in_order([m[0] for m in _exchange([x], axes, "psum")])


def axis_psum_scatter(x: torch.Tensor, axes: AxisNames,
                      scatter_dimension: int, tiled: bool = True
                      ) -> torch.Tensor:
    """Reduce-scatter over the named axes: each shard keeps only its
    contiguous 1/P slice of `scatter_dimension`, summed as `axis_psum`
    sums it."""
    if not tiled:
        raise NotImplementedError("axis_psum_scatter takes tiled=True")
    parts = [m[0] for m in _exchange([x], axes, "psum_scatter")]
    P = len(parts)
    w = x.shape[scatter_dimension] // P
    i = axis_index(axes)
    return _sum_in_order([p.narrow(scatter_dimension, i * w, w)
                          for p in parts])


def axis_pmax(x: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    """All-reduce max over the named axes (quantization scale sync)."""
    parts = [m[0] for m in _exchange([x], axes, "pmax")]
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p)
    return acc


def axis_all_gather(x: torch.Tensor, axes: AxisNames, axis: int = 0,
                    tiled: bool = False) -> torch.Tensor:
    """All-gather over the named axes: the members' tensors stacked on a
    new axis `axis` (concatenated along it when `tiled`)."""
    parts = [m[0] for m in _exchange([x], axes, "all_gather")]
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def axis_index(axes: AxisNames) -> int:
    """This shard's linearized index along the named axes (row-major over
    a tuple: for ROW_AXES the flat row-shard id)."""
    ctx = current()
    t = ctx.group.topology
    c = t.coords(ctx.rank)
    idx = 0
    for a in _axes(axes):
        idx = idx * t.shape[a] + c[a]
    return idx


def axis_size(axes: AxisNames) -> int:
    """Size of the named axes' product in the live group."""
    t = current().group.topology
    out = 1
    for a in _axes(axes):
        out *= t.shape[a]
    return out


def axis_best_split_sync(axes: AxisNames, gain, feature, threshold,
                         payload: dict):
    """SyncUpGlobalBestSplit over named axes (reference
    parallel_tree_learner.h:190-213): gather ONE best record a shard (of
    a leaf, or of each of a batch of leaves: [C]), pick the winner with
    the shared tie-break (`split.argbest`: highest gain, then lowest
    feature id, then lowest threshold bin), and take the winner's
    payload.  Returns (gain, feature, threshold, payload) of the winner;
    one exchange carries the whole record."""
    from ..ops.split import argbest

    keys = list(payload)
    recs = _exchange([gain, feature.to(torch.int32), threshold]
                     + [payload[k] for k in keys], axes, "best_split_sync")
    cols = [torch.stack([r[j] for r in recs], -1)
            for j in range(3 + len(keys))]             # [..., P] each
    winner = argbest(cols[0], cols[1], cols[2])        # [...]

    def pick(a):
        return torch.gather(a, -1, winner[..., None].long())[..., 0]

    return (pick(cols[0]), pick(cols[1]), pick(cols[2]),
            {k: pick(c) for k, c in zip(keys, cols[3:])})


# --------------------------------------------------------------------------
# host collectives: process-level exchanges, each under ONE watchdog
# --------------------------------------------------------------------------

def host_count() -> int:
    return process_count()


def host_allgather(arr: np.ndarray, *, name: str,
                   point: Optional[str] = "collective_sync",
                   tiled: bool = False) -> np.ndarray:
    """Gather one same-shaped host array from every process: [P, *shape]
    (or concatenated along axis 0 when `tiled`).  A world of one takes
    the identity path, which still fires the fault points."""
    one_process("host_allgather")
    arr = np.ascontiguousarray(arr)
    out = guarded_collective(lambda: arr, name=name, point=point,
                             local=True)
    return out if tiled else out[None]


def host_sum(vals, *, name: str,
             point: Optional[str] = "collective_sync") -> np.ndarray:
    """Elementwise sum across processes of a small f64 vector."""
    one_process("host_sum")
    v = np.asarray(vals, np.float64)
    return guarded_collective(lambda: v, name=name, point=point, local=True)


def ragged_all_gather(arr: np.ndarray, *, name: str,
                      point: Optional[str] = "collective_sync",
                      split: bool = False):
    """Gather per-process arrays of differing leading length into one
    global view, process order: concatenated, or a per-process list under
    `split=True`."""
    one_process("ragged_all_gather")
    arr = np.ascontiguousarray(arr)
    out = guarded_collective(lambda: arr, name=name, point=point,
                             local=True)
    return [out] if split else out
