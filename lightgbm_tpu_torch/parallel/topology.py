"""One declarative topology: the (hosts, data, feature) shard grid and the
complete collective vocabulary, each written exactly once.

The port of `lightgbm_tpu/parallel/topology.py`.  The JAX package builds
one `jax.sharding.Mesh` over the named axes ``("hosts", "data",
"feature")`` and runs the grower once per device under `shard_map`; its
collectives are `lax` ones addressed by axis name.  Here the grid is a
list of shards, each a host thread with its own device and CUDA stream,
all running the same grower (SPMD), and every collective is an exchange
at a barrier of the process's shard group (`ShardGroup`):

* **The grid.**  `make_topology` lays the shards out row-major over
  ``(hosts, data, feature)``.  Rows partition over the axis tuple
  ``ROW_AXES = ("hosts", "data")``, and an index over a tuple is
  row-major over it, as in JAX, so the linearized row-shard index is the
  flat data index.  The hosts axis is the process: in a
  `torch.distributed` group of P processes, process p owns the shards
  ``[p*L, (p+1)*L)`` (L = size / P) and runs only those, shard i of them
  on ``cuda:(i % cards)`` or on the CPU.  In one process the hosts axis
  may be simulated (`tpu_topology_hosts`), as the JAX package proves
  its grid on virtual CPU devices.

* **Device collectives** (`axis_psum`, `axis_psum_scatter`,
  `axis_pmax`, `axis_all_gather`, `axis_index`, `axis_size`,
  `axis_best_split_sync`): called by every shard in the same order.
  Each local shard puts its tensor in its slot (on the card with an
  event recorded on its stream) and the process's shards meet at their
  barrier.  Where the axes span processes, one thread of the process,
  the leader, then copies every local slot into one flat host buffer
  (8-byte aligned pieces) and all-gathers it with the other processes
  over the process group; every rank's shapes agree under SPMD, so the
  remote slots are views of the gathered buffers.  Each shard then reads
  its members' tensors along the axes in the members' global order and
  sums in that order, so every rank of every process gets the same
  bits, and integer sums equal any other order's.  The barrier waits
  under the collective watchdog's deadline
  (`collective.defaults()["timeout_s"]`): a missed deadline raises
  `CollectiveTimeout`, and a shard that raises aborts the barrier, so
  its peers raise `ShardAborted` instead of waiting.

* **Host collectives** (`host_allgather`, `host_sum`,
  `ragged_all_gather`, `host_device_allgather`): the process-level
  exchanges, each under ONE `guarded_collective`.  They ride one
  bit-safe byte gather (`_bitsafe_gather`: fixed-width uint8 views,
  lengths first for ragged payloads), exact for every dtype.  A world
  of one takes the identity path, which still fires the fault points.

* **The transport** is `torch.distributed` over gloo: host buffers only
  (gloo's CUDA support covers broadcast and all_reduce alone, and two
  processes on one card are refused by NCCL), and only one thread of a
  process calls it at a time (gloo is not safe under concurrent
  collectives): the main thread outside the shard threads, the leader
  inside them.  A transport error becomes `HostDropped` where a peer
  recorded its failure in the rendezvous store (`note_failure`) or its
  connection closed, and `CollectiveTimeout` where the group's deadline
  ran out.

* **Row ownership.**  The learner `activate()`s its topology;
  `rows_partitioned()` is true exactly when the rows were placed
  process-locally (`pre_partition` in a group of several processes).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from .. import obs
from .collective import (CollectiveTimeout, HostDropped, defaults,
                         guarded_collective)

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
    host).  `devices` holds the devices of THIS process's shards, the
    global ranks ``local_ranks``, row-major over (hosts, data, feature);
    in one process that is every shard."""
    devices: Tuple[torch.device, ...]
    hosts: int
    data_shards: int        # total row shards across all hosts
    feature_shards: int
    partitioned_rows: bool  # rows placed per process (put_local)
    processes: int = 1      # processes of the group (the hosts axis)
    process: int = 0        # this process's index

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

    @property
    def local_size(self) -> int:
        """Shards this process runs."""
        return self.size // self.processes

    @property
    def first(self) -> int:
        """The global rank of this process's first shard."""
        return self.process * self.local_size

    @property
    def local_ranks(self) -> range:
        return range(self.first, self.first + self.local_size)

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


def _group_live() -> bool:
    dist = torch.distributed
    return bool(dist.is_available() and dist.is_initialized())


def process_count() -> int:
    """Processes in the group: the `torch.distributed` world where one is
    initialized, else 1."""
    return int(torch.distributed.get_world_size()) if _group_live() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return int(torch.distributed.get_rank()) if _group_live() else 0


def resolve_hosts(num_hosts: int = 0) -> int:
    """The hosts-axis size: an explicit positive value wins (simulated
    multi-host grids in one process), else the live process count."""
    if num_hosts > 0:
        return int(num_hosts)
    return process_count()


def shard_devices(count: int, base: Optional[torch.device] = None
                  ) -> List[torch.device]:
    """The device of each of `count` shards of this process: ``cuda:(i %
    cards)`` on the card, or the CPU where `base` is the CPU."""
    base = torch.device("cuda", 0) if base is None else torch.device(base)
    if base.type != "cuda":
        return [base] * count
    cards = max(torch.cuda.device_count(), 1)
    first = base.index or 0
    return [torch.device("cuda", (first + i) % cards) for i in range(count)]


def make_topology(num_data_shards: int = 1, num_feature_shards: int = 1,
                  num_hosts: int = 0, partitioned_rows: bool = False,
                  devices: Optional[Sequence] = None) -> Topology:
    """Lay out the (hosts, data, feature) grid.  `devices`: the devices of
    this process's shards (cycled where fewer are given; the default is
    `shard_devices` on the card).  In a group of several processes the
    hosts axis is the process.  Unlike
    the JAX package, which refuses more shards than devices, shards may
    share a device: one card then carries a simulated grid.  The learner
    holds a multi-process grid's hosts axis to the process count."""
    hosts = resolve_hosts(num_hosts)
    if num_data_shards % hosts != 0:
        raise ValueError(
            f"num_machines={num_data_shards * num_feature_shards} row "
            f"shards must split evenly across the {hosts} hosts "
            f"(row shards {num_data_shards} % hosts {hosts} != 0)")
    procs = process_count()
    local = num_data_shards * num_feature_shards // procs
    devs = list(devices) if devices is not None else shard_devices(local)
    if not devs:
        raise ValueError("make_topology needs at least one device")
    devs = [torch.device(devs[i % len(devs)]) for i in range(local)]
    return Topology(devices=tuple(devs), hosts=hosts,
                    data_shards=int(num_data_shards),
                    feature_shards=int(num_feature_shards),
                    partitioned_rows=bool(partitioned_rows),
                    processes=procs, process=process_index())


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
    row statistics are partial)?  True exactly when the live topology's
    rows were placed process-locally in a group of several processes."""
    t = _ACTIVE
    return bool(t is not None and t.partitioned_rows
                and process_count() > 1)


# --------------------------------------------------------------------------
# the process transport: gloo over host byte buffers
# --------------------------------------------------------------------------

_FAILED_KEY = "lgbt/failed"
_BACKEND_LOGGED = False
# per-process transport counters: process-level collectives, their host
# seconds and the bytes this process sent
TRANSPORT = {"calls": 0, "seconds": 0.0, "bytes": 0}
_transport_lock = threading.Lock()


def _store():
    """The rendezvous TCPStore of the live group, or None."""
    if not _group_live():
        return None
    try:
        from torch.distributed import distributed_c10d as c10d

        return c10d._get_default_store()
    except Exception:  # noqa: BLE001 - no store: no failure record
        return None


def note_failure(exc: BaseException) -> None:
    """Record this process's failure in the rendezvous store, so a peer
    whose transport then breaks raises `HostDropped` naming it instead of
    a bare connection error.  Best effort: never raises."""
    if process_count() <= 1:
        return
    store = _store()
    if store is None:
        return
    try:
        if store.check([_FAILED_KEY]):
            return          # the first failure names the cause
        store.set(_FAILED_KEY, f"{process_index()}: "
                  f"{type(exc).__name__}: {exc}"[:500])
    except Exception:  # noqa: BLE001 - the store's host may be gone
        pass


def peer_failure() -> Optional[str]:
    """A failure some process recorded (`note_failure`), else None."""
    store = _store()
    if store is None:
        return None
    try:
        if store.check([_FAILED_KEY]):
            return store.get(_FAILED_KEY).decode(errors="replace")
    except Exception:  # noqa: BLE001 - the store's host is gone: a peer
        return "the rendezvous host is unreachable"
    return None


_LOST = ("closed", "reset", "broken pipe", "connection refused", "eof",
         "unreachable", "abort")


def _transport(fn, name: str):
    """Run one gloo call; map its failures onto the watchdog's errors: a
    peer's recorded failure or a closed connection is `HostDropped`, the
    group's deadline `CollectiveTimeout`."""
    global _BACKEND_LOGGED
    if not _BACKEND_LOGGED:
        _BACKEND_LOGGED = True
        from ..utils.log import Log

        Log.info(f"process transport: torch.distributed "
                 f"{torch.distributed.get_backend()} over "
                 f"{process_count()} processes")
    t0 = time.perf_counter()
    try:
        return fn()
    except RuntimeError as exc:
        from ..utils import faultline

        text = str(exc).lower()
        peer = peer_failure()
        if peer is not None:
            raise HostDropped(f"collective {name!r}: peer host failed "
                              f"({peer})") from exc
        if "timed out" in text or "timeout" in text:
            raise CollectiveTimeout(name, float(defaults()["timeout_s"]),
                                    1, faultline.host_index()) from exc
        if any(w in text for w in _LOST):
            raise HostDropped(f"collective {name!r}: a peer host was lost "
                              f"({exc})") from exc
        raise
    finally:
        with _transport_lock:
            TRANSPORT["calls"] += 1
            TRANSPORT["seconds"] += time.perf_counter() - t0


def _gather_bytes(buf: torch.Tensor, name: str) -> List[torch.Tensor]:
    """All-gather one flat uint8 CPU buffer of the same length from every
    process: the P buffers in process order."""
    P = process_count()
    pin = buf.is_pinned()
    out = [torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=pin)
           for _ in range(P)]
    if buf.numel():
        _transport(lambda: torch.distributed.all_gather(out, buf), name)
    with _transport_lock:
        TRANSPORT["bytes"] += int(buf.numel())
    out[process_index()] = buf
    return out


def _bitsafe_gather(arr: np.ndarray, name: str = "host_allgather"
                    ) -> np.ndarray:
    """Gather a same-shaped host array from every process, bit-exact for
    every dtype (it travels as its uint8 bytes): [P, *shape]."""
    arr = np.ascontiguousarray(arr)
    raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    parts = _gather_bytes(raw, name)
    return np.stack([p.numpy().view(arr.dtype).reshape(arr.shape)
                     for p in parts])


# --------------------------------------------------------------------------
# the process's shard group and the shard context of each shard thread
# --------------------------------------------------------------------------

def _pad8(n: int) -> int:
    return -(-n // 8) * 8


class ShardGroup:
    """The collective group of one topology's shards in this process: one
    barrier of the local shards and one slot a shard (global rank ->
    slot).  Every shard calls every collective in the same order (SPMD),
    so a round of the barrier is one collective."""

    def __init__(self, topology: Topology):
        self.topology = topology
        self.size = topology.local_size
        self.leader = topology.first
        self._barrier = threading.Barrier(self.size)
        self._slots: Dict[int, Any] = {}
        self._failed: Optional[BaseException] = None
        self._lock = threading.Lock()
        # host seconds each local shard waited at the barrier, and
        # collectives
        self.wait_s = [0.0] * self.size
        self.collectives = 0
        # process-level exchanges: count, the leader's seconds in them
        # and the bytes this process sent
        self.proc_collectives = 0
        self.proc_s = 0.0
        self.proc_bytes = 0

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

    def gather_remote(self, name: str) -> None:
        """The leader's half of a cross-process exchange: every local
        slot into one flat host buffer (pinned on the card; each piece
        8-byte aligned), one all-gather with the other processes, and
        every remote rank's slot as views of its process's buffer, in the
        local slots' shapes and dtypes (SPMD)."""
        t0 = time.perf_counter()
        t = self.topology
        local = [self._slots[r] for r in t.local_ranks]
        layout, pieces = [], []
        off = 0
        for slot in local:
            specs = []
            for x, ev in slot:
                if ev is not None:
                    torch.cuda.current_stream(x.device).wait_event(ev)
                nb = x.numel() * x.element_size()
                specs.append((off, nb, x.dtype, tuple(x.shape)))
                flat = x.detach().contiguous().reshape(-1)
                if flat.dtype == torch.bool:
                    flat = flat.view(torch.uint8)
                pieces.append((off, flat.view(torch.uint8)))
                off += _pad8(nb)
            layout.append(specs)
        cuda = any(p.device.type == "cuda" for _, p in pieces)
        buf = torch.zeros(max(off, 8), dtype=torch.uint8, pin_memory=cuda)
        for o, p in pieces:
            buf[o:o + p.numel()].copy_(p, non_blocking=cuda)
        if cuda:
            for d in {p.device for _, p in pieces if p.device.type == "cuda"}:
                torch.cuda.current_stream(d).synchronize()
        parts = _gather_bytes(buf, name)
        for q, part in enumerate(parts):
            if q == t.process:
                continue
            for i, specs in enumerate(layout):
                items = []
                for o, nb, dtype, shape in specs:
                    raw = part[o:o + nb]
                    if dtype == torch.bool:
                        x = raw.view(torch.uint8).to(torch.bool)
                    else:
                        x = raw.view(dtype)
                    items.append((x.reshape(shape), None))
                self._slots[q * t.local_size + i] = items
        self.proc_collectives += 1
        self.proc_bytes += int(buf.numel())
        self.proc_s += time.perf_counter() - t0


class ShardContext(NamedTuple):
    """The shard a thread runs: its group, global rank, device and
    stream."""
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
        # a local CPU tensor, or a remote rank's view of the gathered
        # (pinned on the card) host buffer
        return x if x.device == ctx.device else x.to(ctx.device,
                                                     non_blocking=True)
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
    each member of this shard's subgroup along `axes` (in their global
    order), its tensors on this shard's device.  Where the axes span
    processes, the leader gathers the remote slots between two barrier
    rounds."""
    with obs.span(f"exchange/{name}"):
        ctx = current()
        g = ctx.group
        g._slots[ctx.rank] = [_ready(t) for t in tensors]
        t0 = time.perf_counter()
        g.wait(name)
        t = g.topology
        if t.processes > 1 and HOSTS in _axes(axes):
            if ctx.rank == g.leader:
                g.gather_remote(name)
            g.wait(name)
        t1 = time.perf_counter()
        out = [[_take(item, ctx) for item in g._slots[r]]
               for r in g.members(ctx.rank, axes)]
        # no slot is written again before every member has read it
        t2 = time.perf_counter()
        g.wait(name)
        g.wait_s[ctx.rank - t.first] += ((t1 - t0)
                                         + (time.perf_counter() - t2))
        if ctx.rank == g.leader:
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
    payload.  A payload entry may carry trailing dims past the leaves'
    (a categorical split's [C, B] mask).  Returns (gain, feature,
    threshold, payload) of the winner; one exchange carries the whole
    record."""
    from ..ops.split import argbest

    keys = list(payload)
    recs = _exchange([gain, feature.to(torch.int32), threshold]
                     + [payload[k] for k in keys], axes, "best_split_sync")
    # the shards on the axis after the leaves' dims: [..., P, *trailing]
    nb = gain.dim()
    cols = [torch.stack([r[j] for r in recs], nb)
            for j in range(3 + len(keys))]
    winner = argbest(cols[0], cols[1], cols[2])        # [...]

    def pick(a):
        idx = winner.long().reshape(winner.shape + (1,) * (a.dim() - nb))
        idx = idx.expand(*winner.shape, 1, *a.shape[nb + 1:])
        return torch.gather(a, nb, idx).squeeze(nb)

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
    """Gather one same-shaped host array from every process under the
    watchdog: [P, *shape] (or concatenated along axis 0 when `tiled`).
    A world of one takes the identity path, which still fires the fault
    points."""
    arr = np.ascontiguousarray(arr)
    if process_count() == 1:
        out = guarded_collective(lambda: arr, name=name, point=point,
                                 local=True)
        return out if tiled else out[None]
    out = guarded_collective(lambda: _bitsafe_gather(arr, name), name=name,
                             point=point)
    return np.concatenate(list(out)) if tiled else out


def host_sum(vals, *, name: str,
             point: Optional[str] = "collective_sync") -> np.ndarray:
    """Elementwise sum across processes of a small f64 vector, added in
    process order."""
    v = np.asarray(vals, np.float64)
    if process_count() == 1:
        return guarded_collective(lambda: v, name=name, point=point,
                                  local=True)
    return guarded_collective(lambda: _bitsafe_gather(v, name).sum(axis=0),
                              name=name, point=point)


def host_device_allgather(x: torch.Tensor, *, name: str,
                          point: Optional[str] = "collective_sync"
                          ) -> torch.Tensor:
    """Gather a device tensor from every process, tiled along axis 0, on
    the tensor's device: the leaf-id reassembly.  Its shape must agree
    across processes."""
    if process_count() == 1:
        return guarded_collective(lambda: x, name=name, point=point,
                                  local=True)

    def _go():
        g = _bitsafe_gather(x.detach().cpu().numpy(), name)
        return torch.from_numpy(np.concatenate(list(g))).to(x.device)

    return guarded_collective(_go, name=name, point=point)


def ragged_all_gather(arr: np.ndarray, *, name: str,
                      point: Optional[str] = "collective_sync",
                      split: bool = False):
    """Gather per-process arrays of differing leading length into one
    global view, process order: concatenated, or a per-process list under
    `split=True` (payloads whose boundaries matter, e.g. serialized
    mapper blobs).  The lengths travel first, then every payload padded
    to the longest; the pair is one logical collective under one
    watchdog.  Trailing dimensions must agree across processes."""
    arr = np.ascontiguousarray(arr)
    if process_count() == 1:
        out = guarded_collective(lambda: arr, name=name, point=point,
                                 local=True)
        return [out] if split else out

    def _merge():
        lens = _bitsafe_gather(np.asarray([arr.shape[0]], np.int64),
                               name)[:, 0]
        mx = max(int(lens.max()), 1)
        buf = np.zeros((mx,) + arr.shape[1:], arr.dtype)
        buf[:arr.shape[0]] = arr
        g = _bitsafe_gather(buf, name)                 # [P, mx, ...]
        parts = [g[p, :int(lens[p])] for p in range(len(lens))]
        return parts if split else (
            np.concatenate(parts) if parts else buf[:0])

    return guarded_collective(_merge, name=name, point=point)
