"""Parallel tree-learner strategies over the (hosts, data, feature) grid.

The port of `lightgbm_tpu/parallel/strategies.py`.  The reference picks
its learner in a factory keyed on tree_learner (reference
src/treelearner/tree_learner.cpp:13-36), and its parallel learners are
templates over the serial one; the JAX package wraps one grower body in
`shard_map` for each strategy:

  serial       — one grower, one device
  data         — rows sharded over (hosts, data); histograms psummed, or
                 reduce-scattered to column slices with a best-split sync
                 (DataParallelTreeLearner)
  feature      — every shard holds every row and histograms its feature
                 slice; the per-shard bests sync (FeatureParallelTreeLearner)
  voting       — rows sharded; only the voted features' histograms
                 aggregate (VotingParallelTreeLearner, PV-Tree)
  data_feature — rows over (hosts, data) x features over 'feature'

Here `make_strategy_grower` runs the same `ops/grower.py:grow` once a
shard of this process, SPMD (`run_shards`): each local shard is a host
thread on its own device and CUDA stream, its collectives are
`parallel/topology.py`'s exchanges (across processes through the
group's leader), and the caller gets the grower's out dict with the leaf
ids of the row shards put back together in row order: this process's
rows where the rows were placed per process (`pre_partition`), else all
of them, gathered across processes (`leaf_id_allgather`).  On one card
every shard shares the card: a simulated grid, as the JAX tests simulate
theirs on virtual CPU devices.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import grower as G
from .topology import (FEATURE, ROW_AXES, ShardAborted, ShardContext,
                       ShardGroup, Topology, enter_shard)

_CANON = {
    "serial": "serial",
    "data": "data", "data_parallel": "data",
    "feature": "feature", "feature_parallel": "feature",
    "voting": "voting", "voting_parallel": "voting",
    # the 2-D composition (the reference's device x parallel template
    # nesting, parallel_tree_learner.h:25-187)
    "data_feature": "data_feature", "feature_data": "data_feature",
    "data_feature_parallel": "data_feature",
}


def resolve_tree_learner(name: str) -> str:
    """Canonical strategy name (reference tree_learner config aliases,
    src/io/config.cpp ParseTreeLearnerType)."""
    try:
        return _CANON[str(name).strip().lower()]
    except KeyError:
        raise ValueError(f"unknown tree_learner {name!r}") from None


def pool_partition_spec(strategy: str, scatter: bool) -> Tuple[str, ...]:
    """The axes the global [L, G, B, 3] histogram pool's column axis
    shards over under `strategy` (JAX: its PartitionSpec's column entry):
    none under psum (every shard the whole width), the row axes under
    scatter, the feature axis under feature sharding (feature-major,
    then the row axes, for data_feature under scatter).  Voting's own
    pool stays local to each shard whatever this says."""
    if strategy == "data":
        return ROW_AXES if scatter else ()
    if strategy == "feature":
        return (FEATURE,)
    if strategy == "data_feature":
        return (FEATURE,) + ROW_AXES if scatter else (FEATURE,)
    return ()


def bins_sharding(strategy: str) -> Tuple[str, ...]:
    """The axes the [G, n_pad] bins' row axis shards over: the row axes,
    or none (every row on every shard: the reference's all-data feature
    mode, feature_parallel_tree_learner.cpp:55-71)."""
    if strategy in ("data", "voting", "data_feature"):
        return ROW_AXES
    if strategy == "feature":
        return ()
    raise ValueError(strategy)


def rows_sharding(strategy: str) -> Tuple[str, ...]:
    """The axes [n_pad] row vectors shard over under `strategy`."""
    return ROW_AXES if strategy in ("data", "voting", "data_feature") \
        else ()


class _ShardRun:
    """One shard's thread: its context, result and error."""

    def __init__(self, ctx: ShardContext, fn: Callable):
        self.ctx, self.fn = ctx, fn
        self.out = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()

    def __call__(self):
        ctx = self.ctx
        enter_shard(ctx)
        try:
            if ctx.device.type == "cuda":
                with torch.cuda.device(ctx.device), \
                        torch.cuda.stream(ctx.stream):
                    self.out = self.fn(ctx)
            else:
                self.out = self.fn(ctx)
        except BaseException as exc:  # noqa: BLE001 - re-raised by caller
            self.error = exc
            ctx.group.abort(exc)
        finally:
            enter_shard(None)
            self.done.set()


def run_shards(topology: Topology, fn: Callable[[ShardContext], object],
               streams: Sequence, name: str = "grow",
               group: Optional[ShardGroup] = None) -> List[object]:
    """Run fn(ctx) once a shard of this process (`topology.local_ranks`),
    each in its own thread on its device and stream (`streams`, one a
    local shard), and return their results in rank order.  The shards'
    streams wait for the caller's work before they start, and the
    caller's streams for theirs after.  A shard that raises aborts the
    group: its peers' collectives raise `ShardAborted`, and the first
    shard's own error (or a `CollectiveTimeout`) is raised here.  group:
    a fresh `ShardGroup` of the topology to run in (one is made)."""
    from .collective import defaults

    group = ShardGroup(topology) if group is None else group
    runs = []
    for i, (rank, dev) in enumerate(zip(topology.local_ranks,
                                        topology.devices)):
        stream = streams[i]
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        runs.append(_ShardRun(ShardContext(group, rank, dev, stream), fn))
    threads = [threading.Thread(target=r, daemon=True,
                                name=f"lgbt-shard-{name}-{i}")
               for i, r in enumerate(runs)]
    for t in threads:
        t.start()
    timeout = float(defaults()["timeout_s"])
    give_up = None
    for r in runs:
        while not r.done.wait(0.05):
            # once the group failed, a shard still running (a hung one)
            # is waited for one deadline at most, then abandoned
            if group.failed is not None and timeout > 0:
                give_up = give_up or time.monotonic() + timeout
                if time.monotonic() > give_up:
                    break
    if group.failed is not None:
        errs = [r.error for r in runs if r.error is not None]
        own = [e for e in errs if not isinstance(e, ShardAborted)]
        err = own[0] if own else group.failed
        from .topology import note_failure

        # a peer process blocked in the group's transport then raises
        # HostDropped naming this one
        note_failure(err)
        raise err
    for r, stream in zip(runs, streams):
        if stream is not None:
            torch.cuda.current_stream(r.ctx.device).wait_stream(stream)
    return [r.out for r in runs]


class StrategyGrower:
    """`grow` of one strategy over its topology: the per-shard bins (and
    feature slices) of this process's shards are the learner's, placed
    once; each call splits the row vectors by row shard, runs the grower
    on every local shard and puts the out dict together on the first
    local shard's device.  The row vectors are global (every process
    holds every row), or, where the rows were placed per process, this
    process's row shards' rows only."""

    def __init__(self, params: G.GrowerParams, strategy: str,
                 topology: Topology, voting_k: int = 20):
        self.params = params
        self.strategy = strategy
        self.topology = topology
        self.voting_k = int(voting_k) if strategy == "voting" else 0
        self.data_axis = rows_sharding(strategy) or None
        self.feature_axis = FEATURE if strategy in (
            "feature", "data_feature") else None
        if strategy not in ("data", "voting", "feature", "data_feature"):
            raise ValueError(f"unknown strategy {strategy!r}")
        cuda = topology.devices[0].type == "cuda"
        self.streams = [torch.cuda.Stream(d) if cuda else None
                        for d in topology.devices]
        # the last tree's host seconds, collectives and each shard's
        # seconds waiting at the group's barrier
        self.last_stats: Dict[str, object] = {}

    def __call__(self, bins: Sequence[torch.Tensor],
                 hist_bins: Sequence[Optional[torch.Tensor]],
                 grad: torch.Tensor, hess: torch.Tensor,
                 row_mask: torch.Tensor, feature_mask: torch.Tensor,
                 metas: Sequence[Dict[str, torch.Tensor]], key) -> dict:
        t = self.topology
        rows = self.data_axis is not None
        parts = [self._split(v, rows) for v in (grad, hess, row_mask)]
        fmasks = {d: (feature_mask if feature_mask.device == d
                      else feature_mask.to(d)) for d in set(t.devices)}

        def one(ctx: ShardContext):
            r = ctx.rank - t.first
            return G.grow(self.params, bins[r], parts[0][r], parts[1][r],
                          parts[2][r], fmasks[ctx.device], metas[r], key,
                          data_axis=self.data_axis,
                          feature_axis=self.feature_axis,
                          voting_k=self.voting_k,
                          num_shards=t.data_shards,
                          hist_bins=hist_bins[r])

        group = ShardGroup(t)
        t0 = time.perf_counter()
        outs = run_shards(t, one, self.streams, group=group)
        first = outs[0]
        out = dict(first)
        dev0 = t.devices[0]
        t1 = time.perf_counter()
        if rows:
            # this process's row shards' leaf ids in row order (feature
            # shards of a row shard hold the same ids)
            fs = t.feature_shards
            out["leaf_ids"] = torch.cat(
                [outs[i]["leaf_ids"].to(dev0)
                 for i in range(0, t.local_size, fs)])
            if t.processes > 1 and not t.partitioned_rows:
                # every process holds every row: reassemble the global
                # leaf ids on each (learner.py:1356-1368)
                from .topology import host_device_allgather

                out["leaf_ids"] = host_device_allgather(
                    out["leaf_ids"], name="leaf_id_allgather")
        self.last_stats = {"wall_s": time.perf_counter() - t0,
                           "collectives": group.collectives,
                           "wait_s": list(group.wait_s),
                           "proc_collectives": group.proc_collectives,
                           "proc_s": group.proc_s,
                           "proc_bytes": group.proc_bytes,
                           "leaf_gather_s": time.perf_counter() - t1}
        out["shard_leaf_ids"] = [o["leaf_ids"] for o in outs]
        out["buffer_bytes"] = {
            k: sum(o["buffer_bytes"][k] for o in outs)
            for k in first["buffer_bytes"]}
        return out

    def _split(self, v: torch.Tensor, rows: bool) -> List[torch.Tensor]:
        """Each local shard's part of a row vector: its row shard's slice
        (a view where it lives on the vector's device), or the whole
        vector.  The vector spans every row shard ([n_pad]), or, where
        the rows were placed per process, this process's row shards
        only."""
        t = self.topology
        local = t.processes > 1 and t.partitioned_rows
        P = t.data_shards // t.processes if local else t.data_shards
        r0 = t.row_shard(t.first) if local else 0
        w = v.shape[0] // P if rows else v.shape[0]
        out = []
        for rank, dev in zip(t.local_ranks, t.devices):
            part = v.narrow(0, (t.row_shard(rank) - r0) * w, w) if rows \
                else v
            out.append(part if part.device == dev else part.to(dev))
        return out


def make_strategy_grower(params: G.GrowerParams, strategy: str,
                         topology: Optional[Topology] = None,
                         voting_k: int = 20):
    """The grower of `strategy` (serial: `ops/grower.py:grow` itself)."""
    if strategy == "serial" or topology is None:
        return G.grow
    return StrategyGrower(params, strategy, topology, voting_k)
