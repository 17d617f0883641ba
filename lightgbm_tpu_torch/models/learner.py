"""The tree learner: lays the bins out for the grower, replays trees.

The port of the serial, dense subset of
`lightgbm_tpu/models/learner.py:TPUTreeLearner`, numerical and
categorical features: the padded layout
(`f_pad`, `n_pad` with the same shape bucketing), the per-feature meta
arrays, `_resolve_hist_impl`, the fused per-iteration train step with
its bagging, GOSS and feature_fraction prologue, the synchronous
`train` of custom gradients, DART and RF (its masks from numpy
generators), and `build_tree_from_records`, which turns a categorical
record's mask of the bins routed left into the tree's bitsets.

Histogram implementations: "pallas2" (the perfeature Pallas kernel in
the JAX package) means kernel B1 on a CUDA tensor and its plain twin on
the CPU.  "xla" computes the same function, so it rides the same path
with the XLA scan's row block.  "pallas" (the flat variant) means kernel
B4 on its 256-row blocks, with B1's twin.  "fused" (the grow megakernel)
means kernel B2 in every grower round for the int8/int16 precisions, and
rides "pallas2" for the float ones.  "auto" picks "fused" for int8/int16
and "pallas2" otherwise, where the JAX learner's perfeature kernel fits
its feature chunk's accumulator (`chunk_fits`), else "xla".  On the card
the learner first runs B2 against its twin on tiny operands, and raises
on any difference.

Bins are stored uint8 when every feature has 256 bins or fewer, else
int32 (the wide layout, learner.py:486 of the JAX package); the kernels
then read a 16-bit row-major copy, so more than 65,536 bins are refused.

Bins are stored 4-bit packed exactly where the JAX learner packs them
(learner.py:615-641): tpu_pack_bins=true, every feature at 16 bins or
fewer, no EFB bundles, impl "pallas"/"pallas2", a select-family
partition, and row blocks of a multiple of 256 rows that tile the padded
rows.  B1 and B4 read them packed.

EFB (enable_bundle, on by default) plans bundles as the JAX learner does
(learner.py:227-290): the features whose zero-bin share reaches
sparse_threshold are the candidates, `io.bundling.find_bundles` groups
them on the strided row sample, and a plan with a bundle of two or more
features replaces the feature columns by its bundle columns
(`apply_bundles`).  The bins then hold `num_columns` columns, padded to
`g_pad` (a multiple of 32, for the kernels), while the meta arrays and
the feature mask keep the features' axis, `f_pad` (the JAX learner's
feature width), and carry each feature's bundle_idx, bin_offset and
needs_fix.  A plan never fills a bundle past the widest feature's B bins,
so the bundle columns keep the bins' dtype.

Monotone constraints come from the Dataset (`feature_arrays()`); CEGB's
per-feature penalties are mapped onto the used features here, and its
state (the features used, and with lazy penalties the rows that paid for
each feature) lives on the learner for its lifetime, handed to each
tree's grower through `meta` and taken back from its output
(learner.py:69-88,810-830,1292-1342).  forcedsplits_filename is read
into BFS (leaf, feature, threshold bin) triples (`_parse_forced_splits`),
and forced splits form no EFB plan.  deterministic=true turns the float
precisions into "f64" (`resolve_precision`), which runs on the XLA
branch's impl.

tpu_sparse_threshold > 0 (learner.py:296-353,487-596 of the JAX
package; float precisions, enable_bundle=false, no forced splits:
`check_sparse_storage`) keeps the features whose share of rows off their
zero bin is at most the threshold out of the bins: their entries are
laid out back to back on the device (`_sparse_layout`), the dense
features' columns alone go to the kernels, and `hist_perm` maps the
features onto the merged histogram columns.

tree_learner data, feature, voting or data_feature with num_machines > 1
(learner.py:93-194,456-476,620-690 of the JAX package) shards the
learner over a (hosts, data, feature) grid (`parallel/`): a `machines`
list of several hosts first joins the process group
(`parallel/mesh.py:init_multihost`), whose processes are the hosts axis;
`resolve_strategy` and `resolve_hist_agg` as the JAX learner resolves
them, the feature axis padded to 32 columns a feature shard (and to the
row shards under scatter), the rows to a whole number of blocks a row
shard, and `_place_shards` puts each of this process's shards' bins on
its device; `_grow` runs `parallel/strategies.py`'s grower over them.
Under `pre_partition` in a group of several processes (`_partitioned`)
each process holds only its own rows: the row shards are sized from the
largest process's rows (`shard_rows_sync`), the row vectors span this
process's row shards (`row_width`), and the leaf ids are this process's
rows'.  Each shard has a meta dict of its own (`shard_metas`): its CEGB
state (`set_cegb_state`) and, with sparse storage under data or voting,
the COO tables of its row shard (`_shard_sparse`).  The per-node masks
are drawn over the JAX learner's width for the grid
(`_jax_feature_width`).  Lazy CEGB penalties are refused as the JAX
learner refuses them.  EFB bundles train under data as in the JAX
learner, the plan agreed across processes under pre_partition and,
under scatter, each shard searching the features of its bundle columns
(`scatter_feat`).
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.bundling import EFB_SAMPLE_ROWS, BundlePlan, apply_bundles, \
    find_bundles, find_bundles_multihost
from ..io.dataset import TrainingData
from ..ops import grower as G
from ..ops.fused import fused_supported, probe_fused
from ..ops.grower import GrowerParams, pad_rows, resolve_split_batch
from ..ops.histogram import (INT_PRECISIONS, MAX_WIDE_BINS, _dot_spec,
                             hashed_uniform, key_words, pack_bins,
                             row_major_bins)
from ..ops.predict import upload
from ..parallel import topology as topo
from ..parallel.mesh import available_devices, put_global, put_local
from ..parallel.strategies import (bins_sharding, make_strategy_grower,
                                   resolve_tree_learner)
from ..parallel.topology import resolve_hosts
from ..utils import membudget, prng, timer
from ..utils.log import Log
from .tree import Tree

HIST_IMPLS = ("auto", "pallas", "pallas2", "fused", "xla")
# VMEM budget of one feature chunk's accumulator block in the JAX
# package's perfeature Pallas kernel (its ops/histogram.py
# _PERFEATURE_OUT_BUDGET), which its "auto" rule tests
PERFEATURE_OUT_BUDGET = 6 * 1024 * 1024


def _to_bitset(values) -> list:
    """Int values -> uint32 bitset words, negatives dropped (reference
    Common::ConstructBitset, include/LightGBM/utils/common.h)."""
    vals = [int(v) for v in values if int(v) >= 0]
    if not vals:
        return [0]
    words = [0] * (max(vals) // 32 + 1)
    for v in vals:
        words[v // 32] |= 1 << (v % 32)
    return words


def check_slice(config: Config) -> None:
    """Refuse, by name, every parameter value outside the ported slice
    (the serial learner; the gbdt, goss, dart and rf boosting modes with
    bagging and per-tree and per-node feature sampling; float, f64
    (deterministic=true) and int8/int16 histograms; monotone
    constraints, CEGB and forced splits).  The numeric guard, the
    device-memory preflight and budget are taken by models/gbdt.py, the
    telemetry knobs by obs/trace.py."""

    def refuse(what: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported to lightgbm_tpu_torch yet")

    c = config
    if str(c.boosting) not in ("gbdt", "goss", "dart", "rf",
                               "random_forest"):
        refuse(f"boosting={c.boosting!r}")
    _dot_spec(str(c.tpu_hist_precision))
    if str(c.tpu_hist_impl) not in HIST_IMPLS:
        refuse(f"tpu_hist_impl={c.tpu_hist_impl!r}")
    if str(c.tpu_partition_impl) not in G.PARTITION_IMPLS:
        refuse(f"tpu_partition_impl={c.tpu_partition_impl!r}")


def resolve_strategy(config: Config) -> Tuple[str, int, int, int, int]:
    """(strategy, shards, hosts, feature shards, row shards) of a config
    (learner.py:93-173 of the JAX package): tree_learner's canonical
    name; a parallel learner with num_machines <= 1 trains serially, with
    a warning; data_feature factors the shards into tpu_feature_shards
    feature shards (auto: 2 where the count factors) times row shards;
    feature across more than one host becomes data_feature with one row
    shard a host; data and voting shard rows only."""
    strategy = resolve_tree_learner(config.tree_learner)
    n_shards = int(config.num_machines)
    if strategy != "serial" and n_shards <= 1:
        Log.warning(f"tree_learner={strategy} needs num_machines>1; "
                    "falling back to serial")
        strategy = "serial"
    if strategy == "serial":
        return strategy, 1, 1, 1, 1
    hosts = resolve_hosts(int(config.tpu_topology_hosts))
    if strategy == "data_feature":
        fs = int(config.tpu_feature_shards)
        if fs <= 0:
            fs = 2 if (n_shards % 2 == 0 and n_shards > 2) else 1
        if n_shards % fs != 0:
            raise ValueError(f"tpu_feature_shards={fs} must divide "
                             f"num_machines={n_shards}")
        return strategy, n_shards, hosts, fs, n_shards // fs
    if strategy == "feature":
        if hosts > 1:
            # no host holds every row once the hosts axis is real: one row
            # shard a host, its devices shard the features
            if n_shards % hosts != 0:
                raise ValueError(
                    f"num_machines={n_shards} must split evenly across "
                    f"{hosts} hosts for tree_learner=feature")
            return "data_feature", n_shards, hosts, n_shards // hosts, hosts
        return strategy, n_shards, hosts, n_shards, 1
    return strategy, n_shards, hosts, 1, n_shards


def resolve_hist_agg(config: Config, strategy: str, d_shards: int) -> str:
    """The row axes' histogram aggregation (learner.py:894-910): auto is
    scatter wherever the data axis spans more than one shard, psum
    everywhere else."""
    agg = str(config.tpu_hist_agg)
    if agg not in ("auto", "psum", "scatter"):
        raise ValueError(f"tpu_hist_agg={agg!r}; expected one of "
                         "('auto', 'psum', 'scatter')")
    if strategy in ("data", "voting", "data_feature") and d_shards > 1:
        return "scatter" if agg in ("auto", "scatter") else "psum"
    return "psum"


# tree_learner names of the strategies that shard rows (the JAX package's
# parallel/strategies.py:_CANON); sparse storage takes these and serial
_ROW_STRATEGIES = ("serial", "data", "data_parallel", "voting",
                   "voting_parallel")


def check_sparse_storage(config: Config, precision: str, tree_learner: str,
                         forced: bool) -> None:
    """The JAX learner's refusals of sparse train-time storage
    (learner.py:303-325), in its order and with its texts."""
    if precision in INT_PRECISIONS:
        # the zero-bin reconstruction mixes histogram rows with leaf
        # totals; the integer domain is not covered
        raise ValueError(
            "tpu_sparse_threshold does not compose with quantized "
            "histogram precisions (tpu_hist_precision=int8|int16)")
    if bool(config.enable_bundle):
        # a refusal on the flag, not on whether a plan formed
        raise ValueError(
            "tpu_sparse_threshold requires enable_bundle=false "
            "(EFB already re-columns sparse features; pick one)")
    if tree_learner not in _ROW_STRATEGIES:
        raise NotImplementedError(
            "tpu_sparse_threshold requires tree_learner=serial, "
            "data, or voting (feature sharding replicates rows)")
    if forced:
        raise ValueError("tpu_sparse_threshold does not compose "
                         "with forced splits")


class TreeLearner:
    """The learner: device bin layout (one device, or the shards of a
    parallel learner) + grower + tree replay."""

    # StreamedTreeLearner: the bins stay in host blocks (ops/stream.py)
    stream_layout = False

    def __init__(self, config: Config, train_data: TrainingData):
        check_slice(config)
        if (resolve_tree_learner(config.tree_learner) != "serial"
                and str(config.machines)):
            # a machine list joins the process group first (the
            # Linkers-socket rendezvous role, learner.py:98-108)
            from ..parallel.mesh import init_multihost

            init_multihost(str(config.machines),
                           int(config.local_listen_port),
                           int(config.num_machines))
        # the parallel learners (learner.py:93-173, 894-910): the strategy,
        # its (hosts, data, feature) grid and the row axes' aggregation
        (self.strategy, self.n_shards, self.hosts, self.f_shards,
         self.d_shards) = resolve_strategy(config)
        self.hist_agg = resolve_hist_agg(config, self.strategy,
                                         self.d_shards)
        sharded = self.strategy != "serial"
        procs = topo.process_count()
        if sharded and procs > 1 and self.hosts != procs:
            raise ValueError(
                f"tpu_topology_hosts={self.hosts} disagrees with the live "
                f"process count {procs}; leave it 0 (auto) "
                "on real multi-host meshes")
        # pre-partitioned rows (learner.py:176-194): each process holds
        # only its own row shards' rows.  The JAX learner's other check
        # there, num_machines against the device count, has no
        # counterpart: shards may share a device here
        self._partitioned = (bool(config.pre_partition) and sharded
                             and procs > 1)
        if self._partitioned:
            if self.d_shards % procs != 0:
                raise ValueError("row shards must split evenly across "
                                 "processes for pre_partition")
        self.topology = None
        self.shard_metas = None
        self.config = config
        self.td = train_data
        self.device = train_data.device
        n = train_data.num_data
        self.n = n
        self.num_features = train_data.num_features
        if self.num_features == 0:
            raise ValueError("no usable features in training data")
        meta_np = dict(train_data.feature_arrays())
        # CEGB's per-feature penalties, mapped onto the used features
        # (learner.py:69-88); all-zero lists charge nothing and leave the
        # machinery off
        coupled_raw = [float(v) for v in config.cegb_penalty_feature_coupled]
        lazy_raw = [float(v) for v in config.cegb_penalty_feature_lazy]
        meta_np["cegb_coupled"] = self._per_feature(coupled_raw, train_data)
        meta_np["cegb_lazy"] = self._per_feature(lazy_raw, train_data)
        has_cegb_lazy = any(v != 0.0 for v in lazy_raw)
        has_cegb = (any(v != 0.0 for v in coupled_raw) or has_cegb_lazy
                    or float(config.cegb_penalty_split) != 0.0)
        self.meta_np = meta_np
        forced = self._parse_forced_splits(config, train_data)
        B = int(meta_np["num_bin"].max())
        self.num_bins = B
        if B > MAX_WIDE_BINS:
            raise NotImplementedError(
                f"max_bin={config.max_bin} (features with more than "
                f"{MAX_WIDE_BINS} bins) is not ported to lightgbm_tpu_torch "
                "yet: its kernels read wide bins as 16-bit values")
        F = self.num_features
        # the layout phase (learner.py:222-761): everything from the EFB
        # plan to the placed device tensors
        t0 = time.perf_counter()
        # no plan under forced splits (learner.py:239); the voting and
        # feature learners train unbundled (learner.py:228-237)
        bundling = self.strategy in ("serial", "data")
        if not bundling and bool(config.enable_bundle) and F > 1:
            Log.info(f"EFB bundling is inactive under tree_learner="
                     f"{self.strategy}; training on plain columns")
        plan = None if forced or not bundling else self._plan_bundles(
            config, train_data, meta_np["num_bin"], B, self._partitioned)
        self.bundle_plan = plan
        # host seconds of the EFB plan and of making its bundle columns
        self.efb_s = {"plan": time.perf_counter() - t0, "apply": 0.0}
        if plan is not None:
            Log.info(f"EFB: bundled {F} features into {plan.num_columns} "
                     "columns")
            meta_np["bundle_idx"] = plan.bundle_idx.astype(np.int32)
            meta_np["bin_offset"] = plan.bin_offset.astype(np.int32)
            meta_np["needs_fix"] = plan.needs_fix.astype(np.int32)
        self.num_columns = F if plan is None else plan.num_columns

        precision = self.resolve_precision(config)
        # sparse train-time storage: the features whose share of rows off
        # their zero bin is at most tpu_sparse_threshold keep only those
        # rows' (row, bin) pairs (learner.py:296-353)
        sparse_mask = None
        sth = float(config.tpu_sparse_threshold)
        if sth > 0.0:
            check_sparse_storage(config, precision, self.strategy,
                                 bool(forced))
            nz_counts = train_data.column_nonzero_counts(
                meta_np["default_bin"])
            nz_all, denom = nz_counts, n
            if self._partitioned:
                # every process must pick the same sparse features: from
                # the global shares (learner.py:330-340)
                tot = topo.host_allgather(
                    np.concatenate([nz_counts, [n]]).astype(np.int32),
                    name="sparse_global_fractions").sum(axis=0)
                nz_all, denom = tot[:-1], int(tot[-1])
            nz_frac = nz_all / max(denom, 1)
            sp_mask = nz_frac <= sth
            if sp_mask.all():
                # the dense histogram needs a column: the densest stays
                sp_mask[int(np.argmax(nz_frac))] = False
            if sp_mask.any():
                sparse_mask = sp_mask
        # a persisted autotune profile (utils/autotune.py,
        # learner.py:359-370 of the JAX package): its measured winners
        # replace the "auto" rule for this shape bucket; a stale profile
        # raises AutotuneStaleProfile here
        self._autotune_entry = None
        if str(config.tpu_autotune) != "off":
            from ..utils.autotune import resolve_autotune

            self._autotune_entry = resolve_autotune(
                config, n, self.num_features, B, precision, self.device)
        impl, block = self._resolve_hist_impl(config, precision, B,
                                              self._autotune_entry)
        # the JAX package pads the column axis to a multiple of 32 for its
        # perfeature kernel, and the port's kernels take chunks of 32
        # columns; padding columns hold bin 0 (num_bin=1) and can never
        # split
        # a feature shard's slice is a kernel operand too: the axis pads
        # to 32 columns a feature shard (learner.py:371-386)
        col_align = 32 * self.f_shards
        self.g_pad = -(-self.num_columns // col_align) * col_align
        buckets = int(config.tpu_shape_buckets)

        def bucket_up(count: int, quantum: int) -> int:
            padded = -(-count // quantum) * quantum
            if buckets <= 0:
                return padded
            q = quantum
            while q * buckets < padded:
                q *= 2
            return -(-count // q) * q

        def bucket_rows(count: int) -> int:
            eff = min(block, max(count, 1))
            base = pad_rows(count, block)
            if buckets <= 0:
                return base
            if base >= block:
                return bucket_up(base // eff, 1) * eff
            return min(bucket_up(count, 128), block)

        # sharded: every row shard an equal, whole number of blocks
        self.n_pad = (bucket_rows(n) if self.d_shards == 1 else
                      bucket_rows(-(-n // self.d_shards)) * self.d_shards)
        # the row vectors' width: every row, or under pre_partition this
        # process's row shards, sized from the largest process's rows
        # (learner.py:422-433)
        self.row_width = self.n_pad
        if self._partitioned:
            shards_local = self.d_shards // procs
            ns = topo.host_allgather(np.asarray([n], np.int32),
                                     name="shard_rows_sync")
            max_shard_rows = -(-int(ns.max()) // shards_local)
            self.n_pad = bucket_rows(max_shard_rows) * self.d_shards
            self.row_width = (self.n_pad // self.d_shards) * shards_local
        if buckets > 0:
            self.g_pad = bucket_up(self.g_pad, col_align)
        if self.hist_agg == "scatter" and self.strategy != "voting":
            # the reduce-scatter hands each row shard a contiguous 1/P
            # column slice of each feature shard's (learner.py:456-476)
            a = math.lcm(col_align, self.f_shards * self.d_shards)
            self.g_pad = -(-self.g_pad // a) * a
        # the feature axis the JAX learner pads to: its grower draws the
        # per-node feature masks over that width, so the port draws over
        # it too
        self.draw_width = self._jax_feature_width(bucket_up, impl,
                                                  plan is not None)
        # the features' axis of the meta arrays and the feature mask:
        # without bundles the columns, else the JAX learner's (no kernel
        # reads it)
        self.f_pad = self.g_pad if plan is None else self.draw_width
        # the pack layout's blocks are the grower's: min(block, n_pad) of
        # a row shard's rows (learner.py:623-634)
        local_rows = self.n_pad // self.d_shards
        eff_block = min(block, local_rows)
        self.packed_bins = self._would_pack(
            config, B, impl, eff_block, local_rows,
            plan is not None or sparse_mask is not None
            or self.stream_layout)
        # rows of a packed block (0: bins unpacked), as the kernels take it
        self.packed_block = eff_block if self.packed_bins else 0

        dev = self.device
        self.sparse = None
        sparse_meta = {}
        if sparse_mask is not None:
            # the dense columns alone go to the kernels, padded to 32
            sparse_meta = self._sparse_layout(train_data, sparse_mask,
                                              nz_counts, meta_np, B)
            self.g_pad = -(-self.num_columns // 32) * 32
        self._place_bins(train_data, plan, sparse_mask, B, block, eff_block)
        ones = torch.zeros(self.row_width, dtype=torch.float32, device=dev)
        ones[:n] = 1.0
        self._ones_mask = ones
        self.feature_mask = torch.zeros(self.f_pad, dtype=torch.float32,
                                        device=dev)
        self.feature_mask[:self.num_features] = 1.0
        meta = {}
        for k, v in meta_np.items():
            pad_val = 1 if k == "num_bin" else (1.0 if k == "penalty" else 0)
            v = np.concatenate([v, np.full(self.f_pad - self.num_features,
                                           pad_val, dtype=v.dtype)])
            meta[k] = torch.as_tensor(
                v if v.dtype == np.float32 else v.astype(np.int32),
                device=dev)
        if sparse_mask is not None:
            # the COO tables and the feature -> histogram column map ride
            # meta beside the per-feature arrays (learner.py:713-741)
            perm = np.full(self.f_pad, min(self.num_columns, self.g_pad - 1),
                           np.int64)
            perm[self.sparse["dense_idx"]] = np.arange(self.num_columns)
            perm[self.sparse["sparse_idx"]] = self.g_pad + np.arange(
                len(self.sparse["sparse_idx"]))
            meta["hist_perm"] = torch.as_tensor(perm, device=dev)
            meta.update(sparse_meta)
        if sharded and plan is not None and self.hist_agg == "scatter":
            # EFB under scatter (learner.py:745-760): shard d holds the
            # bundle columns [d*SG, (d+1)*SG) and searches the features
            # bundled into them; each row ascending (the shard's argmax
            # keeps the lowest feature id of a tie), -1 padded
            sgc = self.g_pad // self.d_shards
            bidx = meta_np["bundle_idx"][:F]
            by_shard = [np.sort(np.flatnonzero(bidx // sgc == d))
                        for d in range(self.d_shards)]
            sf = np.full((self.d_shards,
                          max(1, max(len(x) for x in by_shard))), -1,
                         np.int32)
            for d, x in enumerate(by_shard):
                sf[d, :len(x)] = x
            meta["scatter_feat"] = torch.as_tensor(sf, device=dev)
        self.meta = meta
        if sharded:
            self._place_shards()
        else:
            topo.activate(None)
        timer.add("layout", time.perf_counter() - t0)
        self.params = GrowerParams(
            num_leaves=max(int(config.num_leaves), 2),
            num_bins=B,
            precision=precision,
            l1=float(config.lambda_l1),
            l2=float(config.lambda_l2),
            max_delta_step=float(config.max_delta_step),
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian=float(config.min_sum_hessian_in_leaf),
            min_gain_to_split=float(config.min_gain_to_split),
            max_depth=int(config.max_depth),
            has_cat=bool(meta_np["is_categorical"].any()),
            cat_bins=int(meta_np["num_bin"][meta_np["is_categorical"] > 0]
                         .max(initial=0)),
            max_cat_threshold=int(config.max_cat_threshold),
            cat_l2=float(config.cat_l2),
            cat_smooth=float(config.cat_smooth),
            max_cat_to_onehot=int(config.max_cat_to_onehot),
            min_data_per_group=float(config.min_data_per_group),
            split_batch=resolve_split_batch(int(config.tpu_split_batch),
                                            int(config.num_leaves)),
            split_batch_alpha=float(config.tpu_split_batch_alpha),
            partition_impl=str(config.tpu_partition_impl),
            ramp=bool(config.tpu_ramp),
            ramp_step=(4 if str(config.tpu_bucket_policy) == "wide"
                       else 2),
            hist_impl=impl,
            packed_bins=self.packed_bins,
            block_rows=block,
            quant_round=str(config.tpu_quant_round),
            quant_refit=(precision in INT_PRECISIONS
                         and bool(config.tpu_quant_refit_leaves)),
            feature_fraction_bynode=float(config.feature_fraction_bynode),
            bynode_width=self.draw_width,
            has_bundles=plan is not None,
            has_sparse=sparse_mask is not None,
            sparse_window=(0 if self.sparse is None
                           else self.sparse["window"]),
            has_cegb=has_cegb,
            has_cegb_lazy=has_cegb_lazy,
            cegb_tradeoff=float(config.cegb_tradeoff),
            cegb_penalty_split=float(config.cegb_penalty_split),
            forced=forced,
            has_mono=bool(np.any(meta_np["monotone"] != 0)),
            hist_agg=self.hist_agg)
        if has_cegb_lazy and sharded:
            # learner.py:810-815: the paid matrix of a row-sharded
            # learner would need a collective of its own
            raise NotImplementedError(
                "cegb_penalty_feature_lazy requires tree_learner=serial")
        # the JAX grower's refusals, at set-up as there
        G.check_params(self.params)
        # refit leaves: the trees take their leaf values from the grower's
        # refitted outputs, not from the split records
        self.refits_leaves = self.params.quant_refit
        # under feature_fraction_bynode, with categorical features or with
        # bundles the grower never runs B2's scan, nor on the streamed
        # layout
        if impl == "fused" and dev.type == "cuda" and not self.stream_layout \
                and not sharded and fused_supported(
                precision,
                bynode=self.params.feature_fraction_bynode < 1.0,
                has_cat=self.params.has_cat, has_bundles=plan is not None,
                has_cegb=has_cegb, forced=bool(forced)) is None:
            probe_fused(dev, precision, wide=B > 256)
        if has_cegb:
            # the CEGB state of the learner's lifetime (learner.py:810-830):
            # the features any split has used, and with lazy penalties
            # which rows have paid for which feature (bool, [f_pad, n_pad])
            state = {"cegb_used": torch.zeros(self.f_pad, dtype=torch.float32,
                                              device=dev)}
            if has_cegb_lazy:
                state["cegb_paid"] = torch.zeros(
                    (self.f_pad, self.n_pad), dtype=torch.bool, device=dev)
            self.set_cegb_state(state)
        # the sharded learners' grower: every shard runs ops/grower.py's
        # grow in its own thread (parallel/strategies.py)
        self._strategy_grow = make_strategy_grower(
            self.params, self.strategy, self.topology, int(config.top_k))
        # host waits of the last grown tree (grower stop tests)
        self.last_syncs = 0
        # bytes of the last tree's pool and stat planes
        # (utils/membudget.py:live_bytes)
        self.last_buffers = {}
        # the sync path's per-tree feature_fraction draws and tree keys
        # (learner.py:860)
        self._feature_rng = np.random.default_rng(
            int(config.feature_fraction_seed))

    def _place_bins(self, train_data: TrainingData, plan, sparse_mask,
                    B: int, block: int, eff_block: int) -> None:
        """Lay the [g_pad, n_pad] bins out on the device (learner.py:
        _place_serial_bins of the JAX package): the dataset's columns,
        its dense columns under sparse storage or the EFB bundle
        columns, 4-bit packed where the layout packs, and on the card
        the kernels' row-major copy."""
        dev = self.device
        n, F = self.n, self.num_features
        # uint8 when every feature fits a byte, else int32, as the JAX
        # learner stores them (learner.py:486)
        bins_t = torch.zeros((self.g_pad, self.row_width),
                             dtype=torch.uint8 if B <= 256 else torch.int32,
                             device=dev)
        if sparse_mask is not None:
            bins_t[:self.num_columns, :n] = train_data.bins_t[
                torch.as_tensor(self.sparse["dense_idx"], device=dev)]
        elif plan is None:
            bins_t[:F, :n] = train_data.bins_t
        else:
            # [n, G] int32 bundle columns of the host matrix
            t0 = time.perf_counter()
            cols = apply_bundles(train_data.bins, plan)
            bins_t[:self.num_columns, :n] = torch.from_numpy(cols.T).to(
                device=dev, dtype=bins_t.dtype)
            del cols
            self.efb_s["apply"] = time.perf_counter() - t0
        if self.packed_bins:
            # [f_pad, n_pad/2]: two rows a byte (reference
            # dense_nbits_bin.hpp), the JAX learner's per-block layout
            bins_t = pack_bins(bins_t, eff_block)
        self.bins_t = bins_t
        if dev.type == "cuda" and self.strategy == "serial":
            # kernels B1, B2 and B4 gather each live row's bins from a
            # row-major copy ([n_pad, 32] uint8 at up to 32 columns,
            # [n_pad, 16] packed, or [n_pad, 32] 16-bit for int32 bins);
            # row_major_bins makes it here, at
            # set-up, and keeps it on bins_t for every later call
            row_major_bins(bins_t, self.packed_block)

    def _place_shards(self) -> None:
        """The sharded learners' placement (learner.py:645-690 of the JAX
        package, the roles of `put_global` and `put_local`): the (hosts,
        data, feature) grid, this process's shard i on ``cuda:(i %
        cards)`` (or the CPU); each local shard's bins, its row shard's
        columns or, where the rows are not sharded, the whole matrix (one
        copy a device); under a feature axis its own [F/P, rows] slice
        for the histograms; the kernels' row-major copy of each, made
        here before any shard thread runs; and the meta arrays on each
        shard's device.  The process's matrix goes."""
        procs = topo.process_count()
        local = self.n_shards // procs
        devices = topo.shard_devices(local, self.device)
        held = len(set(devices))
        if local > held:
            where = ("card" if self.device.type == "cuda" else "CPU")
            Log.warning(
                f"tree_learner={self.strategy}: {local} shards on "
                f"{held} {where}{'s' if held > 1 else ''} of "
                f"{available_devices()}; shards share a device (a "
                f"simulated grid of {self.hosts} host(s))")
        t = topo.make_topology(self.d_shards, self.f_shards, self.hosts,
                               partitioned_rows=self._partitioned,
                               devices=devices)
        self.topology = t
        topo.activate(t)
        axes = bins_sharding(self.strategy)
        bins = (put_local(self.bins_t, t, (self.g_pad, self.n_pad), axes)
                if self._partitioned else put_global(self.bins_t, t, axes))
        hist = [None] * t.local_size
        if self.f_shards > 1:
            F = self.g_pad // self.f_shards
            made = {}
            for r, b in enumerate(bins):
                lo = t.coords(t.first + r)[topo.FEATURE] * F
                key = (b.data_ptr(), str(b.device), lo)
                if key not in made:
                    made[key] = b[lo:lo + F].contiguous()
                hist[r] = made[key]
        if self.device.type == "cuda":
            ops = {x.data_ptr(): x for x in
                   (h if h is not None else b for h, b in zip(hist, bins))}
            for x in ops.values():
                row_major_bins(x, self.packed_block)
        metas = {d: (self.meta if d == self.device else
                     {k: v.to(d) for k, v in self.meta.items()})
                 for d in set(t.devices)}
        self.shard_bins, self.shard_hist_bins = bins, hist
        # a meta dict a shard: its sparse tables and its CEGB state are
        # its own
        self.shard_metas = [dict(metas[d]) for d in t.devices]
        if self.sparse is not None:
            for m, tables in zip(self.shard_metas, self._shard_sparse(t)):
                m.update({k: v.to(m["num_bin"].device)
                          for k, v in tables.items()})
        self.bins_t = None

    def _shard_sparse(self, t) -> list:
        """Each local row shard's COO tables (learner.py:527-560 of the
        JAX package): the entries of its rows, in the (feature, row) order
        of the learner's tables, with shard-local row ids, and their
        offsets; the partition's window becomes the longest feature's
        entries in any row shard (under pre_partition, of any process:
        `sparse_table_width`)."""
        m = self.meta
        rps = self.n_pad // self.d_shards
        rows = m["sp_rows"].long()
        slot = m["sp_key"].long() // self.num_bins
        Gs = m["sp_off"].shape[0] - 1
        # the row shards the learner's rows span, from its first one's
        r0 = t.row_shard(t.first) if self._partitioned else 0
        span = self.row_width // rps
        shard = rows // rps
        counts = torch.bincount(shard * Gs + slot,
                                minlength=span * Gs).reshape(span, Gs)
        window = int(counts.max()) if counts.numel() else 0
        if self._partitioned:
            window = int(topo.host_allgather(
                np.asarray([window], np.int32),
                name="sparse_table_width").max())
        self.sparse["window"] = max(window, 1)
        out = []
        for rank in t.local_ranks:
            s = t.row_shard(rank) - r0
            keep = shard == s
            off = torch.zeros(Gs + 1, dtype=torch.int64, device=rows.device)
            off[1:] = torch.cumsum(counts[s], 0)
            out.append({"sp_rows": (rows[keep] - s * rps).to(torch.int32),
                        "sp_key": m["sp_key"][keep], "sp_off": off})
        return out

    def set_cegb_state(self, state: dict) -> None:
        """The CEGB state the next tree starts from (learner.py:
        1337-1342) on the learner's meta and, sharded, on every shard's:
        a copy a shard on its device, which its grower updates from the
        synced records, so the copies stay equal."""
        self.meta.update(state)
        for m in self.shard_metas or ():
            dev = m["num_bin"].device
            m.update({k: v.to(dev, copy=True) for k, v in state.items()})

    def _jax_feature_width(self, bucket_up, impl: str, bundled: bool) -> int:
        """The feature axis the JAX learner pads to for this layout
        (learner.py:215-220, 371-386, 445-476): the features padded to
        the feature-shard count, then to 32 a feature shard (32 without
        feature shards and bundles) under its perfeature and fused
        kernels, bucketed with the columns where the two widths meet
        (the perfeature kernel's to 32 a feature shard, the others' to
        the shard count or 8), and under scatter to the grid's shard
        count (with 32 a feature shard for the perfeature kernel); with
        bundles only the bundle columns take the kernels' and the
        scatter's alignments."""
        fs = self.f_shards
        f = -(-self.num_features // fs) * fs
        g = f if fs > 1 else self.num_columns
        if impl in ("pallas2", "fused"):
            if fs > 1:
                f = g = -(-f // (32 * fs)) * (32 * fs)
            elif not bundled:
                f = g = -(-f // 32) * 32
            else:
                g = -(-g // 32) * 32
        if int(self.config.tpu_shape_buckets) > 0 and g == f:
            f = bucket_up(f, (32 * fs) if impl == "pallas2"
                          else (fs if fs > 1 else 8))
        if (self.hist_agg == "scatter" and self.strategy != "voting"
                and not bundled):
            a = fs * self.d_shards
            if impl == "pallas2":
                a = math.lcm(a, 32 * fs)
            f = -(-f // a) * a
        return f

    # ------------------------------------------------------------------
    @staticmethod
    def _per_feature(raw, td: TrainingData) -> np.ndarray:
        """A per-column parameter list mapped onto the used features
        (learner.py:72-77); columns past its end take 0."""
        vals = np.zeros(td.num_features, np.float32)
        for j, col in enumerate(td.used_feature_idx):
            if col < len(raw):
                vals[j] = raw[col]
        return vals

    @staticmethod
    def resolve_precision(config: Config) -> str:
        """The histogram precision, honoring deterministic=true
        (learner.py:996-1015): int8/int16 are order-free already and stay;
        the float precisions become "f64", which takes the XLA branch
        (here `histogram.hist_batched_f64`) and refuses the Pallas impls.
        torch has no process-wide switch to flip, unlike JAX's x64.
        "f64" given without deterministic=true is a ValueError: the JAX
        learner fails so in a process without x64 (its f64 pool meets
        f32 histograms)."""
        precision = str(config.tpu_hist_precision)
        if not bool(config.deterministic):
            if precision == "f64":
                raise ValueError("tpu_hist_precision=f64 is the precision "
                                 "of deterministic=true; set that instead")
            return precision
        if precision in INT_PRECISIONS:
            return precision
        if str(config.tpu_hist_impl) in ("pallas", "pallas2", "fused"):
            raise ValueError("deterministic=true requires tpu_hist_impl=xla")
        return "f64"

    @staticmethod
    def _parse_forced_splits(config: Config, td: TrainingData) -> tuple:
        """forcedsplits_filename's JSON -> BFS (parent_leaf, feature,
        threshold bin) triples (learner.py:1017-1060; the reference's
        ForceSplits reads the same nested {feature, threshold, left,
        right} objects, serial_tree_learner.cpp:617-669), at most
        num_leaves - 1 of them.  The left child keeps its parent's leaf
        id, the right one takes the next new leaf's."""
        path = str(config.forcedsplits_filename or "")
        if not path:
            return ()
        import json

        from ..io.bin_mapper import BinType

        with open(path) as f:
            root = json.load(f)
        pos_of = {col: j for j, col in enumerate(td.used_feature_idx)}
        out = []
        queue = [(root, 0)]
        while queue and len(out) < max(int(config.num_leaves) - 1, 0):
            node, leaf = queue.pop(0)
            real_f = int(node["feature"])
            if real_f not in pos_of:
                raise ValueError(
                    f"forced split on unused/trivial feature {real_f}")
            mapper = td.mappers[real_f]
            if mapper.bin_type != BinType.NUMERICAL:
                raise NotImplementedError(
                    "forced splits on categorical features are not "
                    "supported")
            thr_bin = int(mapper.value_to_bin(float(node["threshold"])))
            i = len(out)
            out.append((leaf, pos_of[real_f], thr_bin))
            for side, child_leaf in (("left", leaf), ("right", i + 1)):
                child = node.get(side)
                if isinstance(child, dict) and "feature" in child:
                    queue.append((child, child_leaf))
        return tuple(out)

    @staticmethod
    def _plan_bundles(config: Config, td: TrainingData, num_bin: np.ndarray,
                      B: int, partitioned: bool = False
                      ) -> Optional[BundlePlan]:
        """The JAX learner's EFB plan (learner.py:227-271), or None: the
        features whose zero-bin share reaches sparse_threshold (and with
        at most B bins) are the candidates, grouped on the strided row
        sample; a plan of singletons alone is no plan.  Under
        pre_partition every process must group the same plan: the
        statistics and the sample reduce across processes
        (`find_bundles_multihost`)."""
        if not bool(config.enable_bundle) or td.num_features <= 1:
            return None
        if partitioned:
            plan = find_bundles_multihost(
                td.bins, num_bin, td.column_zero_fraction(), td.num_data,
                float(config.sparse_threshold),
                float(config.max_conflict_rate), B)
        else:
            plan = find_bundles(
                td.strided_row_sample(EFB_SAMPLE_ROWS), num_bin,
                td.column_zero_fraction() >= float(config.sparse_threshold),
                float(config.max_conflict_rate), B,
                sample_rows=EFB_SAMPLE_ROWS)
        return None if plan.is_trivial else plan

    def _sparse_layout(self, td: TrainingData, sparse_mask: np.ndarray,
                       nz_counts: np.ndarray, meta_np: dict, B: int
                       ) -> dict:
        """The sparse features' COO entries and the feature maps
        (learner.py:487-596 of the JAX package), built on the device from
        the dataset's bins.  The JAX package pads each sparse feature's
        entries to the longest one's ([Gs, M]); here they lie back to
        back, sorted by (feature, row), with each feature's start in
        `sp_off` [Gs + 1]: `sp_rows` [E] int32 holds the row and `sp_key`
        [E] int32 the feature's slot times B plus the bin; `nz_counts`
        [F] (`column_nonzero_counts`) gives each feature's entries.  Sets
        `self.sparse` (the index lists, the longest feature's entries
        `window`, the bytes of each part) and `num_columns` (the dense
        columns); adds is_sparse, sparse_slot, dense_col and dense_ref
        to meta_np and returns the tables for meta."""
        dev = self.device
        n = td.num_data
        dense_idx = np.flatnonzero(~sparse_mask)
        sparse_idx = np.flatnonzero(sparse_mask)
        gd, Gs = len(dense_idx), len(sparse_idx)
        zb = torch.as_tensor(meta_np["default_bin"], device=dev).to(
            td.bins_t.dtype)
        # column blocks of at most 2^26 bins bound the temporaries
        step = max((1 << 26) // max(n, 1), 1)
        rows, keys = [], []
        for lo in range(0, Gs, step):
            cols = torch.as_tensor(sparse_idx[lo:lo + step], device=dev)
            sub = td.bins_t[cols]                               # [blk, n]
            g_i, r_i = (sub != zb[cols][:, None]).nonzero(as_tuple=True)
            rows.append(r_i.to(torch.int32))
            keys.append(((g_i + lo) * B + sub[g_i, r_i].long()).to(
                torch.int32))
        sp_rows = torch.cat(rows)
        sp_key = torch.cat(keys)
        counts = nz_counts[sparse_idx]
        sp_off = torch.zeros(Gs + 1, dtype=torch.int64, device=dev)
        sp_off[1:] = torch.as_tensor(np.cumsum(counts), device=dev)
        F = self.num_features
        is_sparse = np.zeros(F, np.int32)
        is_sparse[sparse_idx] = 1
        sparse_slot = np.zeros(F, np.int32)
        sparse_slot[sparse_idx] = np.arange(Gs)
        dense_col = np.zeros(F, np.int32)
        dense_col[dense_idx] = np.arange(gd)
        meta_np["is_sparse"] = is_sparse
        meta_np["sparse_slot"] = sparse_slot
        meta_np["dense_col"] = dense_col
        # a dense feature: its histogram gives each leaf's exact totals
        meta_np["dense_ref"] = np.full(F, dense_idx[0], np.int32)
        self.num_columns = gd
        window = int(counts.max()) if Gs else 0
        self.sparse = {
            "dense_idx": dense_idx, "sparse_idx": sparse_idx,
            "entries": int(sp_rows.numel()), "window": max(window, 1),
            "coo_bytes": sum(t.numel() * t.element_size()
                             for t in (sp_rows, sp_key, sp_off))}
        Log.info(f"sparse storage: {Gs} of {F} features as COO "
                 f"({self.sparse['entries']} entries), {gd} dense columns")
        return {"sp_rows": sp_rows, "sp_key": sp_key, "sp_off": sp_off}

    @staticmethod
    def _would_pack(config: Config, B: int, impl: str, eff_block: int,
                    n_pad: int, bundled: bool) -> bool:
        """Whether the JAX learner stores 4-bit packed bins here
        (learner.py:628-634, on one device: no partitioned rows, which
        this slice refuses, and no EFB bundles, sparse storage or stream
        layout: `bundled`)."""
        return (bool(config.tpu_pack_bins) and B <= 16 and not bundled
                and impl in ("pallas", "pallas2")
                and str(config.tpu_partition_impl) in ("select", "vselect")
                and eff_block % 256 == 0 and n_pad % eff_block == 0)

    @staticmethod
    def chunk_fits(config: Config, num_bins: int, precision: str) -> bool:
        """The JAX learner's `chunk_fits` test (learner.py:939-962): the
        perfeature kernel's smallest feature chunk (32 features for uint8
        bins, 8 for int32) times Bp = ceil(B/8)*8 bins times the K*S stat
        columns padded to 128 lanes, in f32, fits its VMEM budget."""
        leaves = max(int(config.num_leaves), 2)
        k = min(resolve_split_batch(int(config.tpu_split_batch), leaves),
                leaves - 1)
        s = 5 if precision == "hilo" else 3
        ks_pad = -(-(k * s) // 128) * 128
        bp = -(-int(num_bins) // 8) * 8
        step = 32 if num_bins <= 256 else 8
        return step * bp * ks_pad * 4 <= PERFEATURE_OUT_BUDGET

    @staticmethod
    def _resolve_hist_impl(config: Config, precision: str, num_bins: int,
                           tuned: Optional[dict] = None):
        """(impl, row block), as the JAX learner resolves them on its
        accelerator (learner.py:912-993): "auto" is the grow megakernel
        ("fused", kernel B2) for int8/int16 and the perfeature kernel
        ("pallas2", B1) otherwise, where `chunk_fits` holds, and the XLA
        scan ("xla", which rides B1 here) where it does not.  The row
        blocks are the JAX package's: 256 for the flat kernel, 8192 for
        the perfeature and fused ones, the XLA scan's 16384 for "xla".
        `tuned`, an autotune profile entry, replaces "auto" and a block
        of 0 with its measured winners; an explicit impl or block wins
        over it."""
        impl = str(config.tpu_hist_impl)
        if impl not in HIST_IMPLS:
            raise NotImplementedError(
                f"tpu_hist_impl={impl!r} is not ported to lightgbm_tpu_torch"
                " yet")
        block = int(config.tpu_block_rows)
        if tuned:
            if impl == "auto" and tuned.get("hist_impl"):
                impl = str(tuned["hist_impl"])
            if block <= 0 and int(tuned.get("block_rows", 0) or 0) > 0:
                block = int(tuned["block_rows"])
        if impl == "auto":
            # f64 stays on the XLA branch (learner.py:963-965)
            if precision == "f64" or not TreeLearner.chunk_fits(
                    config, num_bins, precision):
                impl = "xla"
            elif fused_supported(precision) is None:
                impl = "fused"
            else:
                impl = "pallas2"
        if block <= 0:
            block = {"pallas": 256, "pallas2": 8192,
                     "fused": 8192}.get(impl, 16384)
        return impl, block

    # ------------------------------------------------------------------
    def _buffers(self, out, g, h, mask) -> dict:
        """The grower's pool and stat-plane bytes and the row state the
        tree was grown from: the ones mask, the [n_pad] gradient,
        hessian and row mask, and the leaf ids (each shard's too, on a
        sharded learner) (utils/membudget.py)."""
        return dict(out["buffer_bytes"], row_state=membudget.unique_nbytes(
            self._ones_mask, g, h, mask, out["leaf_ids"],
            *out.get("shard_leaf_ids", ())))

    def pad_vector(self, v: torch.Tensor) -> torch.Tensor:
        v = torch.as_tensor(v, dtype=torch.float32, device=self.device)
        if v.shape[0] == self.row_width:
            return v
        out = torch.zeros(self.row_width, dtype=torch.float32,
                          device=self.device)
        out[:v.shape[0]] = v
        return out

    def sample_features(self) -> torch.Tensor:
        """Per-tree feature_fraction mask of the sync path, from the
        numpy generator (learner.py:1059-1072); padding features stay
        masked off."""
        frac = float(self.config.feature_fraction)
        if frac >= 1.0:
            return self.feature_mask
        F = self.num_features
        mask = np.zeros(self.f_pad, np.float32)
        k = max(1, int(np.ceil(F * frac)))
        mask[self._feature_rng.choice(F, size=k, replace=False)] = 1.0
        return upload(mask, self.device)

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              row_mask: Optional[torch.Tensor] = None):
        """Grow one tree from given gradients (the sync path of custom
        objectives, learner.py:1283-1367).  The feature mask is drawn
        first, then the tree key from the same generator.  Returns
        (tree, leaf_ids[:n], raw grower out); one host fetch builds the
        tree."""
        fmask = self.sample_features()
        key = prng.PRNGKey(int(self._feature_rng.integers(2 ** 31)))
        mask = self._ones_mask if row_mask is None else \
            self.pad_vector(row_mask) * self._ones_mask
        g, h = self.pad_vector(grad), self.pad_vector(hess)
        out = self._grow(g, h, mask, fmask, key)
        self.last_syncs = out["syncs"]
        self.last_buffers = self._buffers(out, g, h, mask)
        if self.params.has_cegb:
            # the CEGB state the next tree starts from (learner.py:
            # 1337-1342); each shard keeps the state its grower returned
            self.meta["cegb_used"] = out["cegb_used"]
            if self.params.has_cegb_lazy:
                self.meta["cegb_paid"] = out["cegb_paid"]
            for m, used in zip(self.shard_metas or (),
                               out.get("shard_cegb_used", ())):
                m["cegb_used"] = used
        leaf_out = out["leaf_output"] if self.refits_leaves else None
        if leaf_out is None:
            rec = out["records"].cpu().numpy()
        else:
            both = torch.cat([out["records"].reshape(-1),
                              leaf_out.reshape(-1)]).cpu().numpy()
            rec = both[:out["records"].numel()].reshape(
                out["records"].shape)
            leaf_out = both[out["records"].numel():]
        tree = self.build_tree_from_records(rec, leaf_out)
        return tree, out["leaf_ids"][:self.n], out

    def _grow(self, g, h, mask, fmask, key) -> dict:
        """One tree from padded vectors, on one device or on every shard
        of a sharded learner."""
        if self.topology is None:
            return G.grow(self.params, self.bins_t, g, h, mask, fmask,
                          self.meta, key)
        return self._strategy_grow(self.shard_bins, self.shard_hist_bins, g,
                                   h, mask, fmask, self.shard_metas, key)

    def make_train_step(self, grad_fn, learning_rate: float,
                        bagging: Optional[dict] = None,
                        goss: Optional[dict] = None):
        """Gradients + bagging (or GOSS) and feature_fraction masks +
        tree growth + train-score update, all on the device; the only
        host waits are the grower's stop tests.

        Returns step(grad_scores [k, n], scores [k, n], class_id, key,
            bag_key, refresh_bag, goss_on=False) -> (records, new_scores,
            leaf_ids[:n],
            leaf_output, key, bag_key): `key` is the booster's threefry
            key and `bag_key` its bagging key, advanced as the JAX step
            advances them (learner.py:1110-1197).  goss: {"top_rate",
            "other_rate"}; goss_on (decided on the host, after the
            warm-up) samples the rows of this tree by GOSS."""
        # the row vectors span row_width rows: every row, or this
        # process's row shards under pre_partition
        n, n_pad = self.n, self.row_width
        dev = self.device
        F, f_pad = self.num_features, self.f_pad
        frac = 1.0 if bagging is None else bagging["fraction"]
        pos_frac = 1.0 if bagging is None else bagging["pos_fraction"]
        neg_frac = 1.0 if bagging is None else bagging["neg_fraction"]
        is_pos = None
        if bagging is not None and (pos_frac < 1.0 or neg_frac < 1.0):
            is_pos = torch.as_tensor(bagging["is_pos"], device=dev)
        feature_frac = float(self.config.feature_fraction)
        k_used = max(1, int(np.ceil(F * feature_frac)))
        # the row uniforms key on the global row index (a PCG hash, as
        # the quantized rounding), so padding rows draw too and stay
        # masked by the ones mask; under pre_partition this process's
        # rows start at its first row shard's global index
        row0 = (self.topology.row_shard(self.topology.first)
                * (self.n_pad // self.d_shards)
                if self._partitioned else 0)
        iota = torch.arange(row0, row0 + n_pad, dtype=torch.int64,
                            device=dev)
        # the fractions as f32 device scalars, made once (a host scalar
        # per call would be a blocking copy each tree)
        frac_t, pos_t, neg_t = (torch.tensor(np.float32(v), device=dev)
                                for v in (frac, pos_frac, neg_frac))
        if goss is not None:
            top_k = max(1, int(n * float(goss["top_rate"])))
            other_k = max(1, int(n * float(goss["other_rate"])))
            # the keep rate of the other rows and their upscale, Python
            # floats rounded to f32 once, as the JAX step's weak-typed
            # constants are
            p_other_t, multiply_t = (
                torch.tensor(np.float32(v), device=dev)
                for v in (other_k / max(n - top_k, 1),
                          (n - top_k) / other_k))
            gh_pad = torch.full((n_pad,), -1.0, dtype=torch.float32,
                                device=dev)

        def goss_sample(grad, hess, g, h, bag_key):
            """GOSS on the device (learner.py:1160-1181): keep the rows
            whose |g*h| reaches the top_k-th largest value (ties keep
            more), and each other row with probability other_k/(n-top_k),
            upscaled by (n-top_k)/other_k; the bagging key is split
            anew for the draw.  Returns (g, h, row mask, bag_key)."""
            gh = gh_pad.clone()
            if grad.ndim == 2:
                # every class's |g*h|, added in class order
                gh_all = (grad[0] * hess[0]).abs()
                for c in range(1, grad.shape[0]):
                    gh_all = gh_all + (grad[c] * hess[c]).abs()
            else:
                gh_all = (grad * hess).abs()
            gh[:n] = gh_all[:n]
            thr = torch.sort(gh).values[n_pad - top_k]
            keep_top = gh >= thr
            bag_key = prng.split(bag_key)[0]
            sa, sb = key_words(bag_key)
            r = hashed_uniform(iota, sa, sb, 0x60553)
            keep_other = ~keep_top & (r < p_other_t)
            scale = torch.where(keep_other, multiply_t, 1.0)
            mask = self._ones_mask * (keep_top | keep_other).to(
                torch.float32)
            return g * scale, h * scale, mask, bag_key

        def row_mask(bag_key: np.ndarray) -> torch.Tensor:
            if is_pos is None and frac >= 1.0:
                return self._ones_mask
            sa, sb = key_words(bag_key)
            r = hashed_uniform(iota, sa, sb, 0xBA66)
            if is_pos is not None:
                keep = torch.where(is_pos, r < pos_t, r < neg_t)
            else:
                keep = r < frac_t
            return self._ones_mask * keep.to(torch.float32)

        def feature_mask(kf: np.ndarray) -> torch.Tensor:
            if feature_frac >= 1.0:
                return self.feature_mask
            fmask = np.zeros(f_pad, np.float32)
            fmask[prng.permutation(kf, F)[:k_used]] = 1.0
            return upload(fmask, dev)

        def step(grad_scores: torch.Tensor, scores: torch.Tensor,
                 class_id: int, key: np.ndarray, bag_key: np.ndarray,
                 refresh_bag: bool, goss_on: bool = False):
            # every class's gradients come from the scores at the start of
            # the iteration (`grad_scores`); `scores` takes the classes'
            # trees one by one (learner.py:1116-1131)
            grad, hess = grad_fn(grad_scores)
            g = torch.zeros(n_pad, dtype=torch.float32, device=dev)
            h = torch.zeros(n_pad, dtype=torch.float32, device=dev)
            g[:n] = (grad[class_id] if grad.ndim == 2 else grad)[:n]
            h[:n] = (hess[class_id] if hess.ndim == 2 else hess)[:n]
            key, kf = prng.split(key)
            if refresh_bag:
                bag_key = prng.split(bag_key)[0]
            if goss_on:
                g, h, mask, bag_key = goss_sample(grad, hess, g, h, bag_key)
            else:
                mask = row_mask(bag_key)
            fmask = feature_mask(kf)
            key, k_node = prng.split(key)
            out = self._grow(g, h, mask, fmask, k_node)
            self.last_syncs = out["syncs"]
            self.last_buffers = self._buffers(out, g, h, mask)
            records, leaf_ids = out["records"], out["leaf_ids"]
            # scale the [L] leaf vector first, then gather: one rounded add
            # per row, as the JAX step does
            any_split = records[0, G.REC_DID_SPLIT] > 0.5
            scaled = torch.where(any_split, out["leaf_output"] * learning_rate,
                                 0.0)
            new_scores = scores.clone()
            new_scores[class_id] += scaled[leaf_ids[:n].long()]
            return (records, new_scores, leaf_ids[:n], out["leaf_output"],
                    key, bag_key)

        return step

    def build_tree_from_records(self, rec: np.ndarray,
                                leaf_output: Optional[np.ndarray] = None
                                ) -> Tree:
        """Replay device split records into a reference-compatible Tree;
        `leaf_output` (refit leaves) overrides the records' leaf values."""
        L = self.params.num_leaves
        tree = Tree(L)
        used = self.td.used_feature_idx
        mappers = self.td.mappers
        missing = self.meta_np["missing_type"]
        for s in range(rec.shape[0]):
            row = rec[s]
            if row[G.REC_DID_SPLIT] < 0.5:
                break
            f = int(row[G.REC_FEATURE])
            thr_bin = int(row[G.REC_THRESHOLD])
            real_f = used[f]
            common = dict(
                leaf=int(row[G.REC_LEAF]),
                feature_inner=f,
                real_feature=real_f,
                left_value=float(row[G.REC_LEFT_OUTPUT]),
                right_value=float(row[G.REC_RIGHT_OUTPUT]),
                left_cnt=int(round(float(row[G.REC_LEFT_COUNT]))),
                right_cnt=int(round(float(row[G.REC_RIGHT_COUNT]))),
                left_weight=float(row[G.REC_LEFT_WEIGHT]),
                right_weight=float(row[G.REC_RIGHT_WEIGHT]),
                gain=float(row[G.REC_GAIN]),
                missing_type=int(missing[f]))
            if row[G.REC_IS_CAT] > 0.5:
                # the bins routed left -> a bin bitset and a raw-category
                # bitset (Tree::SplitCategorical, reference tree.h:60-85)
                bins_left = np.nonzero(row[G.REC_WIDTH:] > 0.5)[0]
                cats_left = [mappers[real_f].bin_2_categorical[b]
                             for b in bins_left]
                tree.split_categorical(threshold_bins=_to_bitset(bins_left),
                                       thresholds=_to_bitset(cats_left),
                                       **common)
            else:
                tree.split(
                    threshold_bin=thr_bin,
                    threshold_double=mappers[real_f].bin_to_value(thr_bin),
                    default_left=row[G.REC_DEFAULT_LEFT] > 0.5, **common)
        if leaf_output is not None and tree.num_leaves > 1:
            # the grower's leaf ids are the Tree's leaf indices (the left
            # child keeps the parent's id, the right takes the next one)
            tree.leaf_value[:tree.num_leaves] = np.asarray(
                leaf_output[:tree.num_leaves], np.float64)
        return tree


class StreamedTreeLearner(TreeLearner):
    """The out-of-core serial learner (learner.py:1434-1524 of the JAX
    package): the bins stay in host row blocks, made once in the
    histogram kernels' row-major layout (`ops/stream.py:
    make_host_blocks`, pinned on the card), and `train` grows each tree
    through `StreamGrower`, which copies the blocks through two device
    slots.  On the card the dataset's [F, n] matrix moves to host
    memory as well, so no whole bins matrix stays there (a later
    resident learner copies it back).  No 4-bit packing, no B2; the
    refusals of `stream_supported` with the JAX texts; the GBDT takes
    the sync path on this layout.  For int8/int16 the model is
    byte-identical to the resident layout's sync path."""

    stream_layout = True

    def __init__(self, config: Config, train_data: TrainingData):
        if str(config.tree_learner).strip().lower() not in (
                "serial", "serial_tree_learner"):
            raise NotImplementedError(
                "tpu_stream_mode=streamed requires tree_learner=serial")
        super().__init__(config, train_data)
        from ..ops.stream import StreamGrower

        self._stream = StreamGrower(
            self.params, self.g_pad, self.n_pad, self._stream_R,
            self.device,
            double_buffer=bool(config.tpu_stream_double_buffer),
            goss_top=float(config.tpu_stream_goss_top),
            goss_other=float(config.tpu_stream_goss_other))
        Log.info(
            f"streamed layout: {len(self._host_blocks)} host blocks x "
            f"{self._stream_R} rows "
            f"({self._host_blocks[0].nbytes >> 20} MiB/block, "
            f"double_buffer={self._stream.double_buffer})")

    def _place_bins(self, train_data: TrainingData, plan, sparse_mask,
                    B: int, block: int, eff_block: int) -> None:
        from ..ops.stream import make_host_blocks, resolve_stream_rows

        # the JAX learner's rule, on its [g_pad, n_pad] bytes a row
        item = 1 if B <= 256 else 4
        self._stream_R = resolve_stream_rows(
            int(self.config.tpu_stream_block_rows), self.n_pad,
            bytes_per_row=self.g_pad * item,
            inner_block=min(block, self.n_pad),
            budget_bytes=membudget.budget_bytes(self.config))
        cuda = self.device.type == "cuda"
        self._host_blocks = make_host_blocks(
            train_data.bins_t, self._stream_R, self.n_pad, self.g_pad,
            pin=cuda)
        self.bins_t = None       # never on the device on this layout
        if cuda and train_data.bins_t.device.type == "cuda":
            train_data.bins_t = train_data.bins_t.cpu()

    def _grow(self, g, h, mask, fmask, key) -> dict:
        return self._stream.grow(self._host_blocks, g, h, mask, fmask,
                                 self.meta, key)

    @property
    def stream_stats(self) -> dict:
        """The last tree's streaming telemetry (`StreamGrower.
        last_stats`: H2D seconds and bytes, overlap, blocks)."""
        return dict(self._stream.last_stats)


def make_tree_learner(config: Config,
                      train_data: TrainingData) -> TreeLearner:
    """The learner of the layout `membudget.select_layout` picks
    (learner.py:1527-1540): resident, or streamed where
    tpu_stream_mode=streamed, or auto with a binned matrix over half the
    device budget and a streamable run."""
    if membudget.select_layout(config, train_data) == "streamed":
        return StreamedTreeLearner(config, train_data)
    return TreeLearner(config, train_data)
