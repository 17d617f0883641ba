"""Serial tree learner: lays the bins out for the grower, replays trees.

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
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..io.bundling import EFB_SAMPLE_ROWS, BundlePlan, apply_bundles, \
    find_bundles
from ..io.dataset import TrainingData
from ..ops import grower as G
from ..ops.fused import fused_supported, probe_fused
from ..ops.grower import GrowerParams, pad_rows, resolve_split_batch
from ..ops.histogram import (INT_PRECISIONS, MAX_WIDE_BINS, _dot_spec,
                             hashed_uniform, key_words, pack_bins,
                             row_major_bins)
from ..ops.predict import upload
from ..utils import membudget, prng
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
    device-memory preflight and budget are taken by models/gbdt.py."""

    def refuse(what: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported to lightgbm_tpu_torch yet")

    c = config
    if str(c.boosting) not in ("gbdt", "goss", "dart", "rf",
                               "random_forest"):
        refuse(f"boosting={c.boosting!r}")
    # the JAX package itself trains a parallel learner serially on one
    # machine (with a warning), so only a real multi-machine run is refused
    if str(c.tree_learner) != "serial" and int(c.num_machines) > 1:
        if float(c.tpu_sparse_threshold) > 0.0:
            # on a host with the devices for num_machines, the JAX learner
            # raises its sparse-storage refusals before it shards
            # anything (where it lacks them, its num_machines ValueError
            # comes first); the port takes the first case
            check_sparse_storage(c, TreeLearner.resolve_precision(c),
                                 str(c.tree_learner), forced=False)
        refuse(f"tree_learner={c.tree_learner!r} with num_machines>1")
    if str(c.tpu_stream_mode) == "streamed":
        refuse("tpu_stream_mode=streamed")
    _dot_spec(str(c.tpu_hist_precision))
    if str(c.tpu_hist_impl) not in HIST_IMPLS:
        refuse(f"tpu_hist_impl={c.tpu_hist_impl!r}")
    if str(c.tpu_partition_impl) not in G.PARTITION_IMPLS:
        refuse(f"tpu_partition_impl={c.tpu_partition_impl!r}")
    # the span tracer and its exporters (ROADMAP A11): only their
    # defaults, which do nothing here, are taken
    if str(c.tpu_telemetry).strip().lower() not in ("", "off"):
        refuse(f"tpu_telemetry={c.tpu_telemetry!r}")
    if str(c.tpu_trace_dir):
        refuse(f"tpu_trace_dir={c.tpu_trace_dir!r}")


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
    """The serial learner: device bin layout + grower + tree replay."""

    def __init__(self, config: Config, train_data: TrainingData):
        check_slice(config)
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
        t0 = time.perf_counter()
        # no plan under forced splits (learner.py:239)
        plan = None if forced else self._plan_bundles(
            config, train_data, meta_np["num_bin"], B)
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
            check_sparse_storage(config, precision, "serial", bool(forced))
            nz_counts = train_data.column_nonzero_counts(
                meta_np["default_bin"])
            nz_frac = nz_counts / max(n, 1)
            sp_mask = nz_frac <= sth
            if sp_mask.all():
                # the dense histogram needs a column: the densest stays
                sp_mask[int(np.argmax(nz_frac))] = False
            if sp_mask.any():
                sparse_mask = sp_mask
        impl, block = self._resolve_hist_impl(config, precision, B)
        # the JAX package pads the column axis to a multiple of 32 for its
        # perfeature kernel, and the port's kernels take chunks of 32
        # columns; padding columns hold bin 0 (num_bin=1) and can never
        # split
        self.g_pad = -(-self.num_columns // 32) * 32
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

        self.n_pad = bucket_rows(n)
        if buckets > 0:
            self.g_pad = bucket_up(self.g_pad, 32)
        # the feature axis the JAX learner pads to for this impl
        # (learner.py:371-386, 445-454): without bundles the column axis,
        # 32-aligned for its perfeature and fused kernels, else unpadded,
        # both bucketed (the perfeature kernel's axis to 32, the others'
        # to 8); with bundles the features stay unpadded and only the
        # bundle columns are aligned and bucketed, unless the two widths
        # meet.  Its grower draws the per-node feature masks over that
        # width, so the port draws over it too
        aligned = impl in ("pallas2", "fused")
        align = 32 if impl == "pallas2" else 8
        if plan is None:
            self.draw_width = -(-F // 32) * 32 if aligned else F
            if buckets > 0:
                self.draw_width = bucket_up(self.draw_width, align)
        else:
            g_jax = -(-self.num_columns // 32) * 32 if aligned \
                else self.num_columns
            self.draw_width = F
            if buckets > 0 and g_jax == F:
                self.draw_width = bucket_up(F, align)
        # the features' axis of the meta arrays and the feature mask:
        # without bundles the columns, else the JAX learner's (no kernel
        # reads it)
        self.f_pad = self.g_pad if plan is None else self.draw_width
        # the pack layout's blocks are the grower's: min(block, n_pad)
        eff_block = min(block, self.n_pad)
        self.packed_bins = self._would_pack(
            config, B, impl, eff_block, self.n_pad,
            plan is not None or sparse_mask is not None)
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
        # uint8 when every feature fits a byte, else int32, as the JAX
        # learner stores them (learner.py:486)
        bins_t = torch.zeros((self.g_pad, self.n_pad),
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
        if dev.type == "cuda":
            # kernels B1, B2 and B4 gather each live row's bins from a
            # row-major copy ([n_pad, 32] uint8 at up to 32 columns,
            # [n_pad, 16] packed, or [n_pad, 32] 16-bit for int32 bins);
            # row_major_bins makes it here, at
            # set-up, and keeps it on bins_t for every later call
            row_major_bins(bins_t, self.packed_block)
        ones = torch.zeros(self.n_pad, dtype=torch.float32, device=dev)
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
        self.meta = meta
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
            has_mono=bool(np.any(meta_np["monotone"] != 0)))
        # the JAX grower's refusals, at set-up as there
        G.check_params(self.params)
        # refit leaves: the trees take their leaf values from the grower's
        # refitted outputs, not from the split records
        self.refits_leaves = self.params.quant_refit
        # under feature_fraction_bynode, with categorical features or with
        # bundles the grower never runs B2's scan
        if impl == "fused" and dev.type == "cuda" and fused_supported(
                precision,
                bynode=self.params.feature_fraction_bynode < 1.0,
                has_cat=self.params.has_cat, has_bundles=plan is not None,
                has_cegb=has_cegb, forced=bool(forced)) is None:
            probe_fused(dev, precision, wide=B > 256)
        if has_cegb:
            # the CEGB state of the learner's lifetime (learner.py:810-830):
            # the features any split has used, and with lazy penalties
            # which rows have paid for which feature (bool, [f_pad, n_pad])
            self.meta["cegb_used"] = torch.zeros(
                self.f_pad, dtype=torch.float32, device=dev)
            if has_cegb_lazy:
                self.meta["cegb_paid"] = torch.zeros(
                    (self.f_pad, self.n_pad), dtype=torch.bool, device=dev)
        # host waits of the last grown tree (grower stop tests)
        self.last_syncs = 0
        # bytes of the last tree's pool and stat planes
        # (utils/membudget.py:live_bytes)
        self.last_buffers = {}
        # the sync path's per-tree feature_fraction draws and tree keys
        # (learner.py:860)
        self._feature_rng = np.random.default_rng(
            int(config.feature_fraction_seed))

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
                      B: int) -> Optional[BundlePlan]:
        """The JAX learner's EFB plan (learner.py:227-271), or None: the
        features whose zero-bin share reaches sparse_threshold (and with
        at most B bins) are the candidates, grouped on the strided row
        sample; a plan of singletons alone is no plan."""
        if not bool(config.enable_bundle) or td.num_features <= 1:
            return None
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
        (learner.py:628-634, on one device: no stream layout or
        partitioned rows, which this slice refuses, and no EFB bundles or
        sparse storage: `bundled`)."""
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
    def _resolve_hist_impl(config: Config, precision: str, num_bins: int):
        """(impl, row block), as the JAX learner resolves them on its
        accelerator (learner.py:912-993): "auto" is the grow megakernel
        ("fused", kernel B2) for int8/int16 and the perfeature kernel
        ("pallas2", B1) otherwise, where `chunk_fits` holds, and the XLA
        scan ("xla", which rides B1 here) where it does not.  The row
        blocks are the JAX package's: 256 for the flat kernel, 8192 for
        the perfeature and fused ones, the XLA scan's 16384 for "xla"."""
        impl = str(config.tpu_hist_impl)
        if impl not in HIST_IMPLS:
            raise NotImplementedError(
                f"tpu_hist_impl={impl!r} is not ported to lightgbm_tpu_torch"
                " yet")
        if impl == "auto":
            # f64 stays on the XLA branch (learner.py:963-965)
            if precision == "f64" or not TreeLearner.chunk_fits(
                    config, num_bins, precision):
                impl = "xla"
            elif fused_supported(precision) is None:
                impl = "fused"
            else:
                impl = "pallas2"
        block = int(config.tpu_block_rows)
        if block <= 0:
            block = {"pallas": 256, "pallas2": 8192,
                     "fused": 8192}.get(impl, 16384)
        return impl, block

    # ------------------------------------------------------------------
    def _buffers(self, out, g, h, mask) -> dict:
        """The grower's pool and stat-plane bytes and the row state the
        tree was grown from: the ones mask, the [n_pad] gradient,
        hessian and row mask, and the leaf ids (utils/membudget.py)."""
        return dict(out["buffer_bytes"], row_state=membudget.unique_nbytes(
            self._ones_mask, g, h, mask, out["leaf_ids"]))

    def pad_vector(self, v: torch.Tensor) -> torch.Tensor:
        v = torch.as_tensor(v, dtype=torch.float32, device=self.device)
        if v.shape[0] == self.n_pad:
            return v
        out = torch.zeros(self.n_pad, dtype=torch.float32,
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
        out = G.grow(self.params, self.bins_t, g, h, mask, fmask, self.meta,
                     key)
        self.last_syncs = out["syncs"]
        self.last_buffers = self._buffers(out, g, h, mask)
        if self.params.has_cegb:
            # the CEGB state the next tree starts from (learner.py:
            # 1337-1342)
            self.meta["cegb_used"] = out["cegb_used"]
            if self.params.has_cegb_lazy:
                self.meta["cegb_paid"] = out["cegb_paid"]
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
        n, n_pad = self.n, self.n_pad
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
        # masked by the ones mask
        iota = torch.arange(n_pad, dtype=torch.int64, device=dev)
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
            out = G.grow(self.params, self.bins_t, g, h, mask, fmask,
                         self.meta, k_node)
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
