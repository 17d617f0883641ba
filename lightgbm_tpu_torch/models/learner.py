"""Serial tree learner: lays the bins out for the grower, replays trees.

The port of the serial, dense, numerical subset of
`lightgbm_tpu/models/learner.py:TPUTreeLearner`: the padded layout
(`f_pad`, `n_pad` with the same shape bucketing), the per-feature meta
arrays, `_resolve_hist_impl`, the fused per-iteration train step, and
`build_tree_from_records`.

Histogram implementations: "pallas2" (the perfeature Pallas kernel in
the JAX package) means kernel B1 on a CUDA tensor and its plain twin on
the CPU.  "xla" computes the same function, so it rides the same path
with the XLA scan's row block.  "pallas" (the flat variant) means kernel
B4, with B1's twin.  "fused" (the grow megakernel) means kernel B2 in
every grower round for the int8/int16 precisions, and rides "pallas2"
for the float ones.  "auto" picks "fused" for int8/int16 and "pallas2"
otherwise.  On the card the learner first runs B2 against its twin on
tiny operands, and raises on any difference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..io.dataset import TrainingData
from ..ops import grower as G
from ..ops.fused import fused_supported, probe_fused
from ..ops.grower import GrowerParams, pad_rows, resolve_split_batch
from ..ops.histogram import INT_PRECISIONS, _dot_spec, row_major_bins
from ..utils import prng
from .tree import Tree

HIST_IMPLS = ("auto", "pallas", "pallas2", "fused", "xla")


def check_slice(config: Config) -> None:
    """Refuse, by name, every parameter value outside the ported slice
    (serial learner, dense numeric columns, gbdt; float and int8/int16
    histograms)."""

    def refuse(what: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported to lightgbm_tpu_torch yet")

    c = config
    if str(c.boosting) != "gbdt":
        refuse(f"boosting={c.boosting!r}")
    # the JAX package itself trains a parallel learner serially on one
    # machine (with a warning), so only a real multi-machine run is refused
    if str(c.tree_learner) != "serial" and int(c.num_machines) > 1:
        refuse(f"tree_learner={c.tree_learner!r} with num_machines>1")
    if int(c.bagging_freq) > 0 and float(c.bagging_fraction) < 1.0:
        refuse("bagging_fraction<1")
    if float(c.pos_bagging_fraction) < 1.0 \
            or float(c.neg_bagging_fraction) < 1.0:
        refuse("pos_bagging_fraction/neg_bagging_fraction<1")
    if float(c.feature_fraction) < 1.0:
        refuse("feature_fraction<1")
    if float(c.feature_fraction_bynode) < 1.0:
        refuse("feature_fraction_bynode<1")
    if any(int(v) != 0 for v in c.monotone_constraints):
        refuse("monotone_constraints")
    if float(c.cegb_penalty_split) != 0.0 \
            or any(float(v) != 0.0 for v in c.cegb_penalty_feature_coupled) \
            or any(float(v) != 0.0 for v in c.cegb_penalty_feature_lazy):
        refuse("cegb_penalty_*")
    if str(c.forcedsplits_filename):
        refuse("forcedsplits_filename")
    if float(c.tpu_sparse_threshold) > 0.0:
        refuse("tpu_sparse_threshold>0")
    if str(c.tpu_stream_mode) == "streamed":
        refuse("tpu_stream_mode=streamed")
    if bool(c.deterministic):
        refuse("deterministic=true (f64 histograms)")
    _dot_spec(str(c.tpu_hist_precision))
    if str(c.tpu_hist_impl) not in HIST_IMPLS:
        refuse(f"tpu_hist_impl={c.tpu_hist_impl!r}")
    if str(c.tpu_partition_impl) not in G.PARTITION_IMPLS:
        refuse(f"tpu_partition_impl={c.tpu_partition_impl!r}")


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
        self.meta_np = meta_np
        B = int(meta_np["num_bin"].max())
        self.num_bins = B
        if B > 256:
            raise NotImplementedError(
                f"max_bin={config.max_bin} (features with more than 256 "
                "bins) is not ported to lightgbm_tpu_torch yet")
        self._check_bundling(config, train_data, B)

        precision = str(config.tpu_hist_precision)
        impl, block = self._resolve_hist_impl(config, precision)
        # the JAX package pads the column axis to a multiple of 32 for its
        # perfeature kernel; padding columns hold bin 0 (num_bin=1) and
        # can never split
        self.f_pad = -(-self.num_features // 32) * 32
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
            self.f_pad = bucket_up(self.f_pad, 32)
        if self._would_pack(config, B, impl, block):
            raise NotImplementedError(
                "tpu_pack_bins=true with max_bin<=15 (4-bit packed bins) is "
                "not ported to lightgbm_tpu_torch yet; set "
                "tpu_pack_bins=false")

        dev = self.device
        bins_t = torch.zeros((self.f_pad, self.n_pad), dtype=torch.uint8,
                             device=dev)
        bins_t[:self.num_features, :n] = train_data.bins_t
        self.bins_t = bins_t
        if dev.type == "cuda":
            # kernels B1 and B2 gather each live row's bins from a
            # row-major copy ([n_pad, 32] uint8 at up to 32 features);
            # row_major_bins makes it here, at set-up, and keeps it on
            # bins_t for every later call
            row_major_bins(bins_t)
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
            split_batch=resolve_split_batch(int(config.tpu_split_batch),
                                            int(config.num_leaves)),
            split_batch_alpha=float(config.tpu_split_batch_alpha),
            partition_impl=str(config.tpu_partition_impl),
            ramp=bool(config.tpu_ramp),
            ramp_step=(4 if str(config.tpu_bucket_policy) == "wide"
                       else 2),
            hist_impl=impl,
            quant_round=str(config.tpu_quant_round),
            quant_refit=(precision in INT_PRECISIONS
                         and bool(config.tpu_quant_refit_leaves)))
        # refit leaves: the trees take their leaf values from the grower's
        # refitted outputs, not from the split records
        self.refits_leaves = self.params.quant_refit
        if impl == "fused" and fused_supported(precision) is None \
                and dev.type == "cuda":
            probe_fused(dev, precision)
        # host waits of the last grown tree (grower stop tests)
        self.last_syncs = 0

    # ------------------------------------------------------------------
    @staticmethod
    def _check_bundling(config: Config, td: TrainingData, B: int) -> None:
        """EFB is not ported: refuse when the JAX package could bundle.

        Its bundler only considers features whose zero-bin fraction is at
        least sparse_threshold; with fewer than two such features every
        bundle is a singleton and its plan is trivial, which is the
        plain-column layout this learner uses."""
        if not bool(config.enable_bundle) or td.num_features <= 1:
            return
        zero_frac = td.column_zero_fraction()
        num_bin = td.feature_arrays()["num_bin"]
        cand = (zero_frac >= float(config.sparse_threshold)) & (num_bin <= B)
        if int(cand.sum()) >= 2:
            raise NotImplementedError(
                "enable_bundle=true on data with sparse features (EFB "
                "bundles) is not ported to lightgbm_tpu_torch yet; set "
                "enable_bundle=false")

    @staticmethod
    def _would_pack(config: Config, B: int, impl: str, block: int) -> bool:
        """Whether the JAX package would store 4-bit packed bins here."""
        return (bool(config.tpu_pack_bins) and B <= 16
                and impl in ("pallas", "pallas2")
                and str(config.tpu_partition_impl) in ("select", "vselect")
                and block % 256 == 0)

    @staticmethod
    def _resolve_hist_impl(config: Config, precision: str):
        """(impl, row block), as the JAX learner resolves them on its
        accelerator (learner.py:912-993): "auto" is the grow megakernel
        ("fused", kernel B2) for int8/int16 and the perfeature kernel
        ("pallas2", B1) otherwise.  The row blocks are the JAX package's:
        256 for the flat kernel, 8192 for the perfeature and fused ones,
        the XLA scan's 16384 for "xla"."""
        impl = str(config.tpu_hist_impl)
        if impl not in HIST_IMPLS:
            raise NotImplementedError(
                f"tpu_hist_impl={impl!r} is not ported to lightgbm_tpu_torch"
                " yet")
        if impl == "auto":
            impl = "fused" if fused_supported(precision) is None \
                else "pallas2"
        block = int(config.tpu_block_rows)
        if block <= 0:
            block = {"pallas": 256, "pallas2": 8192,
                     "fused": 8192}.get(impl, 16384)
        return impl, block

    # ------------------------------------------------------------------
    def make_train_step(self, grad_fn, learning_rate: float):
        """Gradients + tree growth + train-score update, all on the
        device; the only host waits are the grower's stop tests.

        Returns step(scores [k, n], class_id, key) ->
            (records, new_scores, leaf_ids[:n], leaf_output, key): `key`
            is the booster's threefry key, advanced as the JAX step
            advances it (learner.py:1135,1196)."""
        n, n_pad = self.n, self.n_pad
        dev = self.device

        def step(scores: torch.Tensor, class_id: int, key: np.ndarray):
            grad, hess = grad_fn(scores)
            g = torch.zeros(n_pad, dtype=torch.float32, device=dev)
            h = torch.zeros(n_pad, dtype=torch.float32, device=dev)
            g[:n] = grad[:n]
            h[:n] = hess[:n]
            # key -> (key, kf) feeds feature_fraction in the JAX step (not
            # ported); key -> (key, k_node) seeds the tree
            key = prng.split(key)[0]
            key, k_node = prng.split(key)
            out = G.grow(self.params, self.bins_t, g, h, self._ones_mask,
                         self.feature_mask, self.meta, k_node)
            self.last_syncs = out["syncs"]
            records, leaf_ids = out["records"], out["leaf_ids"]
            # scale the [L] leaf vector first, then gather: one rounded add
            # per row, as the JAX step does
            any_split = records[0, G.REC_DID_SPLIT] > 0.5
            scaled = torch.where(any_split, out["leaf_output"] * learning_rate,
                                 0.0)
            new_scores = scores.clone()
            new_scores[class_id] += scaled[leaf_ids[:n].long()]
            return (records, new_scores, leaf_ids[:n], out["leaf_output"],
                    key)

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
            tree.split(
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
                missing_type=int(missing[f]),
                threshold_bin=thr_bin,
                threshold_double=mappers[real_f].bin_to_value(thr_bin),
                default_left=row[G.REC_DEFAULT_LEFT] > 0.5)
        if leaf_output is not None and tree.num_leaves > 1:
            # the grower's leaf ids are the Tree's leaf indices (the left
            # child keeps the parent's id, the right takes the next one)
            tree.leaf_value[:tree.num_leaves] = np.asarray(
                leaf_output[:tree.num_leaves], np.float64)
        return tree
