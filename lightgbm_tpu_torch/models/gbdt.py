"""GBDT boosting driver (reference src/boosting/gbdt.cpp:368-449).

The port of the plain training subset of `lightgbm_tpu/models/gbdt.py`:
boost-from-average, one fused device step per iteration (gradients,
bagging and feature_fraction masks, tree growth, train-score update),
host `Tree` models built lazily from the device step records
(`_materialize`: one batched fetch for all pending trees), validation
sets whose scores stay on the device (each new tree's leaf values added
at `_materialize`), evaluation with custom `feval`, the synchronous
step (custom objectives, and the DART and RF subclasses), model text
with the `tpu_bin_mappers:` trailer and the `average_output` flag of
random forests, and device predict in bin space.  The
`tpu_feature_profile:` trailer (the training reference profile of
`obs/modelhealth.py`) follows the mapper trailer, as in the JAX package.
The hooks of the boosting modes (`models/goss.py`, `dart.py`, `rf.py`):
`_goss_cfg` (threaded into the fused step), `_train_one_iter_impl`,
`_ScoreState.multiply`, `_score_trees_binned` (the f64 walk of a listed
subset of trees) and `_invalidate_tables`.

Objectives whose gradients run on the host (ranking) or whose leaves are
refit on the host (the percentile family), and data with a single label
class, take the sync step, as in the JAX package's GBDT; multiclass runs the
fused step once per class, every class's gradients from the scores at
the iteration's start.  The model surface: `feature_importance`,
`dump_model`, `shuffle_models`.

Left out, and not silently: rollback, OOM ladders, fault injection,
telemetry, checkpoints.
"""

from __future__ import annotations

import io
import json
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, refuse_host_predict
from ..io.bin_mapper import BinMapper, BinType
from ..io.dataset import TrainingData
from ..obs import modelhealth
from ..ops.binning import bin_matrix_t
from ..ops.predict import (PackedForest, class_scores, device_tables,
                           pack_trees, subset_scores, tree_leaf_values,
                           upload)
from ..utils.prng import PRNGKey
from .learner import TreeLearner, _to_bitset
from .metrics import Metric, create_metrics
from .objectives import (Objective, create_objective,
                         create_objective_from_model_string)
from .tree import Tree

K_EPSILON = 1e-15
_MAPPER_MARKER = "tpu_bin_mappers:"


class PredictContext:
    """What binning raw rows for device predict needs: the mappers, the
    used-column map and per-feature bin metadata.  Round-trips through
    the model text's `tpu_bin_mappers:` trailer, in the JAX package's
    payload format."""

    def __init__(self, mappers: List[BinMapper], used_feature_idx):
        self.mappers = mappers
        self.used_feature_idx = [int(i) for i in used_feature_idx]
        idx = self.used_feature_idx
        self.meta = {
            "num_bin": np.array([mappers[i].num_bin for i in idx], np.int64),
            "default_bin": np.array([mappers[i].default_bin for i in idx],
                                    np.int64),
            "missing_type": np.array([int(mappers[i].missing_type)
                                      for i in idx], np.int64),
        }
        self._meta_dev: Dict[str, List[torch.Tensor]] = {}

    def to_payload(self) -> Dict:
        return {"num_total_features": len(self.mappers),
                "used_feature_idx": self.used_feature_idx,
                "mappers": {str(c): self.mappers[c].to_dict()
                            for c in self.used_feature_idx}}

    @classmethod
    def from_payload(cls, payload: Dict) -> "PredictContext":
        mappers = [BinMapper() for _ in range(int(payload["num_total_features"]))]
        for key, d in payload["mappers"].items():
            mappers[int(key)] = BinMapper.from_dict(d)
        return cls(mappers, payload["used_feature_idx"])

    def meta_dev(self, device) -> List[torch.Tensor]:
        """The per-feature bin metadata on `device`, uploaded once."""
        key = str(device)
        if key not in self._meta_dev:
            self._meta_dev[key] = [
                torch.as_tensor(self.meta[k], device=device)
                for k in ("num_bin", "default_bin", "missing_type")]
        return self._meta_dev[key]

    def bin_rows_t(self, X: np.ndarray, device) -> torch.Tensor:
        """[F_used, n] device bins of raw rows in training-mapper space."""
        return bin_matrix_t(X, self.mappers, self.used_feature_idx, device)


def _split_mapper_snapshot(text: str):
    """Split a model string into (model_text, PredictContext | None)."""
    marker = "\n" + _MAPPER_MARKER
    pos = text.rfind(marker)
    if pos < 0:
        return text, None
    line_end = text.find("\n", pos + 1)
    payload = text[pos + len(marker): len(text) if line_end < 0
                   else line_end].strip()
    rest = "" if line_end < 0 else text[line_end:]
    return text[:pos] + rest, PredictContext.from_payload(json.loads(payload))


def _rebind_tree(tree: Tree, ctx: PredictContext) -> None:
    """Map a loaded tree's raw-value splits back into bin space
    (lightgbm_tpu/models/gbdt.py:_rebind_tree_to_mappers): each saved
    numerical threshold is a bin upper bound, so value_to_bin is exact;
    each categorical node's bitset of raw categories is decoded, its
    categories mapped to their bins through the mapper's
    categorical_2_bin, and re-encoded as the bin bitset, and the node
    keeps its bitset's index as its bin threshold."""
    used_pos = {col: j for j, col in enumerate(ctx.used_feature_idx)}
    cat_nodes: Dict[int, List[int]] = {}  # cat_idx -> bin words
    for j in range(tree.num_leaves - 1):
        real_f = int(tree.split_feature[j])
        if real_f not in used_pos:
            raise ValueError(
                f"model splits on feature {real_f} which is trivial/"
                "unused in the binning context")
        tree.split_feature_inner[j] = used_pos[real_f]
        mapper = ctx.mappers[real_f]
        if int(tree.decision_type[j]) & 1:
            cat_idx = int(tree.threshold[j])
            start = tree.cat_boundaries[cat_idx]
            end = tree.cat_boundaries[cat_idx + 1]
            words = tree.cat_threshold[start:end]
            cats = [w * 32 + b for w, word in enumerate(words)
                    for b in range(32) if (int(word) >> b) & 1]
            cat_nodes[cat_idx] = _to_bitset(
                [mapper.categorical_2_bin[c] for c in cats
                 if c in mapper.categorical_2_bin])
            # the node's bitset index, which the walk reads where a
            # trained tree keeps it (Tree.split_categorical); the JAX
            # package leaves it 0 here, so its device walk of a loaded
            # model reads the first bitset at every categorical node
            tree.threshold_in_bin[j] = cat_idx
        else:
            tree.threshold_in_bin[j] = mapper.value_to_bin(
                float(tree.threshold[j]))
    if cat_nodes:
        bounds, words = [0], []
        for ci in range(tree.num_cat):
            bw = cat_nodes.get(ci, [0])
            words.extend(bw)
            bounds.append(bounds[-1] + len(bw))
        tree.cat_boundaries_inner = bounds
        tree.cat_threshold_inner = words


class _ScoreState:
    """Raw scores [k, n] f32 on the device."""

    def __init__(self, num_class: int, num_data: int, device,
                 init_score: Optional[np.ndarray] = None):
        scores = np.zeros((num_class, num_data), np.float32)
        self.has_init_score = init_score is not None
        if init_score is not None:
            s = np.asarray(init_score, np.float64)
            if s.size == num_data * num_class:
                scores += s.reshape(num_class, num_data) if s.ndim == 1 \
                    else s.T.astype(np.float32)
            else:
                scores += s.reshape(1, -1)
        self.scores = torch.as_tensor(scores, device=device)

    def add_constant(self, val: float, class_id: int) -> None:
        self.scores[class_id] += np.float32(val)

    def add(self, class_id: int, delta: torch.Tensor) -> None:
        self.scores[class_id] += delta

    def multiply(self, class_id: int, val: float) -> None:
        """Scale one class's scores by f32(val) (the RF running average,
        reference score_updater.hpp MultiplyScore)."""
        self.scores[class_id] *= np.float32(val)

    def numpy(self) -> np.ndarray:
        return self.scores.cpu().numpy().astype(np.float64)


class GBDT:
    """The gradient boosting driver."""

    def __init__(self):
        self.models: List[Tree] = []
        self.iter_ = 0
        self.config: Optional[Config] = None
        self.objective: Optional[Objective] = None
        self.train_data: Optional[TrainingData] = None
        self.learner: Optional[TreeLearner] = None
        self.metrics: List[Metric] = []
        self.valid_sets: List[TrainingData] = []
        self.valid_metrics: List[List[Metric]] = []
        self.valid_scores: List[_ScoreState] = []
        self.train_scores: Optional[_ScoreState] = None
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.shrinkage_rate = 0.1
        self.feature_names: List[str] = []
        self.max_feature_idx = 0
        self.label_index = 0
        self.loaded_params: Dict = {}
        self.device = None
        self._pending: List[Tuple] = []
        self._stopped = False
        self._pred_ctx: Optional[PredictContext] = None
        # packed forest tables handed in whole (convert.py) instead of
        # packed from `models`
        self._preset: Optional[Tuple[Dict[str, np.ndarray], int]] = None
        self._tables_key = None
        self._tables: Optional[PackedForest] = None
        self._preset_dev = None
        # host waits of the grower, summed over trained trees
        self.grower_syncs = 0
        self._key: Optional[np.ndarray] = None
        self._bag_key: Optional[np.ndarray] = None
        self._bag_rng: Optional[np.random.Generator] = None
        self._bag_cfg: Optional[Dict] = None
        self._cached_bag_mask: Optional[torch.Tensor] = None
        self._step = None
        # GOSS's rates and warm-up (models/goss.py); threaded into the step
        self._goss_cfg: Optional[Dict] = None
        # random forests: scores and predictions are averages over trees
        self.average_output = False
        # a loaded model's tpu_feature_profile: trailer
        self._profile: Optional[modelhealth.FeatureProfile] = None

    # ------------------------------------------------------------------
    def init(self, config: Config, train_data: TrainingData) -> None:
        self.config = config
        self.train_data = train_data
        self.device = train_data.device
        self.num_class = int(config.num_class)
        self.shrinkage_rate = float(config.learning_rate)
        self.objective = create_objective(config)
        if self.objective is not None:
            self.objective.init(train_data.metadata, train_data.num_data,
                                self.device)
            self.num_tree_per_iteration = \
                self.objective.num_model_per_iteration()
        else:
            # objective=none: custom gradients through update(fobj=...)
            self.num_tree_per_iteration = self.num_class
        self.learner = TreeLearner(config, train_data)
        if self.learner.params.has_cegb and self._goss_cfg is not None:
            # gbdt.py:339-341 of the JAX package
            raise NotImplementedError(
                "CEGB penalties do not compose with GOSS yet")
        self.metrics = create_metrics(
            config, self.objective.name if self.objective else "")
        for m in self.metrics:
            m.init(train_data.metadata, train_data.num_data)
        self.train_scores = _ScoreState(self.num_tree_per_iteration,
                                        train_data.num_data, self.device,
                                        train_data.metadata.init_score)
        self.feature_names = list(train_data.feature_names)
        self.max_feature_idx = train_data.num_total_features - 1
        self._pred_ctx = PredictContext(train_data.mappers,
                                        train_data.used_feature_idx)
        self._boosted_from_average = [False] * self.num_tree_per_iteration
        # the threefry key streams of the JAX package's GBDT (gbdt.py:
        # 307-313): every iteration and class advances `_key`, and each
        # tree's key seeds the stochastic rounding of the quantized
        # precisions; `_bag_key` advances at each bagging refresh.  The
        # sync path draws its bagging masks from `_bag_rng` instead.
        self._key = PRNGKey(int(config.seed))
        self._bag_key = PRNGKey(int(config.bagging_seed))
        self._bag_rng = np.random.default_rng(int(config.bagging_seed))
        self._bag_cfg = self._bagging_config()
        self._make_train_step()

    def _make_train_step(self) -> None:
        """(Re)build the fused step where the JAX package's GBDT builds it
        (gbdt.py:356-380): a built-in objective whose gradients run on
        the device, with no leaf refit on the host, no CEGB, and every
        class trainable.  Otherwise (objective=none, the ranking
        objectives, the percentile family, CEGB, whose state crosses
        trees through the learner's `train`, a single label class) every
        iteration takes the sync step."""
        self._step = None
        obj = self.objective
        if (obj is not None and not obj.needs_renew and not obj.host_only
                and not self.learner.params.has_cegb
                and all(obj.class_need_train(k)
                        for k in range(self.num_tree_per_iteration))):
            self._step = self.learner.make_train_step(
                self.objective.get_gradients, self.shrinkage_rate,
                self._bag_cfg, self._goss_cfg)

    def _bagging_config(self) -> Optional[Dict]:
        cfg = self.config
        frac = float(cfg.bagging_fraction)
        freq = int(cfg.bagging_freq)
        pos_frac = float(cfg.pos_bagging_fraction)
        neg_frac = float(cfg.neg_bagging_fraction)
        balanced = (pos_frac < 1.0 or neg_frac < 1.0)
        if freq <= 0 or (frac >= 1.0 and not balanced):
            return None
        out = {"fraction": frac, "pos_fraction": pos_frac,
               "neg_fraction": neg_frac, "freq": freq}
        if balanced:
            label = np.asarray(self.train_data.metadata.label)
            is_pos = np.zeros(self.learner.n_pad, bool)
            is_pos[:len(label)] = label > 0
            out["is_pos"] = is_pos
        return out

    def reset_config(self, config: Config) -> None:
        """Take a new learning rate (reset_parameter): the train step is
        rebuilt with the new shrinkage."""
        self._materialize()
        self.config = config
        self.shrinkage_rate = float(config.learning_rate)
        if self.learner is not None:
            # the JAX driver rebuilds its learner here, which restarts the
            # sync path's feature generator from its seed
            self.learner.config = config
            self.learner._feature_rng = np.random.default_rng(
                int(config.feature_fraction_seed))
            self._make_train_step()

    def free_dataset(self) -> None:
        """Drop the training and validation data and the train step; the
        header fields and the profile trailer that the model text derives
        from the training data are kept first (booster.py:free_dataset)."""
        self._materialize()
        self.loaded_params["feature_infos"] = self._feature_infos()
        self._profile = self.health_profile()
        self.train_data = None
        self.learner = None
        self.train_scores = None
        self.valid_sets = []
        self.valid_scores = []
        self.valid_metrics = []
        self._step = None

    # ------------------------------------------------------------------
    def add_valid(self, data: TrainingData, name: str) -> None:
        if data.mappers is not self.train_data.mappers:
            raise ValueError("validation set must be created with "
                             "reference=train dataset")
        self._materialize()
        self.valid_sets.append(data)
        ms = create_metrics(self.config,
                            self.objective.name if self.objective else "")
        for m in ms:
            m.init(data.metadata, data.num_data)
        self.valid_metrics.append(ms)
        state = _ScoreState(self.num_tree_per_iteration, data.num_data,
                            self.device, data.metadata.init_score)
        self.valid_scores.append(state)
        self._replay(state, data)

    def _replay(self, state: _ScoreState, data: TrainingData) -> None:
        """Add the existing model's raw scores over a binned dataset to a
        score state: one packed-forest pass on the device."""
        if not self.models:
            return
        tables, depth = pack_trees(self.models)
        scores = class_scores(device_tables(tables, self.device),
                              data.bins_t,
                              self._pred_ctx.meta_dev(self.device),
                              self.num_tree_per_iteration, depth)
        for k in range(self.num_tree_per_iteration):
            state.add(k, scores[k])

    def _boost_from_average(self, class_id: int) -> float:
        if (self.models or self._pending
                or self._boosted_from_average[class_id]
                or self.train_scores.has_init_score):
            return 0.0
        self._boosted_from_average[class_id] = True
        if not self.config.boost_from_average:
            return 0.0
        init = self.objective.boost_from_score(class_id)
        if abs(init) > K_EPSILON:
            self.train_scores.add_constant(init, class_id)
            for vs in self.valid_scores:
                vs.add_constant(init, class_id)
            return init
        return 0.0

    def bagging_mask(self, it: int) -> Optional[torch.Tensor]:
        """The sync path's row mask for this iteration (None = all
        rows), from the numpy generator (gbdt.py:507-535)."""
        bag = self._bag_cfg
        if bag is None:
            return None
        if it % bag["freq"] != 0 and self._cached_bag_mask is not None:
            return self._cached_bag_mask
        n = self.train_data.num_data
        if "is_pos" in bag:
            is_pos = np.asarray(self.train_data.metadata.label) > 0
            r = self._bag_rng.random(n)
            keep = np.where(is_pos, r < bag["pos_fraction"],
                            r < bag["neg_fraction"])
        else:
            cnt = int(n * bag["fraction"])
            idx = self._bag_rng.choice(n, size=cnt, replace=False)
            keep = np.zeros(n, bool)
            keep[idx] = True
        mask = upload(keep.astype(np.float32), self.device)
        self._cached_bag_mask = mask
        return mask

    def train_one_iter(self, grad: Optional[np.ndarray] = None,
                       hess: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration; True once training has stalled (known
        only after `_materialize` on the fused path, as in the JAX
        driver).  Given gradients (custom objectives) take the sync
        path."""
        if self._stopped:
            return True
        return self._train_one_iter_impl(grad, hess)

    def _train_one_iter_impl(self, grad, hess) -> bool:
        """The iteration itself; the boosting modes override it."""
        if grad is None and self.objective is None:
            raise ValueError("objective=none trains on given gradients: "
                             "update(fobj=...)")
        if grad is None and self._step is not None:
            return self._train_one_iter_fused()
        return self._train_one_iter_sync(grad, hess)

    def _train_one_iter_fused(self) -> bool:
        """One fused device step per class, no host wait beyond the
        grower's; the trees materialize lazily.  GOSS samples once its
        warm-up of 1/learning_rate iterations is over (decided here, on
        the host, as gbdt.py:631-632 does)."""
        bag = self._bag_cfg
        goss_on = (self._goss_cfg is not None
                   and self.iter_ >= self._goss_cfg["warmup"])
        inits = [self._boost_from_average(k)
                 for k in range(self.num_tree_per_iteration)]
        # every class's gradients from the scores at the iteration's start
        base_scores = self.train_scores.scores
        for k, init in enumerate(inits):
            refresh = bag is not None and self.iter_ % bag["freq"] == 0
            (records, scores, _, leaf_out, self._key,
             self._bag_key) = self._step(base_scores,
                                         self.train_scores.scores, k,
                                         self._key, self._bag_key, refresh,
                                         goss_on)
            self.train_scores.scores = scores
            self.grower_syncs += self.learner.last_syncs
            # refit leaves: the tree takes the refitted device outputs
            self._pending.append((
                records, leaf_out if self.learner.refits_leaves else None,
                k, init))
        self.iter_ += 1
        return False

    def _train_one_iter_sync(self, grad: Optional[np.ndarray] = None,
                             hess: Optional[np.ndarray] = None) -> bool:
        """The synchronous path (gbdt.py:1037-1097): custom gradients, or
        without them boost-from-average and the objective's gradients
        (on the device, or on the host for the ranking objectives); the
        numpy bagging mask, one tree fetched per class, the percentile
        refit of the leaves where the objective renews them."""
        k_all = self.num_tree_per_iteration
        init_scores = [0.0] * k_all
        given = grad is not None
        if not given:
            for k in range(k_all):
                init_scores[k] = self._boost_from_average(k)
            grad, hess = self.objective.get_gradients(
                self.train_scores.scores)
            grad, hess = grad.reshape(k_all, -1), hess.reshape(k_all, -1)
        else:
            grad = torch.as_tensor(np.asarray(grad, np.float32).reshape(
                k_all, -1), device=self.device)
            hess = torch.as_tensor(np.asarray(hess, np.float32).reshape(
                k_all, -1), device=self.device)
        self._materialize()
        grad, hess, mask = self._sync_rows(grad, hess, given)
        should_continue = False
        for k in range(k_all):
            need = (self.objective is None
                    or self.objective.class_need_train(k))
            tree = None
            if need:
                tree, leaf_ids, _ = self.learner.train(grad[k], hess[k],
                                                       mask)
                self.grower_syncs += self.learner.last_syncs
            if tree is not None and tree.num_leaves > 1:
                should_continue = True
                self._renew_and_update(tree, leaf_ids, k, mask)
                if abs(init_scores[k]) > K_EPSILON:
                    tree.add_bias(init_scores[k])
            else:
                tree = Tree(2)
                if len(self.models) < k_all:
                    output = (init_scores[k]
                              if need or self.objective is None
                              else self.objective.boost_from_score(k))
                    tree.as_constant_tree(output)
                    self.train_scores.add_constant(output, k)
                    for vs in self.valid_scores:
                        vs.add_constant(output, k)
            self.models.append(tree)
        if not should_continue:
            if len(self.models) > k_all:
                del self.models[-k_all:]
            self._stopped = True
            return True
        self.iter_ += 1
        return False

    def _sync_rows(self, grad: torch.Tensor, hess: torch.Tensor,
                   given: bool):
        """(grad, hess, row mask) of the sync step: the numpy bagging
        mask here; GOSS samples instead."""
        return grad, hess, self.bagging_mask(self.iter_)

    def _renew_and_update(self, tree: Tree, leaf_ids: torch.Tensor,
                          class_id: int, mask: Optional[torch.Tensor]
                          ) -> None:
        """The train-score update of the sync path (gbdt.py:1159-1195):
        where the objective renews leaves, fetch the leaf ids, this
        class's scores and the row mask and refit each leaf on the host
        (its percentile of the residuals); then shrink the tree, gather
        its f32 leaf values by leaf id, and add its leaf values over each
        validation set."""
        if self.objective is not None and self.objective.needs_renew:
            leaf_np = leaf_ids.cpu().numpy()
            score_np = self.train_scores.scores[class_id].cpu().numpy() \
                .astype(np.float64)
            mask_np = (np.ones(len(leaf_np), bool) if mask is None
                       else mask.cpu().numpy()[:len(leaf_np)] > 0)
            self.objective.renew_tree_output(tree, score_np, leaf_np,
                                             mask_np)
        tree.apply_shrinkage(self.shrinkage_rate)
        leaf_vals = torch.as_tensor(
            tree.leaf_value[:tree.num_leaves].astype(np.float32),
            device=self.device)
        self.train_scores.add(class_id, leaf_vals[leaf_ids.long()])
        self._add_valid_deltas(tree, class_id)

    def _add_valid_deltas(self, tree: Tree, class_id: int) -> None:
        """Each validation set's scores += the tree's f32 leaf values over
        its bins (the per-tree device delta, gbdt.py:1591-1621): one
        pack, at the run's leaf width, shared by every set."""
        if not self.valid_sets:
            return
        tables, depth = pack_trees([tree],
                                   leaf_width=int(self.config.num_leaves))
        tables = device_tables(tables, self.device)
        meta = self._pred_ctx.meta_dev(self.device)
        for vs, vd in zip(self.valid_scores, self.valid_sets):
            vs.add(class_id,
                   tree_leaf_values(tables, vd.bins_t, meta, depth))

    def _score_trees_binned(self, bins_t: torch.Tensor, trees, scales
                            ) -> torch.Tensor:
        """[n] f32 device scores sum_i scales[i] * trees[i] over a binned
        [F, n] set, summed per row in f64 in list order and cast once
        (gbdt.py:1519-1543; the DART drop and restore)."""
        return subset_scores(trees, scales, bins_t,
                             self._pred_ctx.meta_dev(self.device))

    def _invalidate_tables(self) -> None:
        """Drop the cached forest tables: they append the trees trained
        since they were last read, so a change of leaf values in place
        (DART's shrinkage of dropped trees) or of the order must clear
        them."""
        self._tables_key = None
        self._tables = None

    def _materialize(self) -> None:
        """Fetch the pending device records (one batched copy) and build
        the host Tree models; each new tree, shrunk and before its bias,
        adds its leaf values to the validation scores."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        recs = torch.stack([p[0] for p in pending]).cpu().numpy()
        outs = [None] * len(pending)
        if pending[0][1] is not None:
            outs = list(torch.stack([p[1] for p in pending]).cpu().numpy())
        for (_, _, class_id, init), rec, out in zip(pending, recs, outs):
            if self._stopped:
                # drop queued post-stall iterations (the reference pops
                # them)
                break
            tree = self.learner.build_tree_from_records(rec, out)
            if tree.num_leaves > 1:
                tree.apply_shrinkage(self.shrinkage_rate)
                self._add_valid_deltas(tree, class_id)
                if abs(init) > K_EPSILON:
                    tree.add_bias(init)
                self.models.append(tree)
            else:
                # no split: the device scores did not change; stop like
                # the reference (gbdt.cpp:434-442)
                self._stopped = True
                if len(self.models) < self.num_tree_per_iteration:
                    tree.as_constant_tree(init)
                    self.models.append(tree)
        self.iter_ = len(self.models) // max(self.num_tree_per_iteration, 1)

    def current_iteration(self) -> int:
        self._materialize()
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    def num_total_model(self) -> int:
        self._materialize()
        return len(self.models)

    def current_score_for_fobj(self) -> np.ndarray:
        return self.train_scores.numpy()

    def eval(self, name: str, valid_idx: int, feval=None) -> List[Tuple]:
        """(dataset, metric, value, higher_is_better) of the train scores
        (valid_idx < 0) or of one validation set: one device fetch of
        the scores (gbdt.py:1420-1440)."""
        self._materialize()
        if valid_idx < 0:
            scores = self.train_scores.numpy()
            metrics = self.metrics
        else:
            scores = self.valid_scores[valid_idx].numpy()
            metrics = self.valid_metrics[valid_idx]
        out = []
        for m in metrics:
            for metric_name, val in m.eval_all(scores, self.objective):
                out.append((name, metric_name, val, m.higher_is_better))
        if feval is not None:
            ds = (self.train_data if valid_idx < 0
                  else self.valid_sets[valid_idx])
            res = feval(scores.reshape(-1), _FevalData(ds))
            for item in (res if isinstance(res, list) else [res]):
                out.append((name, item[0], item[1], item[2]))
        return out

    def eval_for_data(self, data: TrainingData, name: str, feval=None
                      ) -> List[Tuple]:
        """Metrics on a dataset built with reference=the training set,
        without registering it (gbdt.py:1442-1497): the model replays
        onto it in one packed-forest pass."""
        self._materialize()
        if self.config is None or self.train_data is None:
            raise ValueError("eval on data needs a booster that still holds "
                             "its training dataset")
        if data.mappers is not self.train_data.mappers:
            raise ValueError("eval data must be created with "
                             "reference=the training dataset")
        ms = create_metrics(self.config,
                            self.objective.name if self.objective else "")
        for m in ms:
            m.init(data.metadata, data.num_data)
        state = _ScoreState(self.num_tree_per_iteration, data.num_data,
                            self.device, data.metadata.init_score)
        self._replay(state, data)
        scores = state.numpy()
        out = []
        for m in ms:
            for metric_name, val in m.eval_all(scores, self.objective):
                out.append((name, metric_name, val, m.higher_is_better))
        if feval is not None:
            res = feval(scores.reshape(-1), _FevalData(data))
            for item in (res if isinstance(res, list) else [res]):
                out.append((name, item[0], item[1], item[2]))
        return out

    # ------------------------------------------------------------------
    def _model_subset(self, num_iteration: int) -> Tuple[int, float]:
        """(tree count, the divisor of random-forest averaging) of the
        first `num_iteration` iterations (-1 = all), gbdt.py:1716-1727."""
        k = max(self.num_tree_per_iteration, 1)
        total = (self._preset[0]["leaf_value"].shape[0]
                 if self._preset is not None else len(self.models))
        if num_iteration is not None and num_iteration > 0:
            total = min(total, num_iteration * k)
        div = (float(max(total // k, 1))
               if self.average_output and total > 0 else 1.0)
        return total, div

    def _forest(self, total: int):
        """(device tables, depth) of the first `total` trees: a
        `PackedForest` that appends the new trees (`_invalidate_tables`
        drops it), or the converted booster's preset tables."""
        if self._preset is None:
            if self._tables is None:
                self._tables = PackedForest(self.device)
            self._tables.sync(self.models)
            return self._tables.device(total), self._tables.depth
        if self._tables_key != total:
            tables, depth = self._preset
            tables = {n: (v[:total] if n != "cat_words" else v)
                      for n, v in tables.items()}
            self._preset_dev = (device_tables(tables, self.device), depth)
            self._tables_key = total
        return self._preset_dev

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1
                    ) -> np.ndarray:
        """[k, n] raw scores: bin the rows with the training mappers and
        walk the packed forest, both on the device, in row chunks."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        if self._pred_ctx is None:
            raise NotImplementedError(
                "predict on a model without the tpu_bin_mappers: trailer "
                "(the raw-value host walker) is not ported to "
                "lightgbm_tpu_torch yet")
        self._materialize()
        k = self.num_tree_per_iteration
        n = X.shape[0]
        out = np.zeros((k, n), np.float64)
        total, div = self._model_subset(num_iteration)
        if total == 0:
            return out
        tables, depth = self._forest(total)
        meta = self._pred_ctx.meta_dev(self.device)
        chunk = max(int(self.config.tpu_predict_chunk_rows)
                    if self.config is not None else 65536, 1024)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            bins_t = self._pred_ctx.bin_rows_t(X[lo:hi], self.device)
            scores = class_scores(tables, bins_t, meta, k, depth)
            out[:, lo:hi] = scores.cpu().numpy()
        # random-forest averaging (gbdt_prediction.cpp:55)
        return out / div

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        """[n] outputs, or [n, k] with several trees an iteration."""
        raw = self.predict_raw(X, num_iteration)
        if not raw_score and self.objective is not None:
            raw = self.objective.convert_output(raw)
        if raw.shape[0] == 1:
            return raw[0]
        return raw.T

    def health_profile(self) -> Optional[modelhealth.FeatureProfile]:
        """The training reference profile written as the model's
        `tpu_feature_profile:` trailer (lightgbm_tpu/models/gbdt.py:
        health_profile): rebuilt from the training data and the current
        train scores while the booster trains, else the loaded one; None
        with tpu_profile_capture=false and nothing loaded."""
        td = self.train_data
        if td is None or self.train_scores is None:
            return self._profile
        if self.config is not None and \
                not bool(self.config.tpu_profile_capture):
            return self._profile
        score_bins = (int(self.config.tpu_profile_score_bins)
                      if self.config is not None
                      else modelhealth.DEFAULT_SCORE_BINS)
        prof = modelhealth.FeatureProfile.from_training(
            td, self.feature_names, self.train_scores.numpy(), score_bins)
        return prof if prof is not None else self._profile

    # ------------------------------------------------------------------
    def shuffle_models(self, start: int = 0, end: int = -1) -> None:
        """Shuffle the trees [start, end) with a generator of seed 0
        (gbdt.py:2102); the cached device forest goes with the order."""
        self._materialize()
        self._invalidate_tables()
        if end < 0:
            end = len(self.models)
        seg = self.models[start:end]
        np.random.default_rng(0).shuffle(seg)
        self.models[start:end] = seg

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        """f64 per raw feature: the splits on it ("split") or the sum of
        their positive gains (gbdt.py:2177)."""
        self._materialize()
        imp = np.zeros(self.max_feature_idx + 1, np.float64)
        for tree in self.models:
            for j in range(tree.num_leaves - 1):
                f = int(tree.split_feature[j])
                if importance_type == "split":
                    imp[f] += 1
                else:
                    imp[f] += max(float(tree.split_gain[j]), 0.0)
        return imp

    def _feature_infos(self) -> List[str]:
        td = self.train_data
        if td is None:
            return list(self.loaded_params.get("feature_infos", []))
        used = set(td.used_feature_idx)
        infos = []
        for i, m in enumerate(td.mappers):
            if i not in used or m.is_trivial:
                infos.append("none")
            elif m.bin_type == BinType.CATEGORICAL:
                # the categories joined by ':' (gbdt.py:2205)
                infos.append(":".join(str(c)
                                      for c in sorted(m.bin_2_categorical)))
            else:
                infos.append(f"[{m.min_val!r}:{m.max_val!r}]")
        return infos

    def save_model_to_string(self, num_iteration: int = -1,
                             start_iteration: int = 0) -> str:
        self._materialize()
        if self._preset is not None:
            raise NotImplementedError(
                "model text of a booster converted from packed tables")
        buf = io.StringIO()
        buf.write("tree\n")
        buf.write("version=v3\n")
        buf.write(f"num_class={self.num_class}\n")
        buf.write(f"num_tree_per_iteration={self.num_tree_per_iteration}\n")
        buf.write(f"label_index={self.label_index}\n")
        buf.write(f"max_feature_idx={self.max_feature_idx}\n")
        if self.objective is not None:
            buf.write(f"objective={self.objective.to_model_string()}\n")
        if self.average_output:
            # a bare flag (gbdt_model_text.cpp:289)
            buf.write("average_output\n")
        buf.write("feature_names=" + " ".join(self.feature_names) + "\n")
        buf.write("feature_infos=" + " ".join(self._feature_infos()) + "\n")
        total = len(self.models)
        k = self.num_tree_per_iteration
        start = start_iteration * k
        end = total
        if num_iteration is not None and num_iteration > 0:
            end = min(total, start + num_iteration * k)
        tree_strs = [f"Tree={i - start}\n" + self.models[i].to_string()
                     for i in range(start, end)]
        buf.write("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs)
                  + "\n")
        buf.write("\n")
        for s in tree_strs:
            buf.write(s)
        buf.write("\nend of trees\n")
        imp = self.feature_importance("split")
        pairs = [(int(v), self.feature_names[i]) for i, v in enumerate(imp)
                 if v > 0]
        pairs.sort(key=lambda t: -t[0])
        buf.write("\nfeature_importances:\n")
        for v, name in pairs:
            buf.write(f"{name}={v}\n")
        buf.write("\nparameters:\n")
        if self.config is not None:
            for key, val in self.config.params.items():
                if isinstance(val, list):
                    val = ",".join(str(x) for x in val)
                if isinstance(val, bool):
                    val = int(val)
                buf.write(f"[{key}: {val}]\n")
        buf.write("\nend of parameters\n")
        if self._pred_ctx is not None:
            buf.write(_MAPPER_MARKER + json.dumps(self._pred_ctx.to_payload())
                      + "\n")
        prof = self.health_profile()
        if prof is not None:
            buf.write(prof.to_line())
        return buf.getvalue()

    def dump_model(self, num_iteration: int = -1, start_iteration: int = 0
                   ) -> Dict:
        """The model as JSON-able dicts (gbdt.py:2380-2448)."""
        self._materialize()
        k = self.num_tree_per_iteration
        start = start_iteration * k
        end = len(self.models)
        if num_iteration is not None and num_iteration > 0:
            end = min(end, start + num_iteration * k)
        return {
            "name": "tree",
            "version": "v3",
            "average_output": bool(self.average_output),
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": self.label_index,
            "max_feature_idx": self.max_feature_idx,
            "objective": (self.objective.to_model_string()
                          if self.objective else "none"),
            "feature_names": list(self.feature_names),
            "tree_info": [_tree_to_json(i, self.models[i])
                          for i in range(start, end)],
        }

    @classmethod
    def from_model_string(cls, text: str, device) -> "GBDT":
        self = cls()
        self.device = device
        pos = text.rfind("\npandas_categorical:")
        if pos >= 0:
            text = text[:pos]
        text, self._profile = modelhealth.split_profile_trailer(text)
        text, ctx = _split_mapper_snapshot(text)
        refuse_host_predict(_text_params(text).get("tpu_predict_device",
                                                   "auto"),
                            "in the model text's parameters")
        lines = text.split("\n")
        kv: Dict[str, str] = {}
        tree_blocks: List[str] = []
        i = 0
        while i < len(lines):
            line = lines[i]
            if line.startswith("Tree="):
                block = [line]
                i += 1
                while i < len(lines) and not lines[i].startswith("Tree=") \
                        and not lines[i].startswith("end of trees"):
                    block.append(lines[i])
                    i += 1
                tree_blocks.append("\n".join(block))
                continue
            if line.startswith("end of trees"):
                break
            if line.strip() == "average_output":
                kv["average_output"] = "1"
            elif "=" in line:
                key, v = line.split("=", 1)
                kv[key] = v
            i += 1
        self.num_class = int(kv.get("num_class", "1"))
        self.average_output = "average_output" in kv
        self.num_tree_per_iteration = int(kv.get("num_tree_per_iteration",
                                                 "1"))
        self.label_index = int(kv.get("label_index", "0"))
        self.max_feature_idx = int(kv.get("max_feature_idx", "0"))
        self.feature_names = kv.get("feature_names", "").split()
        self.loaded_params = {"feature_infos":
                              kv.get("feature_infos", "").split(),
                              "objective": kv.get("objective", "")}
        if "objective" in kv:
            self.objective = create_objective_from_model_string(
                kv["objective"])
        for block in tree_blocks:
            self.models.append(Tree.from_string(
                block.split("\n", 1)[1] if "\n" in block else ""))
        if ctx is not None:
            for tree in self.models:
                if tree.num_leaves > 1:
                    _rebind_tree(tree, ctx)
            self._pred_ctx = ctx
        self.iter_ = self.current_iteration()
        return self


def _text_params(text: str) -> Dict[str, str]:
    """The `[key: value]` lines of a model text's parameters block."""
    start = text.find("\nparameters:\n")
    if start < 0:
        return {}
    end = text.find("\nend of parameters", start)
    block = text[start:end if end >= 0 else len(text)]
    return {m.group(1): m.group(2)
            for m in re.finditer(r"^\[([^:\]]+): ?(.*)\]$", block, re.M)}


def _tree_to_json(idx: int, tree: Tree) -> Dict:
    """One tree of dump_model (gbdt.py:_tree_to_json): a categorical
    node's threshold is its raw categories joined by "||" and its
    decision type "==", as the reference dump writes them (src/io/tree.cpp
    ToJSON)."""
    def node(i: int) -> Dict:
        if i < 0:
            leaf = ~i
            return {"leaf_index": int(leaf),
                    "leaf_value": float(tree.leaf_value[leaf]),
                    "leaf_weight": float(tree.leaf_weight[leaf]),
                    "leaf_count": int(tree.leaf_count[leaf])}
        dt = int(tree.decision_type[i])
        if dt & 1:
            ci = int(tree.threshold[i])
            lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
            thr = "||".join(str(32 * (w - lo) + b) for w in range(lo, hi)
                            for b in range(32)
                            if (tree.cat_threshold[w] >> b) & 1)
        else:
            thr = float(tree.threshold[i])
        return {
            "split_index": int(i),
            "split_feature": int(tree.split_feature[i]),
            "split_gain": float(tree.split_gain[i]),
            "threshold": thr,
            "decision_type": "==" if dt & 1 else "<=",
            "default_left": bool(dt & 2),
            "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
            "internal_value": float(tree.internal_value[i]),
            "internal_weight": float(tree.internal_weight[i]),
            "internal_count": int(tree.internal_count[i]),
            "left_child": node(int(tree.left_child[i])),
            "right_child": node(int(tree.right_child[i])),
        }
    return {
        "tree_index": idx,
        "num_leaves": int(tree.num_leaves),
        "num_cat": int(tree.num_cat),
        "shrinkage": float(tree.shrinkage),
        "tree_structure": node(0) if tree.num_leaves > 1 else {
            "leaf_value": float(tree.leaf_value[0])},
    }


class _FevalData:
    """Minimal Dataset-like shim passed to custom feval callbacks."""

    def __init__(self, td: TrainingData):
        self._td = td

    def get_label(self):
        return np.asarray(self._td.metadata.label)

    def get_weight(self):
        w = self._td.metadata.weight
        return None if w is None else np.asarray(w)

    def get_group(self):
        b = self._td.metadata.query_boundaries
        return None if b is None else np.diff(b)
