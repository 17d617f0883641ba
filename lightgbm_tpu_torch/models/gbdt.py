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

The model utilities (lightgbm_tpu/models/gbdt.py:1197-1224, 1889-2100,
2346-2378): the raw-value walker (`ops/predict.py`) for models without
the mapper trailer, `tpu_predict_device=false`, `pred_leaf` and the
prediction early stop; SHAP contributions (`models/shap.py`); `refit`
of every leaf on new data, its per-leaf f64 sums in row order through
`ops/leafsum.py`; `merge_from_model_string` (init_model continuation,
the loaded trees replayed onto the score states as the JAX package
replays them); `rollback_one_iter`; and `reset_config` of any parameter,
which rebuilds the learner and the train step.

Fault tolerance and device memory (lightgbm_tpu/models/gbdt.py:
548-1030, 1287-1417): every iteration is atomic (`train_one_iter`
snapshots the scores, the key streams, the generators and the counters,
and rolls a raising iteration back); the numeric guard
(`tpu_guard_numerics`); a classified device OOM inside an iteration
descends the degradation ladder of `utils/membudget.py` and retries;
the memory preflight runs before iteration 0; and
`capture_train_state`/`restore_train_state` are the driver's half of
the checkpoint bundle (`utils/checkpoint.py`).  Torch tensors can change
in place where JAX arrays cannot, so every update of a `_ScoreState`
inside an iteration writes a new buffer (the fused step's, or a copy),
and the snapshot holds references, as the JAX package's does: the fused
path pays no copy for it.

Left out, and not silently: the span tracer (ROADMAP A11).
"""

from __future__ import annotations

import io
import json
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, parse_tristate
from ..io.bin_mapper import BinMapper, BinType
from ..io.dataset import Metadata, TrainingData
from .. import obs
from ..obs import modelhealth
from ..ops import leafsum
from ..ops.binning import bin_matrix_t
from ..ops.predict import (PackedForest, class_scores, device_tables,
                           forest_walk_bytes, leaf_values, pack_raw_trees,
                           pack_trees, raw_device_tables, raw_forest_scores,
                           raw_leaf_index, subset_scores, tree_leaf_values,
                           upload)
from ..utils import faultline, membudget
from ..utils.log import LightGBMError, Log
from ..utils.prng import PRNGKey
from .learner import TreeLearner, _to_bitset, make_tree_learner
from .metrics import Metric, create_metrics
from .objectives import (Objective, create_objective,
                         create_objective_from_model_string)
from .tree import Tree

K_EPSILON = 1e-15
_MAPPER_MARKER = "tpu_bin_mappers:"


def quant_headroom_check(precision: str, total_rows: int, mode: str) -> int:
    """The int32 histogram headroom sentinel of the quantized precisions
    (lightgbm_tpu/models/gbdt.py:40-70): `quant_limit` narrows the
    gradient grid with the row count so no bin overflows int32; warn
    when the grid has narrowed below the dtype's range, and under
    tpu_guard_numerics=raise refuse once it has lost two bits of it
    (floor capped at 128)."""
    from ..ops.histogram import _INT_TYPE_MAX, quant_limit

    q = quant_limit(precision, total_rows)
    full = _INT_TYPE_MAX[precision]
    if q < full:
        msg = (f"int32 histogram headroom: {total_rows} rows narrow the "
               f"{precision} gradient grid to +-{q} (dtype max +-{full})")
        if mode == "raise" and q < min(128, full // 4):
            raise LightGBMError(
                msg + "; use a wider precision or fewer global rows")
        Log.warning(msg)
    return q


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

    def bin_rows_t(self, X: np.ndarray, device,
                   scratch: Optional[Dict[str, int]] = None) -> torch.Tensor:
        """[F_used, n] device bins of raw rows in training-mapper space
        (scratch: `bin_matrix_t`'s, the binning chunk's bytes)."""
        return bin_matrix_t(X, self.mappers, self.used_feature_idx, device,
                            scratch=scratch)


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
    """Raw scores [k, n] f32 on the device.  Each update writes a new
    buffer, so an iteration's rollback snapshot can hold the old one."""

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
        self.scores = self.scores.clone()
        self.scores[class_id] += np.float32(val)

    def add(self, class_id: int, delta: torch.Tensor) -> None:
        self.scores = self.scores.clone()
        self.scores[class_id] += delta

    def multiply(self, class_id: int, val: float) -> None:
        """Scale one class's scores by f32(val) (the RF running average,
        reference score_updater.hpp MultiplyScore)."""
        self.scores = self.scores.clone()
        self.scores[class_id] *= np.float32(val)

    def numpy(self) -> np.ndarray:
        return self.scores.cpu().numpy().astype(np.float64)


class GBDT:
    """The gradient boosting driver."""

    # consecutive poisoned iterations tpu_guard_numerics=skip takes
    _GUARD_MAX_STREAK = 5

    def __init__(self):
        self.models: List[Tree] = []
        # iter_ counts the boosting rounds of this run; the trees of an
        # init model are in models but not in iter_
        self.iter_ = 0
        self.num_init_iteration = 0
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
        # the raw-value walker's device tables: (models key, tables, depth)
        self._raw: Optional[Tuple] = None
        # host waits of the grower, summed over trained trees
        self.grower_syncs = 0
        self.last_score_bytes = 0
        # the largest predict chunk's tensors of the last bin-space
        # predict (utils/membudget.py:live_bytes), None before one
        self.predict_scratch_bytes: Optional[int] = None
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
        self.valid_names: List[str] = []
        # the numeric guard (tpu_guard_numerics) and its skip state
        self._guard = "off"
        self._guard_streak = 0
        self._guard_skips_total = 0
        # a skip's retry draws a fresh bagging mask off the refresh
        # boundary, or it would replay the poisoned iteration
        self._force_bag_refresh = False
        # the OOM ladder: its position persists across recoveries; the
        # learner state carried across a ladder rebuild until one
        # succeeds
        self._mem_ladder = membudget.DegradationLadder()
        self._ladder_carry = None
        # a config-less booster's shrunk predict chunk
        self._predict_chunk_override: Optional[int] = None

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
        # the collective watchdog's deadline and retries (gbdt.py:326-331
        # of the JAX package), and the flight recorder's depth and dump
        # directory (tpu_obs_*)
        from ..parallel.collective import configure_from_config

        configure_from_config(config)
        obs.configure_from_config(config)
        self.learner = make_tree_learner(config, train_data)
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
        # the numeric guard, validated at init; the quantized headroom
        # sentinel is a one-time check (gbdt.py:316-336)
        self._guard = str(config.tpu_guard_numerics).strip().lower()
        if self._guard not in ("off", "warn", "raise", "skip"):
            raise ValueError("tpu_guard_numerics must be off|warn|raise|"
                             f"skip, got {self._guard!r}")
        if self._guard != "off" \
                and str(config.tpu_hist_precision) in ("int8", "int16"):
            quant_headroom_check(str(config.tpu_hist_precision),
                                 train_data.num_data, self._guard)
        self._make_train_step()
        # the memory preflight, before iteration 0
        self._run_preflight()

    def _make_train_step(self) -> None:
        """(Re)build the fused step where the JAX package's GBDT builds it
        (gbdt.py:356-380): a built-in objective whose gradients run on
        the device, with no leaf refit on the host, no CEGB, and every
        class trainable.  Otherwise (objective=none, the ranking
        objectives, the percentile family, CEGB, whose state crosses
        trees through the learner's `train`, the streamed layout, whose
        trees grow from host blocks in the learner's `train`
        (gbdt.py:372-375), a single label class) every iteration takes
        the sync step."""
        self._step = None
        obj = self.objective
        if (obj is not None and not obj.needs_renew and not obj.host_only
                and not self.learner.params.has_cegb
                and not self.learner.stream_layout
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
            is_pos = np.zeros(self.learner.row_width, bool)
            is_pos[:len(label)] = label > 0
            out["is_pos"] = is_pos
        return out

    def reset_config(self, config: Config) -> None:
        """Take new parameters between iterations (reset_parameter), as
        lightgbm_tpu/models/gbdt.py:2093-2100 does: a new learner from the
        config (which restarts its feature generator from its seed; the
        booster's key streams and bagging generator go on), the bagging
        plan and the train step rebuilt."""
        self._materialize()
        self.config = config
        self.shrinkage_rate = float(config.learning_rate)
        if self.learner is not None:
            self.learner = make_tree_learner(config, self.train_data)
            self._bag_cfg = self._bagging_config()
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
        self.valid_names = []
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
        self.valid_names.append(str(name))
        ms = create_metrics(self.config,
                            self.objective.name if self.objective else "")
        for m in ms:
            m.init(data.metadata, data.num_data)
        self.valid_metrics.append(ms)
        state = _ScoreState(self.num_tree_per_iteration, data.num_data,
                            self.device, data.metadata.init_score)
        self.valid_scores.append(state)
        self._replay(state, data, self.models)

    def _replay_in_blocks(self, n: int) -> bool:
        """Whether a replay over n rows takes the JAX package's device
        walk (gbdt.py:_device_replay_ok): tpu_predict_device true, or
        auto at tpu_predict_min_rows rows or more; else its host walk."""
        mode = parse_tristate(self.config.tpu_predict_device)
        if mode != "auto":
            return mode == "true"
        return n >= int(self.config.tpu_predict_min_rows)

    def _replay(self, state: _ScoreState, data: TrainingData,
                trees: List[Tree]) -> None:
        """Add the listed trees' raw scores over a binned dataset (tree i
        to class i % k) to a score state, in the JAX package's order
        (gbdt.py:_replay_scores_device and its host fallback): on its
        device walk, blocks of k * max(128 // k, 1) trees, each block's
        per-class f32 sum (`class_scores`, XLA's order) added in turn; on
        its host walk, each tree's f32 leaf values added in turn."""
        if not trees:
            return
        k = max(self.num_tree_per_iteration, 1)
        meta = self._pred_ctx.meta_dev(self.device)
        n = data.num_data
        blocked = self._replay_in_blocks(n)
        step = k * max(128 // k, 1) if blocked else 128
        chunk = self._predict_chunk()
        faultline.fire("h2d_copy", rows=n)
        for s in range(0, len(trees), step):
            block = list(trees[s:s + step])
            tables, depth = pack_trees(block)
            tables = device_tables(tables, self.device)
            with membudget.oom_guard("score_replay", rows=n,
                                     trees=len(trees)):
                for lo in range(0, n, chunk):
                    hi = min(lo + chunk, n)
                    # the streamed layout keeps the training bins in host
                    # memory: a chunk at a time goes to the device
                    bins_t = data.bins_t[:, lo:hi].to(self.device)
                    if blocked:
                        scores = class_scores(tables, bins_t, meta, k,
                                              depth)
                        for kk in range(k):
                            state.scores[kk, lo:hi] += scores[kk]
                        continue
                    vals = leaf_values(tables, bins_t, *meta, depth)
                    for j in range(len(block)):
                        state.scores[(s + j) % k, lo:hi] += vals[j]

    def _predict_chunk(self) -> int:
        """Rows a predict or replay walks at once (a booster without a
        Config, loaded from a file, keeps its shrunk chunk apart)."""
        if self.config is not None:
            return max(int(self.config.tpu_predict_chunk_rows), 1024)
        ov = self._predict_chunk_override
        return max(int(ov) if ov is not None else 65536, 1024)

    def _shrink_predict_chunk(self) -> bool:
        """Halve the predict chunk after a classified predict-path OOM
        (gbdt.py:1759-1779); False at the floor.  The walk is row by row,
        so the chunk changes no output byte."""
        cur = self._predict_chunk()
        if cur <= membudget.CHUNK_FLOOR:
            return False
        new = max(cur // 2, membudget.CHUNK_FLOOR)
        if self.config is not None:
            self.config.update({"tpu_predict_chunk_rows": new})
        else:
            self._predict_chunk_override = new
        membudget.note_ladder_step("predict_chunk", "shrink_chunk_rows",
                                   {"tpu_predict_chunk_rows": new})
        Log.warning(f"device OOM in chunked predict: shrinking "
                    f"tpu_predict_chunk_rows {cur} -> {new} and "
                    "re-running (outputs are chunk-invariant)")
        return True

    def _chunked_scores(self, n: int, walk) -> np.ndarray:
        """[k, n] f64 host scores of `walk(lo, hi)` ([k, hi - lo] device
        scores) over row chunks (gbdt.py:1789-1845): each chunk runs
        under the predict_chunk guard, and a classified OOM halves the
        chunk and resumes at the failed one, keeping the chunks done."""
        out = np.zeros((self.num_tree_per_iteration, n), np.float64)
        lo = 0
        while lo < n:
            hi = min(lo + self._predict_chunk(), n)
            try:
                faultline.fire("h2d_copy", rows=hi - lo)
                with membudget.oom_guard("predict_chunk", rows=hi - lo):
                    out[:, lo:hi] = walk(lo, hi).cpu().numpy()
            except membudget.DeviceOutOfMemory:
                if not self._shrink_predict_chunk():
                    raise
                continue
            lo = hi
        return out

    def _boost_from_average(self, class_id: int) -> float:
        if (self.models or self._pending
                or self._boosted_from_average[class_id]
                or self.train_scores.has_init_score):
            return 0.0
        self._boosted_from_average[class_id] = True
        if not self.config.boost_from_average:
            return 0.0
        init = self.objective.boost_from_score(class_id)
        if self._multiproc():
            # every rank's init comes from its own rows: the ranks agree
            # on the mean over processes (gbdt.py:490-499,
            # GlobalSyncUpByMean); the same value where every rank holds
            # every row
            from ..parallel.metric_sync import process_count, sync_sums

            init = float(sync_sums([init])[0] / process_count())
        if abs(init) > K_EPSILON:
            self.train_scores.add_constant(init, class_id)
            for vs in self.valid_scores:
                vs.add_constant(init, class_id)
            return init
        return 0.0

    def _multiproc(self) -> bool:
        """Does the learner run a grid across several processes?"""
        t = getattr(self.learner, "topology", None)
        return t is not None and t.processes > 1

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
        path.

        The iteration applies atomically (gbdt.py:548-575): an
        exception anywhere inside (KeyboardInterrupt, SIGTERM through
        engine.train, a CUDA error, an armed `grow_step` fault) rolls
        it back to its snapshot before it propagates, so the booster
        predicts, trains on and checkpoints afterwards.  A classified
        device OOM rides the same rollback, then descends one rung of
        the degradation ladder and retries; exhaustion raises
        `MemoryLadderExhausted`."""
        while True:
            try:
                return self._train_one_iter_guarded(grad, hess)
            except membudget.DeviceOutOfMemory as exc:
                self._recover_from_oom(exc)

    def _train_one_iter_guarded(self, grad, hess) -> bool:
        if self._stopped:
            return True
        if self.learner is None and self._ladder_carry is not None:
            # a ladder rebuild OOMed and the run ended exhausted: retry
            # the rebuild, so training can go on once memory is back
            self._rebuild_learner()
        snap = self._iter_snapshot()
        try:
            with membudget.oom_guard("train_step", iteration=self.iter_):
                action = faultline.fire("grow_step", iteration=self.iter_)
                ret = self._train_one_iter_impl(grad, hess)
        except BaseException:
            self._iter_restore(snap)
            raise
        # the score buffers the iteration held at once, its snapshot's
        # and its own (utils/membudget.py:live_bytes)
        self.last_score_bytes = membudget.unique_nbytes(
            snap["scores"], *snap["valid"],
            None if self.train_scores is None else self.train_scores.scores,
            *(vs.scores for vs in self.valid_scores))
        if action == "poison":
            # fault harness: NaN-poison this iteration's scores (a new
            # tensor: the snapshot's buffer stays clean)
            self.train_scores.scores = (self.train_scores.scores
                                        + np.float32(np.nan))
        if self._guard != "off" and not ret and not self._scores_finite():
            return self._poisoned_iteration(snap)
        self._guard_streak = 0
        self._force_bag_refresh = False
        return ret

    # -- atomic-iteration rollback -------------------------------------
    def _iter_snapshot(self) -> Dict:
        """The pre-iteration state a rollback returns to
        (gbdt.py:677-702): references to the score buffers (an update
        writes a new one, `_ScoreState`), the pending records, the row
        mask and the CEGB state, which are replaced, never written; copies
        of the key words, the generators' states and the counters."""
        learner = self.learner
        frng = getattr(learner, "_feature_rng", None)
        snap = {
            "scores": (self.train_scores.scores
                       if self.train_scores is not None else None),
            "valid": [vs.scores for vs in self.valid_scores],
            "key": None if self._key is None else self._key.copy(),
            "bag_key": (None if self._bag_key is None
                        else self._bag_key.copy()),
            "pending": list(self._pending),
            "models": len(self.models),
            "bfa": list(getattr(self, "_boosted_from_average", [])),
            "bag_mask": self._cached_bag_mask,
            "bag_rng": (self._bag_rng.bit_generator.state
                        if self._bag_rng is not None else None),
            "feature_rng": (frng.bit_generator.state
                            if frng is not None else None),
            "cegb": ({k: learner.meta[k] for k in ("cegb_used", "cegb_paid")
                      if k in learner.meta} if learner is not None else {}),
            "iter": self.iter_,
            "stopped": self._stopped,
            "shrinkage": self.shrinkage_rate,
            "syncs": self.grower_syncs,
        }
        snap.update(self._snapshot_extra())
        return snap

    def _snapshot_extra(self) -> Dict:
        return {}

    def _restore_extra(self, snap: Dict) -> None:
        pass

    def _iter_restore(self, snap: Dict) -> None:
        """Roll a partly applied iteration back to its snapshot
        (gbdt.py:710-746).  The snapshot's buffers become the live ones
        again: the iteration's queued kernels wrote only into newer
        buffers, which nothing reads any more.  Trees a sync step
        materialized go back to the pending list they came from."""
        if self.train_scores is not None and snap["scores"] is not None:
            self.train_scores.scores = snap["scores"]
        for vs, s in zip(self.valid_scores, snap["valid"]):
            vs.scores = s
        self._key = snap["key"]
        self._bag_key = snap["bag_key"]
        self._pending = list(snap["pending"])
        del self.models[snap["models"]:]
        if snap["bfa"]:
            self._boosted_from_average = snap["bfa"]
        self._cached_bag_mask = snap["bag_mask"]
        if snap["bag_rng"] is not None:
            self._bag_rng.bit_generator.state = snap["bag_rng"]
        if self.learner is not None:
            if snap["feature_rng"] is not None:
                self.learner._feature_rng.bit_generator.state = \
                    snap["feature_rng"]
            self.learner.meta.update(snap["cegb"])
        self.iter_ = snap["iter"]
        self._stopped = snap["stopped"]
        self.shrinkage_rate = snap["shrinkage"]
        self.grower_syncs = snap["syncs"]
        self._invalidate_tables()
        self._restore_extra(snap)

    # -- the numeric guard (tpu_guard_numerics) ------------------------
    def _scores_finite(self) -> bool:
        """One all-isfinite reduction over the train scores and one host
        wait, paid only while the guard is armed."""
        if self.train_scores is None:
            return True
        return bool(torch.isfinite(self.train_scores.scores).all())

    def _poisoned_iteration(self, snap: Dict) -> bool:
        """A non-finite iteration (gbdt.py:953-1014): warn and go on,
        roll back and raise, or roll back and skip, keeping the advanced
        streams and forcing a fresh bagging mask so the retry differs."""
        it = snap["iter"]
        obs.REGISTRY.inc("lgbm_guard_poisoned_total", mode=self._guard,
                         help="non-finite-score iterations caught by "
                              "tpu_guard_numerics")
        obs.event("guard_poisoned", iteration=it, mode=self._guard)
        obs.flightrecorder.note("guard", "guard_poisoned",
                                iteration=it, mode=self._guard)
        if self._guard == "warn":
            Log.warning(f"non-finite training scores after iteration {it} "
                        "(tpu_guard_numerics=warn): continuing")
            return False
        if self._guard == "raise":
            self._iter_restore(snap)
            exc = LightGBMError(
                f"non-finite training scores after iteration {it} "
                "(tpu_guard_numerics=raise); the poisoned iteration was "
                "rolled back")
            obs.flightrecorder.dump("guard_raise", exc=exc)
            raise exc
        if not self._has_skip_lever():
            self._iter_restore(snap)
            raise LightGBMError(
                f"non-finite training scores after iteration {it} and no "
                "stochastic lever to re-bag (tpu_guard_numerics=skip "
                "needs bagging/GOSS/feature_fraction/quantized rounding "
                "to vary the retry)")
        keys = (self._key, self._bag_key)
        bag_rng = (self._bag_rng.bit_generator.state
                   if self._bag_rng is not None else None)
        frng = getattr(self.learner, "_feature_rng", None)
        feat_rng = frng.bit_generator.state if frng is not None else None
        self._iter_restore(snap)
        self._key, self._bag_key = keys
        if bag_rng is not None:
            self._bag_rng.bit_generator.state = bag_rng
        if feat_rng is not None:
            self.learner._feature_rng.bit_generator.state = feat_rng
        self._advance_streams_for_skip()
        self._guard_streak += 1
        self._guard_skips_total += 1
        if self._guard_streak > self._GUARD_MAX_STREAK:
            raise LightGBMError(
                f"{self._guard_streak} consecutive poisoned iterations "
                "under tpu_guard_numerics=skip; giving up")
        Log.warning(f"dropped poisoned iteration {it} "
                    "(tpu_guard_numerics=skip): rolled back, re-bagging")
        return False

    def _has_skip_lever(self) -> bool:
        """Whether a skip's retry can differ from the dropped iteration:
        bagging, GOSS, feature_fraction or quantized rounding."""
        if self._bag_cfg is not None or self._goss_cfg is not None:
            return True
        if self.config is not None \
                and float(self.config.feature_fraction) < 1.0:
            return True
        return (self.learner is not None
                and self.learner.params.precision in ("int8", "int16"))

    def _advance_streams_for_skip(self) -> None:
        """Force a fresh bagging mask even off the bagging_freq boundary
        (the fused step only takes _bag_key on a refresh; the sync path
        only redraws without a cached mask)."""
        self._cached_bag_mask = None
        self._force_bag_refresh = True

    # -- device memory (utils/membudget.py) ----------------------------
    def _oom_recoverable(self) -> bool:
        """May a classified OOM descend the ladder here?  A live training
        context with tpu_oom_recovery=true."""
        if (self.config is None or self.train_data is None
                or not bool(self.config.tpu_oom_recovery)):
            return False
        return self.learner is not None or self._ladder_carry is not None

    def _recover_from_oom(self, exc: "membudget.DeviceOutOfMemory",
                          in_recovery: bool = False) -> None:
        """One ladder descent after a rolled-back OOM iteration, or the
        structured error (gbdt.py:762-817)."""
        if not (in_recovery or self._oom_recoverable()):
            obs.flightrecorder.note(
                "oom", "oom_propagated", site=exc.site, recovery="off",
                **{k: v for k, v in membudget.memory_snapshot().items()
                   if v is not None})
            obs.flightrecorder.dump("oom_unrecovered", exc=exc)
            raise exc
        step = self._mem_ladder.next_step(self.config)
        if step is None:
            taken = self._mem_ladder.describe()
            obs.flightrecorder.note(
                "oom", "ladder_exhausted", site=exc.site,
                steps_taken=",".join(taken) or "none",
                **{k: v for k, v in membudget.memory_snapshot().items()
                   if v is not None})
            err = membudget.MemoryLadderExhausted(
                f"device out of memory at {exc.site!r} and the "
                "degradation ladder is exhausted "
                f"(steps taken: {taken or 'none'}); the failed "
                "iteration was rolled back — the booster is usable and "
                "a final checkpoint covers the last complete iteration",
                site=exc.site, info=dict(exc.info))
            obs.flightrecorder.dump("oom_ladder_exhausted", exc=err)
            raise err from exc
        name, overrides = step
        membudget.note_ladder_step(exc.site, name, overrides)
        Log.warning(
            f"device OOM at {exc.site!r} (iteration {self.iter_}): "
            f"rolled back; degradation ladder step {name!r} applies "
            f"{overrides} — retrying (the settled model is byte-identical "
            "to an undisturbed run at this config)")
        try:
            self.apply_memory_degradation(overrides)
        except membudget.DeviceOutOfMemory as rebuild_exc:
            self._recover_from_oom(rebuild_exc, in_recovery=True)

    # parameters whose change rebuilds the learner and the train step;
    # the chunk sizes take effect at the next launch.  The JAX package
    # leaves tpu_hist_impl out, so its fused_unfuse rung changes nothing
    # until a later rebuild; here it takes B2 out at once
    _REBUILD_KEYS = frozenset({"tpu_hist_impl", "tpu_hist_agg",
                               "tpu_bucket_policy", "tpu_stream_mode"})

    def apply_memory_degradation(self, overrides: Dict) -> None:
        """Apply a ladder step's parameters to the live run
        (gbdt.py:819-865): the old learner's tensors go before the new
        one is built (`torch.cuda.empty_cache` between), so two learners
        are never resident; its feature generator and CEGB state carry
        over."""
        if not overrides:
            return
        self.config.update(overrides)
        if not (self._REBUILD_KEYS & set(overrides)):
            return
        if self.train_data is None or (self.learner is None
                                       and self._ladder_carry is None):
            return
        if self.learner is not None:
            self._materialize()  # pending records belong to the OLD grower
            old = self.learner
            self._ladder_carry = (
                old._feature_rng.bit_generator.state,
                {k: old.meta[k] for k in ("cegb_used", "cegb_paid")
                 if k in old.meta})
            self._step = None
            self.learner = None
            old.bins_t = None
            old.meta = None
            old._stream = None
            del old
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.empty_cache()
        self._rebuild_learner()

    def _rebuild_learner(self) -> None:
        """The learner for the current config with the carried state, under
        oom_guard: a failed rebuild is a classified train-step OOM."""
        with membudget.oom_guard("train_step", stage="ladder_rebuild"):
            self.learner = make_tree_learner(self.config, self.train_data)
        rng_state, cegb = self._ladder_carry or (None, {})
        self._ladder_carry = None
        if rng_state is not None:
            self.learner._feature_rng.bit_generator.state = rng_state
        self.learner.meta.update(cegb)
        self._bag_cfg = self._bagging_config()
        self._invalidate_tables()
        self._make_train_step()

    def _run_preflight(self) -> None:
        """tpu_hbm_preflight before iteration 0 (gbdt.py:887-941): the
        itemized plan against the budget — warn, refuse with the plan,
        or descend the ladder's config steps until it fits."""
        mode = str(self.config.tpu_hbm_preflight).strip().lower()
        if mode not in ("off", "warn", "raise", "degrade"):
            raise ValueError("tpu_hbm_preflight must be off|warn|raise|"
                             f"degrade, got {mode!r}")
        if mode == "off":
            return
        plan = membudget.plan_training(self.config, self.learner,
                                       self.num_tree_per_iteration)
        membudget.publish_budget_gauge(plan.budget, "training")
        if plan.fits is not False:
            return
        if mode == "degrade":
            pending: Dict = {}
            while plan.fits is False:
                step = self._mem_ladder.next_step(self.config)
                if step is None:
                    break
                name, overrides = step
                membudget.note_ladder_step("preflight", name, overrides,
                                           recovery=False)
                self.config.update(overrides)
                pending.update(overrides)
                plan = membudget.plan_training(
                    self.config, self.learner, self.num_tree_per_iteration)
            if plan.fits is not False:
                Log.warning(
                    "HBM preflight degraded the configuration to fit "
                    f"the budget: {pending}; headroom now "
                    f"{plan.headroom:,d} bytes")
                rebuild = {k: v for k, v in pending.items()
                           if k in self._REBUILD_KEYS}
                if rebuild:
                    self.apply_memory_degradation(rebuild)
                return
        if mode == "warn":
            Log.warning("HBM preflight: predicted peak exceeds the "
                        "budget (tpu_hbm_preflight=warn):\n"
                        + plan.format_table())
            return
        obs.flightrecorder.note("oom", "preflight_refused",
                                total=plan.total, budget=plan.budget)
        raise LightGBMError(plan.refuse_message(
            "training preflight (tpu_hbm_preflight="
            f"{mode}): this configuration"))

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
            refresh = bag is not None and (self.iter_ % bag["freq"] == 0
                                           or self._force_bag_refresh)
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
            if getattr(self.learner, "_partitioned", False):
                # each machine refit its leaves on its own rows: average
                # each leaf's output over the machines that had rows on
                # it (gbdt.py:1168-1180, reference
                # serial_tree_learner.cpp:865-891)
                from ..parallel.metric_sync import sync_sums

                L = tree.num_leaves
                cnt = np.bincount(leaf_np[mask_np], minlength=L)[:L]
                has = (cnt > 0).astype(np.float64)
                outs = np.asarray(tree.leaf_value[:L], np.float64) * has
                g = sync_sums(np.concatenate([outs, has]))
                tree.leaf_value[:L] = g[:L] / np.maximum(g[L:], 1.0)
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
        meta = self._pred_ctx.meta_dev(self.device)
        return self._binned_rows(bins_t, lambda b: subset_scores(
            trees, scales, b, meta))

    def _invalidate_tables(self) -> None:
        """Drop the cached forest tables: they append the trees trained
        since they were last read, so a change of leaf values in place
        (DART's shrinkage of dropped trees) or of the order must clear
        them."""
        self._tables_key = None
        self._tables = None
        self._raw = None

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
        self.iter_ = (len(self.models) // max(self.num_tree_per_iteration, 1)
                      - self.num_init_iteration)

    def rollback_one_iter(self) -> None:
        """Take the last iteration's trees out of the model and their
        f32 leaf values out of the train and validation scores
        (lightgbm_tpu/models/gbdt.py:1197-1224)."""
        self._materialize()
        self._invalidate_tables()
        if self.iter_ <= 0:
            return
        k = self.num_tree_per_iteration
        for c in range(k):
            tree = self.models.pop()
            for state, data in self._score_sets():
                state.add(k - 1 - c, -self._tree_values(tree, data))
        self.iter_ -= 1

    def _score_sets(self):
        """(score state, dataset) of the training set, then of each
        validation set."""
        return [(self.train_scores, self.train_data),
                *zip(self.valid_scores, self.valid_sets)]

    def _tree_values(self, tree: Tree, data: TrainingData) -> torch.Tensor:
        """[n] f32 leaf values of one tree over a binned dataset."""
        tables, depth = pack_trees([tree],
                                   leaf_width=int(self.config.num_leaves))
        tables = device_tables(tables, self.device)
        meta = self._pred_ctx.meta_dev(self.device)
        return self._binned_rows(data.bins_t, lambda bins_t:
                                 tree_leaf_values(tables, bins_t, meta, depth))

    def _binned_rows(self, bins_t: torch.Tensor, fn) -> torch.Tensor:
        """fn([F, rows] device bins) -> [rows] values over a dataset's
        [F, n] bins: at once where they are on the device, else (the
        streamed layout's training set, in host memory) in predict
        chunks copied there, the per-row values concatenated."""
        if bins_t.device == self.device:
            return fn(bins_t)
        chunk = self._predict_chunk()
        return torch.cat([fn(bins_t[:, lo:lo + chunk].to(self.device))
                          for lo in range(0, bins_t.shape[1], chunk)])

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
        self._replay(state, data, self.models)
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

    def host_predict(self) -> bool:
        """tpu_predict_device=false among the training parameters, or in
        a loaded model text's: predict takes the raw-value walker."""
        mode = (self.config.tpu_predict_device if self.config is not None
                else self.loaded_params.get("tpu_predict_device", "auto"))
        return parse_tristate(mode) == "false"

    def _raw_forest(self, total: int):
        """(device tables, depth) of the first `total` trees for the
        raw-value walker, packed once for the model as it stands (keyed
        by its count and last tree, as gbdt.py:_forest_tables keys its
        cache; a change in place goes through _invalidate_tables)."""
        if self._preset is not None:
            raise NotImplementedError(
                "the raw-value walk of a booster converted from packed "
                "tables (it has no trees)")
        key = (len(self.models), id(self.models[-1]) if self.models else 0)
        if self._raw is None or self._raw[0] != key:
            tables, depth = pack_raw_trees(self.models)
            self._raw = (key, raw_device_tables(tables, self.device), depth)
        _, tables, depth = self._raw
        if total < len(self.models):
            tables = {n: (v[:total] if n != "cat_words" else v)
                      for n, v in tables.items()}
        return tables, depth

    def _raw_walk(self, X: np.ndarray, total: int, leaves: bool = False,
                  early_stop_freq: int = 0, early_stop_margin: float = 0.0
                  ) -> torch.Tensor:
        """The raw-value walk of the first `total` trees over the raw rows
        X [n, F] on the device, in row chunks: [k, n] f64 raw scores
        (`raw_forest_scores`, with the prediction early stop), or with
        `leaves` the [T, n] int32 leaf indices, left on the device."""
        tables, depth = self._raw_forest(total)
        k = self.num_tree_per_iteration
        chunk = self._predict_chunk()
        parts = []
        for lo in range(0, X.shape[0], chunk):
            xt = upload(np.ascontiguousarray(X[lo:lo + chunk].T), self.device)
            leaf = raw_leaf_index(tables, xt, depth)
            parts.append(leaf.to(torch.int32) if leaves else
                         raw_forest_scores(tables["leaf_value"], leaf, k,
                                           early_stop_freq,
                                           early_stop_margin))
        if not parts:
            return torch.zeros((total if leaves else k, 0),
                               dtype=torch.int32 if leaves else torch.float64,
                               device=self.device)
        return torch.cat(parts, dim=1)

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1,
                    host: bool = False, early_stop_freq: int = 0,
                    early_stop_margin: float = 0.0) -> np.ndarray:
        """[k, n] raw scores.  The bin-space walk: bin the rows with the
        training mappers and walk the packed forest, both on the device,
        in row chunks.  The raw-value walk (`_raw_walk`) where the JAX
        package leaves its device path: `host` (tpu_predict_device=false),
        a model without the mapper trailer, or the prediction early stop
        (early_stop_freq > 0)."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        self._materialize()
        k = self.num_tree_per_iteration
        n = X.shape[0]
        out = np.zeros((k, n), np.float64)
        total, div = self._model_subset(num_iteration)
        if total == 0:
            return out
        if host or self._pred_ctx is None or early_stop_freq > 0:
            # random-forest averaging (gbdt_prediction.cpp:55)
            return self._raw_walk(X, total, early_stop_freq=early_stop_freq,
                                  early_stop_margin=early_stop_margin
                                  ).cpu().numpy() / div
        tables, depth = self._forest(total)
        meta = self._pred_ctx.meta_dev(self.device)
        self.predict_scratch_bytes = 0

        def walk(lo, hi):
            scratch = {"chunk_bytes": 0}
            bins_t = self._pred_ctx.bin_rows_t(X[lo:hi], self.device,
                                               scratch)
            scores = class_scores(tables, bins_t, meta, k, depth)
            # the chunk's tensors (utils/membudget.py:live_bytes): the
            # binning's, the planes a step of the walk makes, the scores
            self.predict_scratch_bytes = max(
                self.predict_scratch_bytes, scratch["chunk_bytes"]
                + forest_walk_bytes(tables["leaf_value"].shape[0], k,
                                    hi - lo, bins_t.element_size(),
                                    tables["cat_words"].shape[0] > 1)
                + int(scores.nbytes))
            return scores

        # random-forest averaging (gbdt_prediction.cpp:55)
        return self._chunked_scores(n, walk) / div

    def predict_binned(self, data: TrainingData, num_iteration: int = -1,
                       raw_score: bool = False) -> np.ndarray:
        """`predict` of a dataset binned with the training mappers
        (reference= the training set): its `[F, n]` bins are walked on
        their device with the packed forest in row chunks, with no
        binning pass (lightgbm_tpu/models/gbdt.py:predict_binned_device);
        the scores equal `predict` of the raw rows."""
        self._materialize()
        if self._pred_ctx is None:
            raise ValueError("device predict on binned data needs a booster "
                             "with a training context (file-loaded boosters "
                             "carry no bin mappers)")
        if data.bins_t is None:
            raise ValueError("dataset has no binned representation")
        # the same mapper list, not equal mappers: anything else would walk
        # another bin space
        if data.mappers is not self._pred_ctx.mappers:
            raise ValueError("predict data must be created with "
                             "reference=the training dataset")
        k = self.num_tree_per_iteration
        n = data.num_data
        raw = np.zeros((k, n), np.float64)
        total, div = self._model_subset(num_iteration)
        if total > 0:
            tables, depth = self._forest(total)
            meta = self._pred_ctx.meta_dev(self.device)

            def walk(lo, hi):
                bins_t = data.bins_t[:, lo:hi].to(self.device).contiguous()
                return class_scores(tables, bins_t, meta, k, depth)

            raw = self._chunked_scores(n, walk) / div
        return self._finish(raw, raw_score)

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                host: bool = False) -> np.ndarray:
        """[n] outputs, or [n, k] with several trees an iteration;
        pred_leaf: [n, T] int32 leaf indices; pred_contrib: [n, F+1] SHAP
        contributions (the expected value last), [n, k*(F+1)] for several
        classes (lightgbm_tpu/models/gbdt.py:1931-1975)."""
        if pred_leaf:
            return self.predict_leaf(X, num_iteration)
        if pred_contrib:
            return self.predict_contrib(X, num_iteration)
        return self._finish(self.predict_raw(
            X, num_iteration, host=host,
            early_stop_freq=(int(pred_early_stop_freq) if pred_early_stop
                             else 0),
            early_stop_margin=float(pred_early_stop_margin)), raw_score)

    def predict_leaf(self, X: np.ndarray, num_iteration: int = -1
                     ) -> np.ndarray:
        """[n, T] int32: each row's leaf in each of the first
        num_iteration iterations' trees (the raw-value walk)."""
        X = np.atleast_2d(np.asarray(X, np.float64))
        self._materialize()
        total, _ = self._model_subset(num_iteration)
        if total == 0:
            return np.zeros((X.shape[0], 0), np.int32)
        return self._raw_walk(X, total, leaves=True).T.cpu().numpy()

    def predict_contrib(self, X: np.ndarray, num_iteration: int = -1
                        ) -> np.ndarray:
        """SHAP contributions of the first num_iteration iterations'
        trees, batched over rows on the device (`shap.forest_contribs_t`):
        [n, F+1], or [n, k*(F+1)] for several trees an iteration."""
        from .shap import forest_contribs_t

        X = np.atleast_2d(np.asarray(X, np.float64))
        self._materialize()
        k = self.num_tree_per_iteration
        total, _ = self._model_subset(num_iteration)
        out = forest_contribs_t(self.models, X, total, k, self.device)
        if k == 1:
            return out[:, 0, :]
        return out.reshape(X.shape[0], -1)

    # ------------------------------------------------------------------
    def refit(self, X: np.ndarray, label: np.ndarray,
              decay_rate: float = 0.9, config: Optional[Config] = None,
              sums=leafsum.leaf_sums) -> None:
        """Refit every leaf value on new data, keeping the trees'
        structure (lightgbm_tpu/models/gbdt.py:1977-2056, the reference's
        GBDT::RefitTree): the rows' leaves from the raw-value walk; per
        iteration, gradients of a fresh objective on the new labels at
        the running refit scores; per tree, each leaf's f64 gradient and
        hessian sums in row order (`sums`: the f64 instance of the leaf
        sums), its regularized output, and the blend decay * old +
        (1 - decay) * new * shrinkage.  The scores are carried in f64; the
        profile trailer takes the refit scores."""
        self._materialize()
        cfg = config or self.config or Config({})
        X = np.atleast_2d(np.asarray(X, np.float64))
        n = X.shape[0]
        leaves = self._raw_walk(X, len(self.models), leaves=True)
        md = Metadata(num_data=n, label=np.asarray(label, np.float32))
        # a fresh objective on the new labels; a loaded booster's params
        # may carry the model text's objective spelling, which the config
        # factory refuses
        try:
            obj = create_objective(cfg)
        except ValueError:
            obj = None
        if obj is None:
            obj = create_objective_from_model_string(
                self.loaded_params.get("objective", "")
                or str(cfg.objective or ""))
        if obj is None:
            raise ValueError("cannot refit without an objective")
        obj.init(md, n, self.device)
        scores = self._refit_by_leaf_preds(leaves, obj, decay_rate, cfg,
                                           sums)
        self._recapture_profile_scores(scores,
                                       np.asarray(label, np.float64))

    def _refit_by_leaf_preds(self, leaves: torch.Tensor, obj,
                             decay_rate: float, cfg: Config, sums
                             ) -> np.ndarray:
        """The refit's core on the [T, n] int32 device leaf ids; returns
        the [k, n] f64 refit scores."""
        n = leaves.shape[1]
        k = self.num_tree_per_iteration
        l1 = float(cfg.lambda_l1)
        l2 = float(cfg.lambda_l2)
        mds = float(cfg.max_delta_step)
        decay = float(decay_rate)
        scores = torch.zeros((k, n), dtype=torch.float64, device=self.device)
        grad = hess = None
        for i, tree in enumerate(self.models):
            cid = i % k
            if cid == 0:
                g, h = obj.get_gradients(scores.to(torch.float32))
                grad, hess = g.reshape(k, n), h.reshape(k, n)
            nl = tree.num_leaves
            ids = leaves[i].contiguous()
            sum_g, sum_h = sums(ids, torch.stack([grad[cid], hess[cid]]), nl,
                                out_dtype=torch.float64).cpu().numpy()
            sum_h = sum_h + K_EPSILON
            # CalculateSplittedLeafOutput (feature_histogram.hpp:449-456)
            reg = np.maximum(np.abs(sum_g) - l1, 0.0) * np.sign(sum_g)
            new_out = -reg / (sum_h + l2)
            if mds > 0.0:
                new_out = np.clip(new_out, -mds, mds)
            old = tree.leaf_value[:nl]
            tree.leaf_value[:nl] = (decay * old
                                    + (1.0 - decay) * new_out * tree.shrinkage)
            lv = upload(np.ascontiguousarray(tree.leaf_value[:nl]),
                        self.device)
            scores[cid] = scores[cid] + lv[ids.long()]
        self._invalidate_tables()  # leaf values changed in place
        return scores.cpu().numpy()

    def _recapture_profile_scores(self, scores: np.ndarray,
                                  label: np.ndarray) -> None:
        """The profile trailer after a refit (gbdt.py:2058-2091): the
        trees' and features' part stays the training reference, the
        score histogram and the label statistics describe the refit
        scores and labels."""
        base = self.health_profile()
        if base is None:
            return
        s = np.asarray(scores, np.float64)
        if s.ndim == 1:
            s = s[None, :]
        fin = s[np.isfinite(s)]
        lo = float(fin.min()) if fin.size else 0.0
        hi = float(fin.max()) if fin.size else 1.0
        if hi <= lo:
            hi = lo + 1.0
        nb = max(len(base.score_edges) - 1, 2)
        edges = [float(x) for x in np.linspace(lo, hi, nb + 1)]
        counts = [[int(x) for x in
                   modelhealth.score_hist_counts(edges, row)]
                  for row in s]
        y = np.asarray(label, np.float64)
        lab = {"n": int(y.size),
               "mean": float(y.mean()) if y.size else 0.0,
               "std": float(y.std()) if y.size else 0.0,
               "min": float(y.min()) if y.size else 0.0,
               "max": float(y.max()) if y.size else 0.0}
        self._profile = modelhealth.FeatureProfile(
            {c: dict(f) for c, f in base.features.items()},
            lab, edges, counts)

    def merge_from_model_string(self, text: str) -> None:
        """init_model continuation (gbdt.py:2346-2378): the loaded model's
        trees go first, rebound to the training mappers (`_rebind_tree`,
        which also sets each categorical node's bitset index), and are
        replayed onto the train and validation scores (`_replay`)."""
        self._materialize()
        other = GBDT.from_model_string(text, self.device)
        if other.num_tree_per_iteration != self.num_tree_per_iteration:
            raise ValueError("init model has different "
                             "num_tree_per_iteration")
        for tree in other.models:
            if tree.num_leaves > 1:
                _rebind_tree(tree, self._pred_ctx)
        self.models = other.models + self.models
        self.num_init_iteration = other.current_iteration()
        self._invalidate_tables()
        for state, data in self._score_sets():
            self._replay(state, data, other.models)

    # ------------------------------------------------------------------
    # checkpoint/resume (utils/checkpoint.py): the driver's half
    # ------------------------------------------------------------------
    def topology_snapshot(self) -> Dict:
        """The `topology` block of the bundle, as the JAX package writes
        it (gbdt.py:1266-1285): "rows" is THIS process's row count (the
        global count where every process holds every row), beside the
        group's size, this process's index and the shard grid.  Host
        metadata only, no device transfer."""
        from ..parallel.topology import process_count, process_index

        if self.train_data is None or self.learner is None:
            raise ValueError("topology snapshot needs a live training "
                             "context")
        return {
            "rows": int(self.train_data.num_data),
            "host_count": int(process_count()),
            "host_index": int(process_index()),
            "partitioned": bool(getattr(self.learner, "_partitioned",
                                        False)),
            "data_shards": int(getattr(self.learner, "d_shards", 1)),
            "feature_shards": int(getattr(self.learner, "f_shards", 1)),
            "hosts": int(getattr(self.learner, "hosts", 1)),
            "tree_learner": str(self.config.tree_learner),
        }

    def capture_train_state(self) -> Tuple[Dict, Dict]:
        """The bundle's driver half (gbdt.py:1287-1324): a JSON-able
        state dict and the f32 score arrays.  The lazy trees are
        materialized first; the threefry keys are the same uint32 words
        as the JAX package's `_key_words`."""
        if self.train_data is None or self.learner is None \
                or self.train_scores is None:
            raise ValueError("checkpointing needs a live training context "
                             "(predict-only/file-loaded boosters have "
                             "nothing to resume)")
        self._materialize()
        frng = getattr(self.learner, "_feature_rng", None)
        state = {
            "iteration": int(self.current_iteration()),
            "num_init_iteration": int(self.num_init_iteration),
            "stopped": bool(self._stopped),
            "boosted_from_average": [
                bool(b) for b in self._boosted_from_average],
            "key": [int(w) for w in np.asarray(self._key, np.uint32)],
            "bag_key": [int(w) for w in np.asarray(self._bag_key,
                                                   np.uint32)],
            "bag_rng": self._bag_rng.bit_generator.state,
            "feature_rng": (frng.bit_generator.state
                            if frng is not None else None),
            "valid_names": list(self.valid_names),
            "guard_skips": int(self._guard_skips_total),
            "topology": self.topology_snapshot(),
        }
        arrays = {"train_scores": self.train_scores.scores.cpu().numpy()
                  .astype(np.float32)}
        for name, vs in zip(self.valid_names, self.valid_scores):
            arrays[f"valid_scores/{name}"] = vs.scores.cpu().numpy() \
                .astype(np.float32)
        if self._cached_bag_mask is not None:
            arrays["bag_mask"] = self._cached_bag_mask.cpu().numpy() \
                .astype(np.float32)
        extra = self._capture_extra_state()
        if extra:
            state["extra"] = extra
        return state, arrays

    def _capture_extra_state(self) -> Dict:
        return {}

    def _restore_extra_state(self, extra: Dict) -> None:
        pass

    def restore_train_state(self, model_text: str, state: Dict,
                            arrays: Dict) -> None:
        """Rebuild this freshly initialized driver to the checkpointed
        iteration (gbdt.py:1332-1417): the trees rebind to the live
        mappers (`_rebind_tree`), the f32 score buffers load byte for
        byte (no replay), and every key stream and generator resumes
        where it stood, so training goes on bit for bit."""
        if self.train_data is None or self.learner is None:
            raise ValueError("restore needs a booster constructed with "
                             "the training dataset")
        self._materialize()
        other = GBDT.from_model_string(model_text, self.device)
        if other.num_tree_per_iteration != self.num_tree_per_iteration:
            raise ValueError(
                "checkpoint has different num_tree_per_iteration")
        for tree in other.models:
            if tree.num_leaves > 1:
                _rebind_tree(tree, self._pred_ctx)
        self.models = list(other.models)
        self._pending = []
        k = max(self.num_tree_per_iteration, 1)
        total = len(self.models) // k
        if int(state.get("iteration", total)) != total:
            raise ValueError(
                f"checkpoint iteration {state.get('iteration')} does not "
                f"match its model ({total} iterations)")
        self.num_init_iteration = int(state.get("num_init_iteration", 0))
        self.iter_ = total - self.num_init_iteration
        ts = np.asarray(arrays["train_scores"], np.float32)
        want = (k, int(self.train_data.num_data))
        if tuple(ts.shape) != want:
            raise ValueError(
                f"checkpoint train-score buffer has shape {ts.shape} but "
                f"the live training context needs {want}; the checkpoint "
                "was taken over different data")
        self.train_scores.scores = torch.from_numpy(ts.copy()).to(
            self.device)
        for name, vs, vd in zip(self.valid_names, self.valid_scores,
                                self.valid_sets):
            a = arrays.get(f"valid_scores/{name}")
            if a is not None and tuple(a.shape) == tuple(vs.scores.shape):
                vs.scores = torch.from_numpy(
                    np.asarray(a, np.float32).copy()).to(self.device)
                continue
            # a valid set the checkpointed run did not have: the restored
            # model replayed onto its initial scores
            fresh = _ScoreState(k, vd.num_data, self.device,
                                vd.metadata.init_score)
            vs.scores = fresh.scores
            self._replay(vs, vd, self.models)
        self._key = np.asarray(state["key"], np.uint32).reshape(-1)
        self._bag_key = np.asarray(state["bag_key"], np.uint32).reshape(-1)
        if state.get("bag_rng") is not None:
            self._bag_rng = np.random.default_rng(0)
            self._bag_rng.bit_generator.state = state["bag_rng"]
        if state.get("feature_rng") is not None:
            rng = np.random.default_rng(0)
            rng.bit_generator.state = state["feature_rng"]
            self.learner._feature_rng = rng
        bfa = state.get("boosted_from_average")
        if bfa:
            self._boosted_from_average = [bool(b) for b in bfa]
        self._stopped = bool(state.get("stopped", False))
        self._guard_skips_total = int(state.get("guard_skips", 0))
        mask = arrays.get("bag_mask")
        self._cached_bag_mask = (
            None if mask is None
            else upload(np.asarray(mask, np.float32), self.device))
        self._invalidate_tables()
        self._restore_extra_state(state.get("extra") or {})

    def _finish(self, raw: np.ndarray, raw_score: bool) -> np.ndarray:
        """[k, n] raw scores -> the objective's outputs, [n] or [n, k]."""
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
                              "objective": kv.get("objective", ""),
                              "tpu_predict_device": _text_params(text).get(
                                  "tpu_predict_device", "auto")}
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
