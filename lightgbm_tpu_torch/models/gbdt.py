"""GBDT boosting driver (reference src/boosting/gbdt.cpp:368-449).

The port of the plain training subset of `lightgbm_tpu/models/gbdt.py`:
boost-from-average, one fused device step per iteration (gradients, tree
growth, train-score update), host `Tree` models built lazily from the
device step records (`_materialize`: one batched fetch for all pending
trees), model text with the `tpu_bin_mappers:` trailer, and device
predict in bin space.

Left out, and not silently: rollback, OOM ladders, fault injection,
telemetry, validation sets, DART/GOSS/RF and custom objectives.
"""

from __future__ import annotations

import io
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.bin_mapper import BinMapper
from ..io.dataset import TrainingData
from ..ops.binning import bin_matrix_t
from ..ops.predict import class_scores, device_tables, pack_trees
from .learner import TreeLearner
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
        return [torch.as_tensor(self.meta[k], device=device)
                for k in ("num_bin", "default_bin", "missing_type")]

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
    """Map a loaded tree's raw-value splits back into bin space: each
    saved threshold is a bin upper bound, so value_to_bin is exact."""
    used_pos = {col: j for j, col in enumerate(ctx.used_feature_idx)}
    for j in range(tree.num_leaves - 1):
        real_f = int(tree.split_feature[j])
        if int(tree.decision_type[j]) & 1:
            raise NotImplementedError(
                "categorical splits are not ported to lightgbm_tpu_torch yet")
        tree.split_feature_inner[j] = used_pos[real_f]
        tree.threshold_in_bin[j] = ctx.mappers[real_f].value_to_bin(
            float(tree.threshold[j]))


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
        self._tables = None
        # host waits of the grower, summed over trained trees
        self.grower_syncs = 0

    # ------------------------------------------------------------------
    def init(self, config: Config, train_data: TrainingData) -> None:
        self.config = config
        self.train_data = train_data
        self.device = train_data.device
        self.num_class = int(config.num_class)
        self.shrinkage_rate = float(config.learning_rate)
        self.objective = create_objective(config)
        if self.objective is None:
            raise NotImplementedError(
                "objective=none (custom objectives) is not ported to "
                "lightgbm_tpu_torch yet")
        self.objective.init(train_data.metadata, train_data.num_data,
                            self.device)
        self.num_tree_per_iteration = \
            self.objective.num_model_per_iteration()
        self.learner = TreeLearner(config, train_data)
        self.metrics = create_metrics(config, self.objective.name)
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
        self._step = self.learner.make_train_step(
            self.objective.get_gradients, self.shrinkage_rate)

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
            return init
        return 0.0

    def train_one_iter(self) -> bool:
        """One boosting iteration on the device; True once training has
        stalled (known only after `_materialize`, as in the JAX driver)."""
        if self._stopped:
            return True
        for k in range(self.num_tree_per_iteration):
            if not self.objective.class_need_train(k):
                raise NotImplementedError(
                    "training data with a single label class is not ported "
                    "to lightgbm_tpu_torch yet")
            init = self._boost_from_average(k)
            records, scores, _, _ = self._step(self.train_scores.scores, k)
            self.train_scores.scores = scores
            self.grower_syncs += self.learner.last_syncs
            self._pending.append((records, k, init))
        self.iter_ += 1
        return False

    def _materialize(self) -> None:
        """Fetch the pending device records (one batched copy) and build
        the host Tree models."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        recs = torch.stack([p[0] for p in pending]).cpu().numpy()
        for (_, class_id, init), rec in zip(pending, recs):
            if self._stopped:
                break
            tree = self.learner.build_tree_from_records(rec)
            if tree.num_leaves > 1:
                tree.apply_shrinkage(self.shrinkage_rate)
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

    def eval_train(self) -> List[Tuple[str, float, bool]]:
        """Metric values of the train scores (one device fetch)."""
        score = self.train_scores.numpy()
        return [(m.name, m.eval(score, self.objective), m.higher_is_better)
                for m in self.metrics]

    # ------------------------------------------------------------------
    def _forest(self, num_iteration: int):
        """(device tables, depth, tree count) for the first
        `num_iteration` iterations (-1 = all), cached per model count."""
        self._materialize()
        if self._preset is not None:
            tables, depth = self._preset
            total = tables["leaf_value"].shape[0]
        else:
            tables = depth = None
            total = len(self.models)
        k = max(self.num_tree_per_iteration, 1)
        if num_iteration is not None and num_iteration > 0:
            total = min(total, num_iteration * k)
        key = (total, id(self.models[-1]) if self.models else 0)
        if self._tables_key != key:
            if self._preset is None:
                tables, depth = pack_trees(self.models[:total])
            else:
                tables = {n: (v[:total] if n != "cat_words" else v)
                          for n, v in tables.items()}
            self._tables = (device_tables(tables, self.device), depth)
            self._tables_key = key
        return self._tables[0], self._tables[1], total

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
        k = self.num_tree_per_iteration
        n = X.shape[0]
        out = np.zeros((k, n), np.float64)
        tables, depth, total = self._forest(num_iteration)
        if total == 0:
            return out
        meta = self._pred_ctx.meta_dev(self.device)
        chunk = max(int(self.config.tpu_predict_chunk_rows)
                    if self.config is not None else 65536, 1024)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            bins_t = self._pred_ctx.bin_rows_t(X[lo:hi], self.device)
            scores = class_scores(tables, bins_t, meta, k, depth)
            out[:, lo:hi] = scores.cpu().numpy()
        return out

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration)
        if not raw_score and self.objective is not None:
            raw = self.objective.convert_output(raw)
        if raw.shape[0] == 1:
            return raw[0]
        return raw.T

    # ------------------------------------------------------------------
    def _split_counts(self) -> np.ndarray:
        """Splits per raw feature (the model text's feature_importances)."""
        counts = np.zeros(self.max_feature_idx + 1, np.int64)
        for tree in self.models:
            for j in range(tree.num_leaves - 1):
                counts[int(tree.split_feature[j])] += 1
        return counts

    def _feature_infos(self) -> List[str]:
        td = self.train_data
        if td is None:
            return list(self.loaded_params.get("feature_infos", []))
        used = set(td.used_feature_idx)
        return ["none" if i not in used or m.is_trivial
                else f"[{m.min_val!r}:{m.max_val!r}]"
                for i, m in enumerate(td.mappers)]

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
        imp = self._split_counts()
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
        return buf.getvalue()

    @classmethod
    def from_model_string(cls, text: str, device) -> "GBDT":
        self = cls()
        self.device = device
        pos = text.rfind("\npandas_categorical:")
        if pos >= 0:
            text = text[:pos]
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
                raise NotImplementedError(
                    "average_output (random forest models) is not ported to "
                    "lightgbm_tpu_torch yet")
            if "=" in line:
                key, v = line.split("=", 1)
                kv[key] = v
            i += 1
        self.num_class = int(kv.get("num_class", "1"))
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

