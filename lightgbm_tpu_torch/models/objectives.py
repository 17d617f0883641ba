"""Objectives: gradients and hessians on the device.

The port of `lightgbm_tpu/models/objectives.py`: the base class with its
`needs_renew` (a host percentile refit of the leaf outputs) and
`host_only` (gradients computed on the host) flags, `BinaryLogloss` and
`RegressionL2` (reference src/objective/binary_objective.hpp:20-213,
regression_objective.hpp:78-158), and the registry, which the rest of
the zoo (`objectives_ext.py`) joins.  Gradients are f32 torch ops on the
dataset's device; the host statistics (boost-from-average) stay numpy
f64 as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Metadata


class Objective:
    name = "none"
    num_class = 1

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        self.metadata = metadata
        self.num_data = num_data
        self.device = device
        self.label = torch.as_tensor(metadata.label, device=device)
        self.weights = (None if metadata.weight is None
                        else torch.as_tensor(metadata.weight, device=device))

    def num_model_per_iteration(self) -> int:
        return 1

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """score: [k, n] raw scores -> (grad, hess), [n] or [k, n]."""
        raise NotImplementedError

    #: whether renew_tree_output refits the leaves (GBDT then takes the
    #: sync step, which fetches the leaf ids and scores)
    needs_renew = False

    #: gradients computed on the host (per-query work, host generators):
    #: GBDT takes the sync step
    host_only = False

    def renew_tree_output(self, tree, score: np.ndarray,
                          leaf_ids: np.ndarray, row_mask: np.ndarray) -> None:
        """Post-hoc leaf refit (the L1/quantile/MAPE family)."""

    def class_need_train(self, class_id: int) -> bool:
        return True

    def to_model_string(self) -> str:
        return self.name


def _apply_weight(grad, hess, weights):
    if weights is None:
        return grad, hess
    return grad * weights, hess * weights


class BinaryLogloss(Objective):
    """reference src/objective/binary_objective.hpp:20-213.

    `is_pos_fn` customizes label binarization: the hook MulticlassOVA
    builds its per-class losses with (multiclass_objective.hpp:186)."""
    name = "binary"

    def __init__(self, config: Config, is_pos_fn=None):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            raise ValueError("sigmoid must be > 0")
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            raise ValueError("cannot set is_unbalance and scale_pos_weight "
                             "together")
        self._is_pos_fn = is_pos_fn

    def _is_pos(self, label: np.ndarray) -> np.ndarray:
        label = np.asarray(label)
        return label > 0 if self._is_pos_fn is None else self._is_pos_fn(label)

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        is_pos = self._is_pos(metadata.label)
        cnt_pos = int(is_pos.sum())
        cnt_neg = num_data - cnt_pos
        self.need_train = cnt_pos > 0 and cnt_neg > 0
        w_pos, w_neg = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        pos = torch.as_tensor(is_pos, device=device)
        self._sign = torch.where(pos, 1.0, -1.0).to(torch.float32)
        self._lw = torch.where(pos, w_pos, w_neg).to(torch.float32)

    def class_need_train(self, class_id: int) -> bool:
        return self.need_train

    def get_gradients(self, score):
        sig = self.sigmoid
        s = score[0]
        response = -self._sign * sig / (1.0 + torch.exp(self._sign * sig * s))
        ar = response.abs()
        g = response * self._lw
        h = ar * (sig - ar) * self._lw
        return _apply_weight(g, h, self.weights)

    def boost_from_score(self, class_id: int) -> float:
        is_pos = self._is_pos(self.metadata.label).astype(np.float64)
        w = self.metadata.weight
        if w is not None:
            suml = float((is_pos * w).sum())
            sumw = float(np.asarray(w, np.float64).sum())
        else:
            suml = float(is_pos.sum())
            sumw = float(self.num_data)
        pavg = min(max(suml / sumw, 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * raw))

    def to_model_string(self) -> str:
        return f"binary sigmoid:{self.sigmoid:g}"


class RegressionL2(Objective):
    """reference src/objective/regression_objective.hpp:78-158."""
    name = "regression"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            lbl = np.asarray(metadata.label, np.float64)
            self.trans_label = torch.as_tensor(
                (np.sign(lbl) * np.sqrt(np.abs(lbl))).astype(np.float32),
                device=device)
        else:
            self.trans_label = self.label

    def get_gradients(self, score):
        g = score[0] - self.trans_label
        h = torch.ones_like(g)
        return _apply_weight(g, h, self.weights)

    def boost_from_score(self, class_id: int) -> float:
        lbl = self.trans_label.cpu().numpy().astype(np.float64)
        w = self.metadata.weight
        if w is not None:
            return float((lbl * w).sum() / np.asarray(w, np.float64).sum())
        return float(lbl.mean())

    def convert_output(self, raw):
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw

    def to_model_string(self) -> str:
        return "regression"


_REGISTRY: Dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.name] = cls
    return cls


for _cls in (BinaryLogloss, RegressionL2):
    register(_cls)


def create_objective(config: Config) -> Optional[Objective]:
    """Objective factory (reference objective_function.cpp:16-53)."""
    name = config.objective
    if name in ("none", ""):
        return None
    # a late import, so that the rest of the zoo registers itself
    from . import objectives_ext  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(f"unknown objective {name!r}")
    return _REGISTRY[name](config)


def create_objective_from_model_string(spec: str) -> Optional[Objective]:
    """Rebuild an objective from the model-file 'objective=...' line."""
    toks = spec.split()
    if not toks:
        return None
    params = {}
    for t in toks[1:]:
        if ":" in t:
            k, v = t.split(":", 1)
            params[k] = v
    cfg = Config({"objective": toks[0], **params})
    from . import objectives_ext  # noqa: F401
    cls = _REGISTRY.get(cfg.objective)
    return None if cls is None else cls(cfg)
