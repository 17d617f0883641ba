"""Evaluation metrics (reference src/metric/*.hpp).

A copy of `lightgbm_tpu/models/metrics.py`: metrics evaluate on host
numpy arrays and report (name, value, higher_is_better); `metrics_ext.py`
registers the rest of the zoo.  Distribution-aware as there (reference
Network::GlobalSyncUp*, include/LightGBM/network.h:168-275): in a
`torch.distributed` group every metric reduces its sufficient statistics
across ranks through `parallel/metric_sync.py`, so all ranks report the
global value and early stopping fires at the same iteration everywhere.
In one process the reductions are identities.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..io.dataset import Metadata


class Metric:
    name = "none"
    higher_is_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.metadata = metadata
        self.num_data = num_data
        self.label = np.asarray(metadata.label, np.float64)
        self.weight = (None if metadata.weight is None
                       else np.asarray(metadata.weight, np.float64))
        self.sum_weights = (float(self.weight.sum()) if self.weight is not None
                            else float(num_data))

    def eval(self, score: np.ndarray, objective) -> float:
        """score: [k, n] raw scores."""
        raise NotImplementedError

    def eval_all(self, score: np.ndarray, objective) -> List[Tuple[str, float]]:
        """Multi-value interface (e.g. ndcg@1..5 report one value per k,
        reference NDCGMetric::Eval rank_metric.hpp:93).  Default: one value."""
        return [(self.name, self.eval(score, objective))]


def _avg(loss: np.ndarray, weight: Optional[np.ndarray], sum_w: float) -> float:
    """Weighted average with the (numerator, denominator) pair summed
    across processes — both stay LOCAL sums until here, so the division
    happens on the global statistics on every rank."""
    from ..parallel.metric_sync import sync_sums

    num = float(loss.sum()) if weight is None else float((loss * weight).sum())
    g_num, g_den = sync_sums([num, float(sum_w)])
    return float(g_num / g_den)


class L2Metric(Metric):
    name = "l2"

    def eval(self, score, objective):
        pred = score[0]
        if objective is not None:
            pred = objective.convert_output(pred)
        return _avg((self.label - pred) ** 2, self.weight, self.sum_weights)


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval(self, score, objective):
        return float(np.sqrt(super().eval(score, objective)))


class L1Metric(Metric):
    name = "l1"

    def eval(self, score, objective):
        pred = score[0]
        if objective is not None:
            pred = objective.convert_output(pred)
        return _avg(np.abs(self.label - pred), self.weight, self.sum_weights)


class BinaryLoglossMetric(Metric):
    """reference src/metric/binary_metric.hpp (BinaryLoglossMetric)."""
    name = "binary_logloss"

    def eval(self, score, objective):
        prob = objective.convert_output(score[0]) if objective is not None \
            else 1.0 / (1.0 + np.exp(-score[0]))
        prob = np.clip(prob, 1e-15, 1 - 1e-15)
        is_pos = self.label > 0
        loss = np.where(is_pos, -np.log(prob), -np.log(1.0 - prob))
        return _avg(loss, self.weight, self.sum_weights)


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, score, objective):
        prob = objective.convert_output(score[0]) if objective is not None \
            else 1.0 / (1.0 + np.exp(-score[0]))
        is_pos = self.label > 0
        err = np.where(is_pos, prob <= 0.5, prob > 0.5).astype(np.float64)
        return _avg(err, self.weight, self.sum_weights)


class AUCMetric(Metric):
    """reference src/metric/binary_metric.hpp AUCMetric (weighted rank sum)."""
    name = "auc"
    higher_is_better = True

    def eval(self, score, objective):
        from ..parallel.metric_sync import process_count, sync_concat

        s = score[0]
        label = self.label
        weight = self.weight
        if process_count() > 1:
            # AUC is a pairwise rank statistic with no per-rank sufficient
            # sum: merge the raw (score, label, weight) columns exactly
            # across ranks, then rank globally
            s, label, weight = sync_concat(
                s, label,
                weight if weight is not None else np.ones_like(s))
        order = np.argsort(s, kind="stable")
        sorted_score = s[order]
        sorted_pos = (label[order] > 0).astype(np.float64)
        w = (weight[order] if weight is not None
             else np.ones_like(sorted_pos))
        pos_w = sorted_pos * w
        neg_w = (1.0 - sorted_pos) * w
        # group ties: same score -> same average rank contribution
        boundaries = np.flatnonzero(np.diff(sorted_score)) + 1
        group_id = np.zeros(len(s), dtype=np.int64)
        group_id[boundaries] = 1
        group_id = np.cumsum(group_id)
        num_groups = group_id[-1] + 1 if len(s) else 0
        pos_per_group = np.bincount(group_id, weights=pos_w, minlength=num_groups)
        neg_per_group = np.bincount(group_id, weights=neg_w, minlength=num_groups)
        neg_below = np.concatenate([[0.0], np.cumsum(neg_per_group)[:-1]])
        auc_sum = (pos_per_group * (neg_below + 0.5 * neg_per_group)).sum()
        total_pos = pos_w.sum()
        total_neg = neg_w.sum()
        if total_pos == 0 or total_neg == 0:
            return 1.0
        return float(auc_sum / (total_pos * total_neg))


_METRICS: Dict[str, type] = {}
for _cls in (L2Metric, RMSEMetric, L1Metric, BinaryLoglossMetric,
             BinaryErrorMetric, AUCMetric):
    _METRICS[_cls.name] = _cls

_METRIC_ALIASES = {
    "mse": "l2", "mean_squared_error": "l2", "regression": "l2",
    "regression_l2": "l2", "l2_root": "rmse", "root_mean_squared_error": "rmse",
    "mae": "l1", "mean_absolute_error": "l1", "regression_l1": "l1",
    "binary": "binary_logloss",
}

DEFAULT_METRIC_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "quantile": "quantile", "mape": "mape",
    "gamma": "gamma", "tweedie": "tweedie", "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy", "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    from . import metrics_ext  # noqa: F401  (registers the extended zoo)
    name = _METRIC_ALIASES.get(name, name)
    cls = _METRICS.get(name)
    return None if cls is None else cls(config)


def create_metrics(config: Config, objective_name: str) -> List[Metric]:
    names = list(config.metric)
    if not names:
        default = DEFAULT_METRIC_FOR_OBJECTIVE.get(objective_name)
        names = [default] if default else []
    out = []
    seen = set()
    for n in names:
        n = n.strip().lower()
        if n in ("", "none", "null", "na", "custom"):
            continue
        n = _METRIC_ALIASES.get(n, n)
        if n in seen:
            continue
        seen.add(n)
        m = create_metric(n, config)
        if m is None:
            raise ValueError(f"unknown metric {n!r}")
        out.append(m)
    return out


def register_metric(cls):
    _METRICS[cls.name] = cls
    return cls
