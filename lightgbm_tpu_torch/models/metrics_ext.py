"""The extended metric zoo: the regression family, multiclass,
cross-entropy and ranking metrics (reference src/metric/*.hpp).

A copy of `lightgbm_tpu/models/metrics_ext.py`: every metric evaluates on
host numpy, and reduces across processes where the JAX package does
(`parallel/metric_sync.py`; sums only where each rank holds distinct
rows, `topology.rows_partitioned()`).  Formulas cite the reference per
class.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from .metrics import Metric, register_metric, _avg, _METRIC_ALIASES

K_EPSILON = 1e-15


def _convert(score0: np.ndarray, objective) -> np.ndarray:
    """Per-point ConvertOutput for single-score metrics
    (reference regression_metric.hpp:77-90)."""
    if objective is not None:
        return np.asarray(objective.convert_output(score0))
    return score0


# ---------------------------------------------------------------------------
# Regression family (reference src/metric/regression_metric.hpp)
# ---------------------------------------------------------------------------

@register_metric
class QuantileMetric(Metric):
    """reference regression_metric.hpp:152-170."""
    name = "quantile"

    def eval(self, score, objective):
        pred = _convert(score[0], objective)
        delta = self.label - pred
        alpha = float(self.config.alpha)
        loss = np.where(delta < 0, (alpha - 1.0) * delta, alpha * delta)
        return _avg(loss, self.weight, self.sum_weights)


@register_metric
class HuberMetric(Metric):
    """reference regression_metric.hpp:186-204."""
    name = "huber"

    def eval(self, score, objective):
        pred = _convert(score[0], objective)
        diff = pred - self.label
        a = float(self.config.alpha)
        loss = np.where(np.abs(diff) <= a, 0.5 * diff * diff,
                        a * (np.abs(diff) - 0.5 * a))
        return _avg(loss, self.weight, self.sum_weights)


@register_metric
class FairMetric(Metric):
    """reference regression_metric.hpp:207-222."""
    name = "fair"

    def eval(self, score, objective):
        pred = _convert(score[0], objective)
        x = np.abs(pred - self.label)
        c = float(self.config.fair_c)
        loss = c * x - c * c * np.log1p(x / c)
        return _avg(loss, self.weight, self.sum_weights)


@register_metric
class PoissonMetric(Metric):
    """reference regression_metric.hpp:224-239 (score here is exp(f))."""
    name = "poisson"

    def eval(self, score, objective):
        pred = np.maximum(_convert(score[0], objective), 1e-10)
        loss = pred - self.label * np.log(pred)
        return _avg(loss, self.weight, self.sum_weights)


@register_metric
class MAPEMetric(Metric):
    """reference regression_metric.hpp:243-254."""
    name = "mape"

    def eval(self, score, objective):
        pred = _convert(score[0], objective)
        loss = np.abs(self.label - pred) / np.maximum(1.0, np.abs(self.label))
        return _avg(loss, self.weight, self.sum_weights)


def _safe_log(x):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(x > 0, np.log(np.maximum(x, 1e-300)), -np.inf)


@register_metric
class GammaMetric(Metric):
    """reference regression_metric.hpp:256-276 (negative gamma log-lik,
    psi=1 so the lgamma term vanishes)."""
    name = "gamma"

    def eval(self, score, objective):
        pred = _convert(score[0], objective)
        theta = -1.0 / pred
        b = -_safe_log(-theta)
        # c = log(label) - log(label) = 0 at psi=1 (reference keeps the
        # cancelled form; replicated as zero)
        loss = -(self.label * theta - b)
        return _avg(loss, self.weight, self.sum_weights)


@register_metric
class GammaDevianceMetric(Metric):
    """reference regression_metric.hpp:279-297 (2x summed deviance; its
    AverageLoss ignores sum_weights and returns sum_loss * 2)."""
    name = "gamma_deviance"

    def eval(self, score, objective):
        pred = _convert(score[0], objective)
        tmp = self.label / (pred + 1e-9)
        loss = tmp - _safe_log(tmp) - 1.0
        if self.weight is not None:
            loss = loss * self.weight
        total = float(loss.sum())
        # a global SUM (no denominator): unlike averaged losses, a sum is
        # NOT replication-safe — adding the local sums of P replicated
        # ranks reports P x the true value.  Reduce across ranks only
        # when each rank actually holds a distinct row shard — DERIVED
        # from the live topology's row placement, not the pre_partition
        # config flag (a flag echo desynchronizes from reality the
        # moment a new axis changes what the flag implies).
        from ..parallel.topology import rows_partitioned

        if rows_partitioned():
            from ..parallel.metric_sync import sync_sums

            total = float(sync_sums([total])[0])
        return total * 2.0


@register_metric
class TweedieMetric(Metric):
    """reference regression_metric.hpp:300-318."""
    name = "tweedie"

    def eval(self, score, objective):
        rho = float(self.config.tweedie_variance_power)
        pred = np.maximum(_convert(score[0], objective), 1e-10)
        a = self.label * np.exp((1.0 - rho) * np.log(pred)) / (1.0 - rho)
        b = np.exp((2.0 - rho) * np.log(pred)) / (2.0 - rho)
        return _avg(-a + b, self.weight, self.sum_weights)


# ---------------------------------------------------------------------------
# Multiclass (reference src/metric/multiclass_metric.hpp)
# ---------------------------------------------------------------------------

class _MulticlassMetric(Metric):
    def _probs(self, score, objective) -> np.ndarray:
        """[k, n] per-class outputs (softmax/sigmoid when objective known)."""
        if objective is not None:
            return np.asarray(objective.convert_output(score))
        return score


@register_metric
class MultiLoglossMetric(_MulticlassMetric):
    """reference multiclass_metric.hpp MultiSoftmaxLoglossMetric."""
    name = "multi_logloss"

    def eval(self, score, objective):
        p = self._probs(score, objective)
        lbl = self.label.astype(np.int64)
        p_true = p[lbl, np.arange(p.shape[1])]
        loss = np.where(p_true > K_EPSILON,
                        -np.log(np.maximum(p_true, K_EPSILON)),
                        -np.log(K_EPSILON))
        return _avg(loss, self.weight, self.sum_weights)


@register_metric
class MultiErrorMetric(_MulticlassMetric):
    """reference multiclass_metric.hpp MultiErrorMetric: top-k error — a row
    is wrong iff more than top_k classes score >= the true class's score."""
    name = "multi_error"

    def eval(self, score, objective):
        p = self._probs(score, objective)
        lbl = self.label.astype(np.int64)
        top_k = int(self.config.multi_error_top_k)
        p_true = p[lbl, np.arange(p.shape[1])]
        num_larger = (p >= p_true[None, :]).sum(axis=0)
        err = (num_larger > top_k).astype(np.float64)
        return _avg(err, self.weight, self.sum_weights)

    def eval_all(self, score, objective):
        top_k = int(self.config.multi_error_top_k)
        nm = "multi_error" if top_k == 1 else f"multi_error@{top_k}"
        return [(nm, self.eval(score, objective))]


@register_metric
class AucMuMetric(Metric):
    """reference multiclass_metric.hpp AucMuMetric (auc-mu,
    proceedings.mlr.press/v97/kleiman19a): mean over class pairs (i, j) of
    the tie-averaged AUC of the partition-weighted score projection."""
    name = "auc_mu"
    higher_is_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        nc = int(self.config.num_class)
        w = list(self.config.get("auc_mu_weights", []) or [])
        if w:
            if len(w) != nc * nc:
                raise ValueError("auc_mu_weights must have num_class^2 entries")
            self.class_weights = np.asarray(w, np.float64).reshape(nc, nc)
        else:
            self.class_weights = 1.0 - np.eye(nc)
        self.num_class = nc

    def eval(self, score, objective):
        from ..parallel.metric_sync import process_count, sync_concat

        nc = self.num_class
        lbl = self.label
        if process_count() > 1:
            # pairwise rank statistic across class partitions — like AUC,
            # merge the raw per-rank columns exactly before ranking
            merged = sync_concat(lbl, *[score[k] for k in range(nc)])
            lbl = merged[0]
            score = np.stack(merged[1:])
        lbl = lbl.astype(np.int64)
        sizes = np.bincount(lbl, minlength=nc)
        ans = 0.0
        for i in range(nc):
            for j in range(i + 1, nc):
                if sizes[i] == 0 or sizes[j] == 0:
                    continue
                curr_v = self.class_weights[i] - self.class_weights[j]
                t1 = curr_v[i] - curr_v[j]
                v = t1 * (curr_v @ score)
                vi = v[lbl == i]
                vj_sorted = np.sort(v[lbl == j])
                less = np.searchsorted(vj_sorted, vi, side="left")
                leq = np.searchsorted(vj_sorted, vi, side="right")
                s_ij = float((less + 0.5 * (leq - less)).sum())
                ans += s_ij / (sizes[i] * sizes[j])
        return float(2.0 * ans / (nc * (nc - 1)))


# ---------------------------------------------------------------------------
# Cross-entropy family (reference src/metric/xentropy_metric.hpp)
# ---------------------------------------------------------------------------

def _xent_loss(label, prob):
    eps = 1e-12
    p = np.clip(prob, eps, 1.0 - eps)
    return -label * np.log(p) - (1.0 - label) * np.log(1.0 - p)


@register_metric
class CrossEntropyMetric(Metric):
    """reference xentropy_metric.hpp:71-163."""
    name = "cross_entropy"

    def eval(self, score, objective):
        if objective is not None and objective.name != "cross_entropy_lambda":
            p = np.asarray(objective.convert_output(score[0]))
        else:
            # xentlambda's ConvertOutput yields lambda, not a probability;
            # the metric needs the plain sigmoid (ref :120-126)
            p = 1.0 / (1.0 + np.exp(-score[0]))
        return _avg(_xent_loss(self.label, p), self.weight, self.sum_weights)


@register_metric
class CrossEntropyLambdaMetric(Metric):
    """reference xentropy_metric.hpp:166-240: loss on p = 1-exp(-w*hhat),
    hhat = log(1+exp(f)); averaged over rows (not weights)."""
    name = "cross_entropy_lambda"

    def eval(self, score, objective):
        hhat = np.log1p(np.exp(score[0]))
        w = self.weight if self.weight is not None else 1.0
        p = 1.0 - np.exp(-w * hhat)
        loss = _xent_loss(self.label, p)
        return _avg(loss, None, float(self.num_data))


@register_metric
class KLDivergenceMetric(Metric):
    """reference xentropy_metric.hpp:249-343: xentropy minus the constant
    label-entropy offset."""
    name = "kldiv"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        y = np.clip(self.label, 0.0, 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            ent = np.where((y > 0) & (y < 1),
                           -y * np.log(y) - (1 - y) * np.log(1 - y), 0.0)
        if self.weight is not None:
            ent = ent * self.weight
        # keep the LOCAL sum; the global average forms at eval time (init
        # can run before the process group is the final word on rank
        # membership, eval never does)
        self._local_entropy_sum = float(ent.sum())

    def eval(self, score, objective):
        from ..parallel.metric_sync import sync_sums

        if objective is not None:
            p = np.asarray(objective.convert_output(score[0]))
        else:
            p = score[0]
        xent = _avg(_xent_loss(self.label, p), self.weight, self.sum_weights)
        g_ent, g_w = sync_sums([self._local_entropy_sum, self.sum_weights])
        return xent - float(g_ent / g_w)


# ---------------------------------------------------------------------------
# Ranking metrics (reference rank_metric.hpp / map_metric.hpp)
# ---------------------------------------------------------------------------

def _sync_rank_sums(results: np.ndarray, sum_qw: float):
    """Queries live whole on one rank, so rank metrics reduce as plain
    (per-position weighted sums, query-weight sum) across processes."""
    from ..parallel.metric_sync import sync_sums

    g = sync_sums(np.concatenate([results, [sum_qw]]))
    return g[:-1], float(g[-1])


class _RankMetric(Metric):
    higher_is_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise ValueError(f"The {self.name} metric requires query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(self.query_boundaries) - 1
        self.query_weights = metadata.query_weights()
        self.sum_query_weights = (float(self.query_weights.sum())
                                  if self.query_weights is not None
                                  else float(self.num_queries))
        self.eval_at = [int(k) for k in (self.config.eval_at or [1, 2, 3, 4, 5])]


@register_metric
class NDCGMetric(_RankMetric):
    """reference rank_metric.hpp:20-175 + dcg_calculator.cpp."""
    name = "ndcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        from .objectives_ext import default_label_gain
        gains = list(self.config.label_gain) or default_label_gain()
        self.label_gain = np.asarray(gains, np.float64)
        lbl = self.label
        if lbl.min() < 0 or int(lbl.max()) >= len(self.label_gain):
            raise ValueError("label out of range for ndcg label_gain")
        # cache per-query inverse max DCG at each eval position
        # (reference rank_metric.hpp:63-80)
        self.inv_max_dcgs = np.zeros((self.num_queries, len(self.eval_at)))
        for q in range(self.num_queries):
            a, b = self.query_boundaries[q], self.query_boundaries[q + 1]
            top = np.sort(lbl[a:b])[::-1].astype(np.int64)
            disc = 1.0 / np.log2(2.0 + np.arange(len(top)))
            cum = np.cumsum(self.label_gain[top] * disc)
            for ki, k in enumerate(self.eval_at):
                kk = min(k, len(top))
                m = cum[kk - 1] if kk > 0 else 0.0
                self.inv_max_dcgs[q, ki] = 1.0 / m if m > 0 else -1.0

    def eval_all(self, score, objective):
        s = score[0]
        lbl = self.label.astype(np.int64)
        results = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            a, b = int(self.query_boundaries[q]), int(self.query_boundaries[q + 1])
            qw = (self.query_weights[q] if self.query_weights is not None
                  else 1.0)
            if self.inv_max_dcgs[q, 0] <= 0:
                results += qw  # all-negative query counts as NDCG=1 (ref :104)
                continue
            order = np.argsort(-s[a:b], kind="stable")
            g = self.label_gain[lbl[a:b][order]]
            disc = 1.0 / np.log2(2.0 + np.arange(len(g)))
            cum = np.cumsum(g * disc)
            for ki, k in enumerate(self.eval_at):
                kk = min(k, len(g))
                results[ki] += cum[kk - 1] * self.inv_max_dcgs[q, ki] * qw
        results, sum_qw = _sync_rank_sums(results, self.sum_query_weights)
        results /= sum_qw
        return [(f"ndcg@{k}", float(v)) for k, v in zip(self.eval_at, results)]

    def eval(self, score, objective):
        return self.eval_all(score, objective)[0][1]


@register_metric
class MapMetric(_RankMetric):
    """reference map_metric.hpp:20-180 (mean average precision @ k)."""
    name = "map"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.npos_per_query = np.zeros(self.num_queries, np.int64)
        for q in range(self.num_queries):
            a, b = self.query_boundaries[q], self.query_boundaries[q + 1]
            self.npos_per_query[q] = int((self.label[a:b] > 0.5).sum())

    def eval_all(self, score, objective):
        s = score[0]
        results = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            a, b = int(self.query_boundaries[q]), int(self.query_boundaries[q + 1])
            qw = (self.query_weights[q] if self.query_weights is not None
                  else 1.0)
            npos = int(self.npos_per_query[q])
            order = np.argsort(-s[a:b], kind="stable")
            hits = (self.label[a:b][order] > 0.5)
            cum_hits = np.cumsum(hits)
            ap_terms = np.where(hits, cum_hits / (np.arange(len(hits)) + 1.0), 0.0)
            cum_ap = np.cumsum(ap_terms)
            for ki, k in enumerate(self.eval_at):
                kk = min(k, len(hits))
                if npos > 0:
                    results[ki] += (cum_ap[kk - 1] / min(npos, kk)) * qw
                else:
                    results[ki] += 1.0 * qw
        results, sum_qw = _sync_rank_sums(results, self.sum_query_weights)
        results /= sum_qw
        return [(f"map@{k}", float(v)) for k, v in zip(self.eval_at, results)]

    def eval(self, score, objective):
        return self.eval_all(score, objective)[0][1]


_METRIC_ALIASES.update({
    "mean_average_precision": "map",
    "xentropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv",
    "multiclass": "multi_logloss",
    "softmax": "multi_logloss",
    "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss",
    "ova": "multi_logloss",
    "ovr": "multi_logloss",
    "lambdarank": "ndcg",
    "rank_xendcg": "ndcg",
    "xendcg": "ndcg",
    "mean_absolute_percentage_error": "mape",
})
