"""The extended objective zoo: the regression family, multiclass,
cross-entropy and learning to rank.

The port of `lightgbm_tpu/models/objectives_ext.py` (formulas cite the
reference per class).  Gradients that the JAX package computes with
`jnp` are torch ops on the scores' device, in the same f32 order.  The
percentile refits of the L1/quantile/MAPE family (`renew_tree_output`,
which the sync step of `gbdt.py` runs) and the per-query ranking lambdas
(`host_only`) are host numpy, copied.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Metadata
from .objectives import (BinaryLogloss, Objective, RegressionL2,
                         _apply_weight, register)

K_EPSILON = 1e-15


def _sum_classes(p: torch.Tensor) -> torch.Tensor:
    """[k, n] -> [1, n]: the classes added in order, as XLA's reduce over
    the class axis adds them."""
    acc = p[0]
    for c in range(1, p.shape[0]):
        acc = acc + p[c]
    return acc[None]


def _host_scores(score) -> np.ndarray:
    """The scores as host f64 (the ranking objectives' input)."""
    if isinstance(score, torch.Tensor):
        score = score.detach().cpu().numpy()
    return np.asarray(score, np.float64)


# ---------------------------------------------------------------------------
# Percentile helpers with reference semantics
# (reference src/objective/regression_objective.hpp:18-73
#  PercentileFun / WeightedPercentileFun)
# ---------------------------------------------------------------------------

def percentile(values: np.ndarray, alpha: float) -> float:
    """Unweighted percentile, reference PercentileFun semantics."""
    cnt = len(values)
    if cnt == 0:
        return 0.0
    if cnt <= 1:
        return float(values[0])
    float_pos = (1.0 - alpha) * cnt
    pos = int(float_pos)
    if pos < 1:
        return float(values.max())
    if pos >= cnt:
        return float(values.min())
    bias = float_pos - pos
    # descending order: v1 = pos-th largest, v2 = (pos+1)-th largest
    d = np.sort(values)[::-1]
    v1, v2 = float(d[pos - 1]), float(d[pos])
    return v1 - (v1 - v2) * bias


def weighted_percentile(values: np.ndarray, weights: np.ndarray,
                        alpha: float) -> float:
    """Weighted percentile, reference WeightedPercentileFun semantics
    (including its interpolation quirk when the next CDF step is >= 1)."""
    cnt = len(values)
    if cnt == 0:
        return 0.0
    if cnt <= 1:
        return float(values[0])
    order = np.argsort(values, kind="stable")
    cdf = np.cumsum(weights[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, cnt - 1)
    if pos == 0 or pos == cnt - 1:
        return float(values[order[pos]])
    v1 = float(values[order[pos - 1]])
    v2 = float(values[order[pos]])
    if cdf[pos + 1] - cdf[pos] >= 1.0:
        return (threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos]) * (v2 - v1) + v1
    return v2


class _RenewMixin:
    """Leaf-output percentile refit shared by L1/quantile/MAPE
    (reference RenewTreeOutput overrides, regression_objective.hpp:235,523,624)."""

    needs_renew = True
    renew_alpha = 0.5

    def _renew_weights(self) -> Optional[np.ndarray]:
        w = self.metadata.weight
        return None if w is None else np.asarray(w, np.float64)

    def renew_tree_output(self, tree, score: np.ndarray,
                          leaf_ids: np.ndarray, row_mask: np.ndarray) -> None:
        label = np.asarray(self.metadata.label, np.float64)
        residual = label - score[:len(label)]
        w = self._renew_weights()
        alpha = self.renew_alpha
        for leaf in range(tree.num_leaves):
            rows = np.flatnonzero((leaf_ids == leaf) & row_mask)
            if rows.size == 0:
                continue
            if w is None:
                val = percentile(residual[rows], alpha)
            else:
                val = weighted_percentile(residual[rows], w[rows], alpha)
            tree.set_leaf_value(leaf, val)


@register
class RegressionL1(_RenewMixin, RegressionL2):
    """reference regression_objective.hpp:189-270."""
    name = "regression_l1"

    def get_gradients(self, score):
        g = torch.sign(score[0] - self.label)
        h = torch.ones_like(g)
        return _apply_weight(g, h, self.weights)

    def boost_from_score(self, class_id: int) -> float:
        label = np.asarray(self.metadata.label, np.float64)
        w = self._renew_weights()
        if w is None:
            return percentile(label, 0.5)
        return weighted_percentile(label, w, 0.5)

    def to_model_string(self) -> str:
        return self.name


@register
class Huber(RegressionL2):
    """reference regression_objective.hpp:275-333."""
    name = "huber"

    def __init__(self, config: Config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        self.sqrt = False  # sqrt transform unsupported for huber (ref :279)

    def get_gradients(self, score):
        diff = score[0] - self.label
        g = torch.where(torch.abs(diff) <= self.alpha, diff,
                      torch.sign(diff) * self.alpha)
        h = torch.ones_like(g)
        return _apply_weight(g, h, self.weights)

    def to_model_string(self) -> str:
        return self.name


@register
class Fair(RegressionL2):
    """reference regression_objective.hpp:337-378."""
    name = "fair"

    def __init__(self, config: Config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        x = score[0] - self.label
        ax = torch.abs(x)
        c = self.c
        g = c * x / (ax + c)
        h = c * c / ((ax + c) * (ax + c))
        return _apply_weight(g, h, self.weights)

    def to_model_string(self) -> str:
        return self.name


@register
class Poisson(RegressionL2):
    """reference regression_objective.hpp:384-462.  Internal score f is the
    log-rate: grad = exp(f) - y, hess = exp(f + poisson_max_delta_step)."""
    name = "poisson"

    def __init__(self, config: Config):
        super().__init__(config)
        self.max_delta = float(config.poisson_max_delta_step)
        self.sqrt = False

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label, np.float64)
        if lbl.min() < 0:
            raise ValueError(f"[{self.name}]: at least one target label is negative")
        if lbl.sum() == 0:
            raise ValueError(f"[{self.name}]: sum of labels is zero")

    def get_gradients(self, score):
        ef = torch.exp(score[0])
        g = ef - self.label
        h = torch.exp(score[0] + self.max_delta)
        return _apply_weight(g, h, self.weights)

    def boost_from_score(self, class_id: int) -> float:
        mean = RegressionL2.boost_from_score(self, class_id)
        return float(np.log(mean)) if mean > 0 else float(np.log(1e-6))

    def convert_output(self, raw):
        return np.exp(raw)

    def to_model_string(self) -> str:
        return self.name


@register
class Quantile(_RenewMixin, RegressionL2):
    """reference regression_objective.hpp:464-556."""
    name = "quantile"

    def __init__(self, config: Config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if not (0.0 < self.alpha < 1.0):
            raise ValueError("alpha must be in (0, 1) for quantile")
        self.renew_alpha = self.alpha

    def get_gradients(self, score):
        delta = score[0] - self.label
        g = torch.where(delta >= 0, 1.0 - self.alpha, -self.alpha)
        h = torch.ones_like(g)
        return _apply_weight(g, h, self.weights)

    def boost_from_score(self, class_id: int) -> float:
        label = np.asarray(self.metadata.label, np.float64)
        w = self._renew_weights()
        if w is None:
            return percentile(label, self.alpha)
        return weighted_percentile(label, w, self.alpha)

    def to_model_string(self) -> str:
        return f"{self.name} alpha:{self.alpha:g}"


@register
class MAPE(_RenewMixin, RegressionL2):
    """reference regression_objective.hpp:562-654.  Uses label weights
    1/max(1,|y|) for both gradients and the percentile refits."""
    name = "mape"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label, np.float64)
        lw = 1.0 / np.maximum(1.0, np.abs(lbl))
        if metadata.weight is not None:
            lw = lw * np.asarray(metadata.weight, np.float64)
        self.label_weight = lw
        self._label_weight_dev = torch.as_tensor(lw.astype(np.float32),
                                                 device=device)

    def get_gradients(self, score):
        diff = score[0] - self.label
        g = torch.sign(diff) * self._label_weight_dev
        if self.weights is None:
            h = torch.ones_like(g)
        else:
            h = self.weights
        return g, h  # label weight already folded into g (ref :600-608)

    def _renew_weights(self) -> Optional[np.ndarray]:
        return self.label_weight  # MAPE always refits weighted (ref :628-641)

    def boost_from_score(self, class_id: int) -> float:
        label = np.asarray(self.metadata.label, np.float64)
        return weighted_percentile(label, self.label_weight, 0.5)

    def to_model_string(self) -> str:
        return self.name


@register
class Gamma(Poisson):
    """reference regression_objective.hpp:661-691."""
    name = "gamma"

    def get_gradients(self, score):
        enf = torch.exp(-score[0])
        if self.weights is None:
            g = 1.0 - self.label * enf
            h = self.label * enf
        else:
            # reference applies the weight inside the subtraction for grad
            # (regression_objective.hpp:682) — replicated verbatim
            g = 1.0 - self.label * enf * self.weights
            h = self.label * enf * self.weights
        return g, h

    def to_model_string(self) -> str:
        return self.name


@register
class Tweedie(Poisson):
    """reference regression_objective.hpp:696-732."""
    name = "tweedie"

    def __init__(self, config: Config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def get_gradients(self, score):
        s = score[0]
        rho = self.rho
        e1 = torch.exp((1.0 - rho) * s)
        e2 = torch.exp((2.0 - rho) * s)
        g = -self.label * e1 + e2
        h = -self.label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return _apply_weight(g, h, self.weights)

    def to_model_string(self) -> str:
        return self.name


# ---------------------------------------------------------------------------
# Multiclass
# ---------------------------------------------------------------------------

@register
class MulticlassSoftmax(Objective):
    """reference src/objective/multiclass_objective.hpp:24-175."""
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        if self.num_class < 2:
            raise ValueError("num_class must be >= 2 for multiclass")

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        label = np.asarray(metadata.label)
        label_int = label.astype(np.int32)
        if label_int.min() < 0 or label_int.max() >= self.num_class:
            raise ValueError(
                f"label must be in [0, {self.num_class}) for multiclass")
        w = metadata.weight
        if w is None:
            probs = np.bincount(label_int, minlength=self.num_class).astype(np.float64)
            sum_w = float(num_data)
        else:
            probs = np.bincount(label_int, weights=np.asarray(w, np.float64),
                                minlength=self.num_class)
            sum_w = float(np.asarray(w, np.float64).sum())
        self.class_init_probs = probs / sum_w
        self._onehot = torch.as_tensor(
            (label_int[None, :] == np.arange(self.num_class)[:, None])
            .astype(np.float32), device=device)

    def num_model_per_iteration(self) -> int:
        return self.num_class

    def get_gradients(self, score):
        # score [k, n] -> softmax over classes
        p = torch.exp(score - score.max(dim=0, keepdim=True).values)
        p = p / _sum_classes(p)
        g = p - self._onehot
        h = 2.0 * p * (1.0 - p)
        if self.weights is not None:
            g = g * self.weights[None, :]
            h = h * self.weights[None, :]
        return g, h

    def boost_from_score(self, class_id: int) -> float:
        return float(np.log(max(K_EPSILON, self.class_init_probs[class_id])))

    def class_need_train(self, class_id: int) -> bool:
        p = abs(self.class_init_probs[class_id])
        return K_EPSILON < p < 1.0 - K_EPSILON

    def convert_output(self, raw):
        # raw [k, n] -> softmax probabilities [k, n]
        m = np.max(raw, axis=0, keepdims=True)
        e = np.exp(raw - m)
        return e / e.sum(axis=0, keepdims=True)

    def to_model_string(self) -> str:
        return f"multiclass num_class:{self.num_class}"


@register
class MulticlassOVA(Objective):
    """reference multiclass_objective.hpp:180-270: one binary logloss per
    class on the indicator label == k."""
    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.sigmoid = float(config.sigmoid)
        if self.num_class < 2:
            raise ValueError("num_class must be >= 2 for multiclassova")
        self.binary_losses = [
            BinaryLogloss(config, is_pos_fn=(lambda lbl, k=k:
                                             lbl.astype(np.int32) == k))
            for k in range(self.num_class)]

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        for bl in self.binary_losses:
            bl.init(metadata, num_data, device)

    def num_model_per_iteration(self) -> int:
        return self.num_class

    def get_gradients(self, score):
        gs, hs = [], []
        for k, bl in enumerate(self.binary_losses):
            g, h = bl.get_gradients(score[k:k + 1])
            gs.append(g)
            hs.append(h)
        return torch.stack(gs), torch.stack(hs)

    def boost_from_score(self, class_id: int) -> float:
        return self.binary_losses[class_id].boost_from_score(0)

    def class_need_train(self, class_id: int) -> bool:
        return self.binary_losses[class_id].class_need_train(0)

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * raw))

    def to_model_string(self) -> str:
        return f"multiclassova num_class:{self.num_class} sigmoid:{self.sigmoid:g}"


# ---------------------------------------------------------------------------
# Cross-entropy family (labels in [0, 1])
# ---------------------------------------------------------------------------

def _check_label_01(label: np.ndarray, name: str) -> None:
    if label.min() < 0.0 or label.max() > 1.0:
        raise ValueError(f"[{name}]: labels must be in [0, 1]")


@register
class CrossEntropy(Objective):
    """reference src/objective/xentropy_objective.hpp:44-143."""
    name = "cross_entropy"

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        _check_label_01(np.asarray(metadata.label, np.float64), self.name)
        if metadata.weight is not None:
            w = np.asarray(metadata.weight, np.float64)
            if w.min() < 0:
                raise ValueError(f"[{self.name}]: at least one weight is negative")
            if w.sum() == 0:
                raise ValueError(f"[{self.name}]: sum of weights is zero")

    def get_gradients(self, score):
        z = 1.0 / (1.0 + torch.exp(-score[0]))
        g = z - self.label
        h = z * (1.0 - z)
        return _apply_weight(g, h, self.weights)

    def boost_from_score(self, class_id: int) -> float:
        label = np.asarray(self.metadata.label, np.float64)
        w = self.metadata.weight
        if w is not None:
            w = np.asarray(w, np.float64)
            pavg = float((label * w).sum() / w.sum())
        else:
            pavg = float(label.mean())
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        return float(np.log(pavg / (1.0 - pavg)))

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-raw))

    def to_model_string(self) -> str:
        return self.name


@register
class CrossEntropyLambda(Objective):
    """reference xentropy_objective.hpp:148-271: p = 1-exp(-lambda*w),
    lambda = log(1+exp(f)).  ConvertOutput yields lambda, not p."""
    name = "cross_entropy_lambda"

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        _check_label_01(np.asarray(metadata.label, np.float64), self.name)
        if metadata.weight is not None:
            w = np.asarray(metadata.weight, np.float64)
            if w.min() <= 0:
                raise ValueError(
                    f"[{self.name}]: at least one weight is non-positive")

    def get_gradients(self, score):
        s = score[0]
        if self.weights is None:
            z = 1.0 / (1.0 + torch.exp(-s))
            return z - self.label, z * (1.0 - z)
        w = self.weights
        y = self.label
        epf = torch.exp(s)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        g = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        h = a * (1.0 + y * b)
        return g, h

    def boost_from_score(self, class_id: int) -> float:
        label = np.asarray(self.metadata.label, np.float64)
        w = self.metadata.weight
        if w is not None:
            w = np.asarray(w, np.float64)
            havg = float((label * w).sum() / w.sum())
        else:
            havg = float(label.mean())
        return float(np.log(np.expm1(havg)))

    def convert_output(self, raw):
        return np.log1p(np.exp(raw))

    def to_model_string(self) -> str:
        return self.name


# ---------------------------------------------------------------------------
# Learning to rank
# ---------------------------------------------------------------------------

def default_label_gain() -> List[float]:
    """2^i - 1 gains, 31 levels (reference dcg_calculator.cpp:32-40)."""
    return [0.0] + [float((1 << i) - 1) for i in range(1, 31)]


class _RankBase(Objective):
    host_only = True  # per-query sorts + host RNG stay off the jit path

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            raise ValueError(f"{self.name} tasks require query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(self.query_boundaries) - 1
        self.label_np = np.asarray(metadata.label, np.float64)
        self.weight_np = (None if metadata.weight is None
                          else np.asarray(metadata.weight, np.float64))

    def _to_device(self, lambdas: np.ndarray, hessians: np.ndarray):
        """[1, n] f32 gradients on the scores' device."""
        return (torch.as_tensor(lambdas.astype(np.float32)[None, :],
                                device=self.device),
                torch.as_tensor(hessians.astype(np.float32)[None, :],
                                device=self.device))


@register
class LambdarankNDCG(_RankBase):
    """reference src/objective/rank_objective.hpp:23-254.

    Pairwise NDCG lambdas computed per query on host, vectorized over the
    [cnt, cnt] pair matrix per query.  Exact sigmoid replaces the
    reference's 1M-entry lookup table (rank_objective.hpp:196-209)."""
    name = "lambdarank"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            raise ValueError("sigmoid must be > 0")
        self.norm = bool(config.lambdamart_norm)
        self.optimize_pos_at = int(config.max_position)
        gains = list(config.label_gain) or default_label_gain()
        self.label_gain = np.asarray(gains, np.float64)

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        lbl = self.label_np
        if np.abs(lbl - lbl.astype(np.int64)).max() > K_EPSILON:
            raise ValueError("label must be int type for ranking task")
        if lbl.min() < 0:
            raise ValueError("label must be non-negative for ranking task")
        if int(lbl.max()) >= len(self.label_gain):
            raise ValueError("label exceeds label_gain size")
        # cache 1/maxDCG@k per query (reference rank_objective.hpp:60-70)
        self.inverse_max_dcgs = np.zeros(self.num_queries)
        for q in range(self.num_queries):
            a, b = self.query_boundaries[q], self.query_boundaries[q + 1]
            mdcg = self._max_dcg_at_k(self.optimize_pos_at, lbl[a:b])
            self.inverse_max_dcgs[q] = 1.0 / mdcg if mdcg > 0 else 0.0

    def _max_dcg_at_k(self, k: int, label: np.ndarray) -> float:
        k = min(k, len(label))
        top = np.sort(label)[::-1][:k].astype(np.int64)
        disc = 1.0 / np.log2(2.0 + np.arange(k))
        return float((self.label_gain[top] * disc).sum())

    def get_gradients(self, score):
        s = _host_scores(score).reshape(-1)[:self.num_data]
        lambdas = np.zeros(self.num_data)
        hessians = np.zeros(self.num_data)
        for q in range(self.num_queries):
            a, b = int(self.query_boundaries[q]), int(self.query_boundaries[q + 1])
            self._one_query(s[a:b], self.label_np[a:b],
                            self.inverse_max_dcgs[q],
                            lambdas[a:b], hessians[a:b])
        if self.weight_np is not None:
            lambdas *= self.weight_np
            hessians *= self.weight_np
        return self._to_device(lambdas, hessians)

    def _one_query(self, s, label, inv_max_dcg, out_l, out_h):
        cnt = len(s)
        if cnt <= 1 or inv_max_dcg <= 0:
            return
        # sorted positions by descending score (stable)
        order = np.argsort(-s, kind="stable")
        ss = s[order]
        ll = label[order].astype(np.int64)
        gains = self.label_gain[ll]
        disc = 1.0 / np.log2(2.0 + np.arange(cnt))
        best_score, worst_score = ss[0], ss[-1]
        # pair (i=high rank pos, j=low): valid iff label[i] > label[j]
        valid = ll[:, None] > ll[None, :]
        delta_score = ss[:, None] - ss[None, :]
        dcg_gap = gains[:, None] - gains[None, :]
        paired_disc = np.abs(disc[:, None] - disc[None, :])
        delta_ndcg = dcg_gap * paired_disc * inv_max_dcg
        if self.norm and best_score != worst_score:
            delta_ndcg = delta_ndcg / (0.01 + np.abs(delta_score))
        with np.errstate(over="ignore"):
            p = 1.0 / (1.0 + np.exp(np.clip(delta_score * self.sigmoid,
                                            -88.0, 88.0)))
        p_lambda = np.where(valid, -self.sigmoid * delta_ndcg * p, 0.0)
        p_hess = np.where(valid,
                          self.sigmoid * self.sigmoid * delta_ndcg
                          * p * (1.0 - p), 0.0)
        lam_sorted = p_lambda.sum(axis=1) - p_lambda.sum(axis=0)
        hes_sorted = p_hess.sum(axis=1) + p_hess.sum(axis=0)
        sum_lambdas = -2.0 * p_lambda.sum()
        if self.norm and sum_lambdas > 0:
            factor = np.log2(1 + sum_lambdas) / sum_lambdas
            lam_sorted *= factor
            hes_sorted *= factor
        out_l[order] += lam_sorted
        out_h[order] += hes_sorted

    def to_model_string(self) -> str:
        return self.name


@register
class RankXENDCG(_RankBase):
    """reference src/objective/rank_xendcg_objective.hpp:19-138
    (XE_NDCG, arxiv.org/abs/1911.09798).  Stochastic (per-doc gamma draws),
    hence host_only."""
    name = "rank_xendcg"

    def __init__(self, config: Config):
        super().__init__(config)
        self._rng = np.random.default_rng(int(config.objective_seed))

    def get_gradients(self, score):
        s = _host_scores(score).reshape(-1)[:self.num_data]
        lambdas = np.zeros(self.num_data)
        hessians = np.zeros(self.num_data)
        for q in range(self.num_queries):
            a, b = int(self.query_boundaries[q]), int(self.query_boundaries[q + 1])
            self._one_query(s[a:b], self.label_np[a:b],
                            lambdas[a:b], hessians[a:b])
        return self._to_device(lambdas, hessians)

    def _one_query(self, s, label, out_l, out_h):
        cnt = len(s)
        if cnt == 0:
            return
        e = np.exp(s - s.max())
        rho = e / e.sum()
        gammas = self._rng.random(cnt)
        phi = np.power(2.0, label) - gammas
        sum_labels = phi.sum()
        if sum_labels == 0:
            return
        l1 = -phi / sum_labels + rho
        # the reference's j!=i loops never evaluate 1/(1-rho) for
        # single-doc queries (rho=1); guard the vectorized form
        denom = 1.0 - rho
        inv = np.where(denom > 1e-300, 1.0 / np.where(denom > 1e-300,
                                                      denom, 1.0), 0.0)
        a = l1 * inv
        l2 = a.sum() - a
        b = rho * l2 * inv
        l3 = b.sum() - b
        out_l[:] = l1 + rho * l2 + rho * l3
        out_h[:] = rho * (1.0 - rho)

    def to_model_string(self) -> str:
        return self.name
