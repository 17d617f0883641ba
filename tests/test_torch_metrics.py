"""The metric zoo of lightgbm_tpu_torch (models/metrics.py and
metrics_ext.py) against lightgbm_tpu, on the same seeded scores.

Every metric of both packages, with and without row weights, evaluated
on one set of raw scores through its objective's output conversion (and
without an objective): the values equal, the names and
higher_is_better too.  The ranking metrics (ndcg, map at eval_at 1, 3
and 5) on queries of 5 to 30 rows; multi_error also at
multi_error_top_k=2; auc_mu also with auc_mu_weights.  create_metrics
picks each objective's default as the JAX package does.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.models.metrics import create_metrics as j_metrics
from lightgbm_tpu.models.objectives import create_objective as j_objective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.models.metrics import create_metrics as t_metrics
from lightgbm_tpu_torch.models.objectives import create_objective as t_objective

N = 1200
# metric -> (objective whose output conversion it reads, label kind,
# extra params)
CASES = {
    "l2": ("regression", "reg", {}),
    "rmse": ("regression", "reg", {}),
    "l1": ("regression_l1", "reg", {}),
    "quantile": ("quantile", "reg", {"alpha": 0.3}),
    "huber": ("huber", "reg", {"alpha": 0.7}),
    "fair": ("fair", "reg", {"fair_c": 0.5}),
    "mape": ("mape", "reg", {}),
    "poisson": ("poisson", "pos", {}),
    "gamma": ("gamma", "pos", {}),
    "gamma_deviance": ("gamma", "pos", {}),
    "tweedie": ("tweedie", "pos", {"tweedie_variance_power": 1.3}),
    "binary_logloss": ("binary", "bin", {}),
    "binary_error": ("binary", "bin", {}),
    "auc": ("binary", "bin", {}),
    "multi_logloss": ("multiclass", "cls", {"num_class": 3}),
    "multi_error": ("multiclass", "cls", {"num_class": 3}),
    "multi_error@2": ("multiclassova", "cls",
                      {"num_class": 3, "multi_error_top_k": 2}),
    "auc_mu": ("multiclass", "cls", {"num_class": 3}),
    "auc_mu_weighted": ("multiclass", "cls",
                        {"num_class": 3,
                         "auc_mu_weights": [0, 1, 2, 1, 0, 1, 2, 1, 0]}),
    "cross_entropy": ("cross_entropy", "p01", {}),
    "cross_entropy_lambda": ("cross_entropy_lambda", "p01", {}),
    "kldiv": ("cross_entropy", "p01", {}),
    "ndcg": ("lambdarank", "rel", {"eval_at": [1, 3, 5]}),
    "map": ("lambdarank", "rel", {"eval_at": [1, 3, 5]}),
}


def _inputs(kind, k):
    rng = np.random.default_rng(9)
    lat = rng.normal(size=N)
    cuts = np.quantile(lat, [0.2, 0.4, 0.6, 0.8])
    label = {"reg": lat, "pos": np.exp(0.5 * lat) + 0.05,
             "bin": (lat > 0.3).astype(np.float64),
             "p01": 1.0 / (1.0 + np.exp(-lat)),
             "cls": np.digitize(lat, cuts[1:3]).astype(np.float64),
             "rel": np.digitize(lat, cuts).astype(np.float64)}[kind]
    score = (0.8 * lat[None, :] + rng.normal(size=(k, N))).astype(
        np.float32).astype(np.float64)
    # ties between scores, which the rank metrics must break alike
    score[:, ::7] = np.round(score[:, ::7], 1)
    weight = (rng.random(N) * 2 + 0.1).astype(np.float32)
    sizes = []
    while sum(sizes) < N:
        sizes.append(int(rng.integers(5, 31)))
    sizes[-1] -= sum(sizes) - N
    return label.astype(np.float32), score, weight, np.asarray(sizes)


@pytest.mark.parametrize("with_objective", [True, False],
                         ids=["converted", "raw"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("metric", list(CASES))
@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_metric_equals_jax(metric, weighted, with_objective):
    objective, kind, extra = CASES[metric]
    name = metric.split("@")[0].replace("_weighted", "")
    params = dict(objective=objective, metric=name, **extra)
    k = int(extra.get("num_class", 1))
    label, score, weight, sizes = _inputs(kind, k)
    w = weight if weighted else None
    group = sizes if kind == "rel" else None
    jm = JMetadata(N, label, w, group)
    tm = TMetadata(N, label, w, group)
    jcfg, tcfg = jlgb.Config(params), TConfig(params)
    oj = ot = None
    if with_objective:
        oj = j_objective(jcfg)
        oj.init(jm, N)
        ot = t_objective(tcfg)
        ot.init(tm, N, torch.device("cpu"))
    (mj,), (mt,) = j_metrics(jcfg, objective), t_metrics(tcfg, objective)
    mj.init(jm, N)
    mt.init(tm, N)
    got, want = mt.eval_all(score, ot), mj.eval_all(score, oj)
    assert [n for n, _ in got] == [n for n, _ in want]
    # NaN where both packages take the log of a negative prediction
    np.testing.assert_array_equal([v for _, v in got], [v for _, v in want])
    assert mt.higher_is_better == mj.higher_is_better
    assert len(got) == (3 if kind == "rel" else 1)


@pytest.mark.parametrize("objective", [
    "regression", "regression_l1", "huber", "fair", "poisson", "quantile",
    "mape", "gamma", "tweedie", "binary", "multiclass", "multiclassova",
    "cross_entropy", "cross_entropy_lambda", "lambdarank", "rank_xendcg",
    ""])
def test_default_metrics_by_objective(objective):
    params = {"objective": objective or "none"}
    if objective.startswith("multiclass"):
        params["num_class"] = 3
    jm = j_metrics(jlgb.Config(params), objective)
    tm = t_metrics(TConfig(params), objective)
    assert [m.name for m in tm] == [m.name for m in jm]


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="bogus"):
        t_metrics(TConfig({"metric": "bogus"}), "regression")
