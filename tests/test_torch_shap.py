"""SHAP contributions (pred_contrib) of lightgbm_tpu_torch against
lightgbm_tpu, after tests/test_shap_refit.py.

The JAX package trains each model in one process compiled without FMA
(job "shap") and returns its text and its `forest_contribs`; the port
loads the text and computes the contributions batched over rows as
torch ops (models/shap.py:forest_contribs_t), which must equal them bit
for bit, and equal its own numpy twin (`forest_contribs`, a copy of the
JAX module).  Models the port trains are held to the JAX package's
`forest_contribs` on the same text, computed in this process.
"""

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models.shap import forest_contribs as jax_contribs
from lightgbm_tpu_torch.models import shap

from .test_torch_util import start_jax_nofma, strip_mapper_trailer

CPU = {"device_type": "cpu", "verbosity": -1}


def _inputs():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(1500, 6))
    X[rng.random(X.shape) < 0.03] = np.nan
    Xn = np.nan_to_num(X)
    y = (Xn[:, 0] + 0.6 * Xn[:, 1] ** 2 - 0.4 * Xn[:, 2] > 0.5).astype(
        np.float64)
    # categorical column 0 (tests/test_shap_refit.py:62-82): NaN and
    # fractional negatives at predict time fold to category 0
    rng = np.random.default_rng(5)
    Xc = np.column_stack([rng.integers(0, 6, 1000).astype(np.float64),
                          rng.normal(size=1000)])
    yc = (Xc[:, 0] < 2) * 2.0 + Xc[:, 1]
    vals = np.concatenate([np.full(20, np.nan), np.full(20, -0.5),
                           np.arange(20) % 8.0])
    Xpc = np.column_stack([vals, rng.normal(size=60)])
    # five classes
    rng = np.random.default_rng(11)
    Xm = rng.normal(size=(1200, 5))
    ym = np.digitize(Xm[:, 0] + 0.5 * Xm[:, 1] ** 2,
                     [-0.8, 0.0, 0.6, 1.4]).astype(np.float64)
    return {"X_num": X, "y_num": y, "Xp_num": X[:80],
            "X_cat": Xc, "y_cat": yc, "Xp_cat": Xpc,
            "X_multi": Xm, "y_multi": ym, "Xp_multi": Xm[:40]}


RUNS = [
    {"name": "binary", "data": "num", "rounds": 12,
     "params": {"objective": "binary", "num_leaves": 15, "max_bin": 63,
                "min_data_in_leaf": 10, "use_missing": True}},
    {"name": "categorical", "data": "cat", "rounds": 5, "cat": [0],
     "params": {"objective": "regression", "num_leaves": 15, "max_bin": 32,
                "min_data_in_leaf": 5}},
    {"name": "multiclass", "data": "multi", "rounds": 3,
     "params": {"objective": "multiclass", "num_class": 5, "num_leaves": 7,
                "max_bin": 63}},
]


@pytest.fixture(scope="module")
def jax_models(tmp_path_factory):
    inp = _inputs()
    out = start_jax_nofma("shap", inp, {"runs": RUNS},
                          tmp_path_factory.mktemp("shap"))()
    return inp, {run["name"]: {k: out[f"{c}_{k}"]
                               for k in ("text", "contrib", "raw")}
                 for c, run in enumerate(RUNS)}


@pytest.mark.parametrize("name", [r["name"] for r in RUNS])
@pytest.mark.parametrize("trailer", ["kept", "stripped"])
def test_contribs_equal_the_jax_forest_contribs(jax_models, name, trailer):
    inp, models = jax_models
    run = next(r for r in RUNS if r["name"] == name)
    Xp = inp["Xp_" + run["data"]]
    text = str(models[name]["text"])
    if trailer == "stripped":
        text = strip_mapper_trailer(text)
    b = tlgb.Booster(model_str=text, params=CPU)
    got = b.predict(Xp, pred_contrib=True)
    np.testing.assert_array_equal(got, models[name]["contrib"])
    F = Xp.shape[1]
    k = b.num_model_per_iteration()
    assert got.shape == (len(Xp), k * (F + 1))
    # additive: each class's contributions sum to its raw score
    raw = models[name]["raw"].reshape(len(Xp), k)
    np.testing.assert_allclose(got.reshape(len(Xp), k, F + 1).sum(axis=2),
                               raw, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", [r["name"] for r in RUNS])
def test_batched_walk_equals_its_numpy_twin(jax_models, name):
    inp, models = jax_models
    run = next(r for r in RUNS if r["name"] == name)
    Xp = inp["Xp_" + run["data"]]
    b = tlgb.Booster(model_str=str(models[name]["text"]), params=CPU)
    trees = b._driver.models
    k = b.num_model_per_iteration()
    for total in (len(trees), k):
        np.testing.assert_array_equal(
            shap.forest_contribs_t(trees, Xp, total, k, "cpu"),
            shap.forest_contribs(trees, Xp, total, k))


def test_port_model_contribs_equal_the_jax_walk():
    """A model the port trains (numerical with NaN and a categorical
    column): its contributions equal the JAX package's forest_contribs of
    the same text, with num_iteration too; the rows add up to the raw
    f64 score."""
    inp = _inputs()
    X = inp["X_num"].copy()
    X[:, 5] = np.random.default_rng(3).integers(0, 4, len(X))
    b = tlgb.train(dict(RUNS[0]["params"], **CPU),
                   tlgb.Dataset(X, label=inp["y_num"],
                                categorical_feature=[5]), 8)
    jb = jlgb.Booster(model_str=b.model_to_string())
    Xp = X[:100]
    for it in (None, 3):
        got = b.predict(Xp, pred_contrib=True, num_iteration=it)
        total = len(jb._driver.models) if it is None else it
        want = jax_contribs(jb._driver.models, Xp, total, 1)[:, 0, :]
        np.testing.assert_array_equal(got, want)
    got = b.predict(Xp, pred_contrib=True)
    np.testing.assert_allclose(
        got.sum(axis=1), b.predict(Xp, raw_score=True,
                                   tpu_predict_device=False),
        rtol=1e-9, atol=1e-9)
