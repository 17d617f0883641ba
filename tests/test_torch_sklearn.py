"""The sklearn wrappers of lightgbm_tpu_torch against lightgbm_tpu's.

Seeded data of 1,000 rows x 5 features; the cases of
tests/test_sklearn_api.py at int8 with the leaf refit off and
`tpu_hist_impl=xla` named on both sides.  The JAX wrappers run in one
process compiled without FMA (job "sklearn" of tests/test_torch_util.py),
started before the port's estimators fit beside it on the CPU.

- LGBMRegressor, LGBMRanker with group, eval_set with early stopping, a
  custom objective and a DataFrame with category columns write the JAX
  wrappers' model text and predict alike; LGBMClassifier (binary, string
  labels, multiclass, class_weight='balanced') writes the same trees,
  with leaf values within `assert_trees_match`'s tolerance: its logistic
  and softmax gradients go through `exp`, whose last ulp differs between
  torch and XLA (ROADMAP C), and the rest of its text is equal;
- LGBMRanker without group raises as the JAX wrapper does;
- get_params/set_params, sklearn.base.clone and pickle round-trip;
- without device_type the estimators ask for the card.
"""

import json
import pickle
import re

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb

from .test_torch_util import (assert_trees_match, sklearn_run,
                              start_jax_nofma)

N = 1000
CPU = {"device_type": "cpu"}
SK = {"n_estimators": 4, "num_leaves": 15, "min_child_samples": 5,
      "max_bin": 63, "verbosity": -1, "tpu_hist_precision": "int8",
      "tpu_quant_refit_leaves": False, "tpu_hist_impl": "xla"}
QUERY = 10


def _data():
    rng = np.random.default_rng(31)
    X = rng.normal(size=(N, 5))
    X[rng.random(X.shape) < 0.03] = np.nan
    X[:, 3] = rng.integers(0, 6, N)
    Xn = np.nan_to_num(X)
    lat = Xn[:, 0] + 0.6 * Xn[:, 1] ** 2 + np.array(
        [0.0, 1.2, -0.4, 0.9, -1.1, 0.3])[X[:, 3].astype(int)] \
        + 0.3 * rng.normal(size=N)
    labels = {
        "regression": lat,
        "binary": (lat > np.median(lat)).astype(np.float64),
        "multi": np.digitize(lat, np.quantile(lat, [1 / 3, 2 / 3]))
        .astype(np.float64),
        "imbalanced": (lat > np.quantile(lat, 0.85)).astype(np.float64),
        "rank": np.digitize(lat, np.quantile(lat, [0.4, 0.7, 0.9]))
        .astype(np.float64)}
    return X, labels


RUNS = {
    "regressor": {"est": "LGBMRegressor", "kw": SK},
    "binary": {"est": "LGBMClassifier", "kw": SK, "label": "binary"},
    "string_labels": {"est": "LGBMClassifier", "kw": SK, "label": "binary",
                      "labels": "str"},
    "multiclass": {"est": "LGBMClassifier", "kw": SK, "label": "multi"},
    "balanced": {"est": "LGBMClassifier", "label": "imbalanced",
                 "kw": dict(SK, class_weight="balanced")},
    "ranker": {"est": "LGBMRanker", "kw": SK, "label": "rank",
               "group": [QUERY] * (N // QUERY)},
    "early_stopping": {"est": "LGBMRegressor", "n_train": 800,
                       "early_stopping_rounds": 3,
                       "kw": dict(SK, n_estimators=40, learning_rate=0.6)},
    "custom_objective": {"est": "LGBMRegressor", "kw": SK, "fobj": True},
    "categorical": {"est": "LGBMRegressor", "kw": SK, "cat": [3]},
    "category_frame": {"est": "LGBMRegressor", "kw": SK, "cat": [3],
                       "frame": True},
}


def _norm(text):
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's results, the JAX wrappers') of every run."""
    X, labels = _data()
    names = list(RUNS)
    job = start_jax_nofma(
        "sklearn", {"X": X, **{f"y_{k}": v for k, v in labels.items()}},
        {"runs": [RUNS[n] for n in names]},
        tmp_path_factory.mktemp("sklearn"))
    port = {}
    for name in names:
        run = RUNS[name]
        port[name] = sklearn_run(
            tlgb, X, labels[run.get("label", "regression")],
            dict(run, kw=dict(run["kw"], **CPU)))
    got = job()
    ref = {name: {k[len(f"{i}_"):]: v for k, v in got.items()
                  if k.startswith(f"{i}_")} for i, name in enumerate(names)}
    return port, ref


def _outside_trees(text):
    """The model text without its trees and their sizes."""
    head, rest = text.split("\nTree=0\n", 1)
    head = re.sub(r"^tree_sizes=.*$", "", head, flags=re.M)
    return head + rest.split("\nend of trees\n", 1)[1]


@pytest.mark.parametrize("name", list(RUNS))
def test_text_equal_to_jax_wrapper(both, name):
    port, ref = both
    got, want = _norm(port[name]["text"]), _norm(str(ref[name]["text"]))
    if RUNS[name]["est"] == "LGBMClassifier":
        assert _outside_trees(got) == _outside_trees(want)
        assert_trees_match(
            tlgb.Booster(model_str=want, params=CPU)._driver.models,
            tlgb.Booster(model_str=got, params=CPU)._driver.models)
    else:
        assert got == want
    assert port[name]["best_iteration"] == int(ref[name]["best_iteration"])
    assert json.loads(port[name]["evals"]) == json.loads(
        str(ref[name]["evals"]))


@pytest.mark.parametrize("name", list(RUNS))
def test_predict_equal_to_jax_wrapper(both, name):
    """Regression outputs equal the JAX device predict; a classifier's
    labels are equal and its probabilities, which the JAX wrapper takes
    from its f64 host walker, agree within 1e-6."""
    port, ref = both
    got, want = port[name]["pred"], ref[name]["pred"]
    if RUNS[name]["est"] == "LGBMClassifier":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(port[name]["proba"], ref[name]["proba"],
                                   rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_classifier_surface(both):
    port, _ = both
    assert set(np.unique(port["string_labels"]["pred"])) == {"neg", "pos"}
    assert port["multiclass"]["proba"].shape == (N, 3)
    np.testing.assert_allclose(port["binary"]["proba"].sum(1), 1.0,
                               rtol=1e-6)
    assert re.search(r"^num_cat=[1-9]", port["category_frame"]["text"],
                     re.M)
    assert port["category_frame"]["text"].endswith(
        '\npandas_categorical:[["k0", "k1", "k2", "k3", "k4", "k5"]]\n')


def test_ranker_requires_group():
    X, labels = _data()
    m = tlgb.LGBMRanker(n_estimators=2, device_type="cpu")
    with pytest.raises(ValueError, match="group"):
        m.fit(X, labels["rank"])


def test_get_set_params_and_clone():
    from sklearn.base import clone

    m = tlgb.LGBMRegressor(num_leaves=63, learning_rate=0.05,
                           device_type="cpu")
    p = m.get_params()
    assert p["num_leaves"] == 63 and p["device_type"] == "cpu"
    m.set_params(num_leaves=31)
    assert m.get_params()["num_leaves"] == 31
    m2 = clone(m)
    assert m2.get_params() == m.get_params()
    assert m2 is not m


def test_pickle_and_clone_round_trip():
    from sklearn.base import clone

    X, labels = _data()
    m = tlgb.LGBMClassifier(**SK, **CPU).fit(X, labels["binary"])
    back = pickle.loads(pickle.dumps(m))
    np.testing.assert_array_equal(back.predict_proba(X), m.predict_proba(X))
    np.testing.assert_array_equal(back.classes_, m.classes_)
    # a loaded booster writes no parameters; its trees are the model's
    assert back.booster_.model_to_string().split("\nparameters:")[0] == \
        m.booster_.model_to_string().split("\nparameters:")[0]
    refit = clone(m).fit(X, labels["binary"])
    assert refit.booster_.model_to_string() == m.booster_.model_to_string()
    # pred_leaf (once refused) passes through to the booster
    leaves = m.predict(X, pred_leaf=True)
    np.testing.assert_array_equal(leaves,
                                  m.booster_.predict(X, pred_leaf=True))
    np.testing.assert_array_equal(back.predict(X, pred_leaf=True), leaves)


def test_estimators_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    X, labels = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        tlgb.LGBMRegressor(n_estimators=1).fit(X, labels["regression"])
