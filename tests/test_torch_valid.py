"""Validation sets, evaluation and early stopping, lightgbm_tpu_torch
against lightgbm_tpu.

The shape of tests/test_torch_slice_quant.py: 4,096 rows x 10 features
with NaNs, the first 3,072 train and the rest validate (built with
`reference=` the training set), 63 bins, 512-row blocks.  Both packages
run one script (tests/test_torch_util.py:train_valid_run), the JAX
package in a process compiled without FMA.

- int8 regression with the leaf refit off (integer histograms, exact
  gradients): the evals_result curves are equal value for value, the
  model text byte-identical, and an early stop fires at the same
  iteration with equal best_iteration and best_score;
- the training set among the valid sets, a custom feval and
  first_metric_only behave as in the JAX package;
- hilo binary (f32 sums in another order): the valid AUC curve within
  AUC_TOL of the JAX package's;
- a validation set added after some iterations (its scores replayed in
  one packed-forest pass) scores as one added from the start, within
  the f32 rounding of the other summation order.
"""

import json
import re

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb

from .test_torch_util import run_jax_nofma, train_valid_run

N, N_TRAIN = 4096, 3072
BASE = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 5, "verbosity": -1, "tpu_block_rows": 512,
        "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
        "tpu_hist_impl": "fused"}
# learns fast enough that the valid l2 turns after 9 iterations
OVERFIT = dict(BASE, learning_rate=0.5, num_leaves=31, min_data_in_leaf=2)
RUNS = [
    dict(params=BASE, label="regression", n_train=N_TRAIN, rounds=8),
    dict(params=dict(OVERFIT, metric=["l2", "l1"]), label="regression",
         n_train=N_TRAIN, rounds=30, valid="train+valid",
         early_stopping_rounds=3),
    dict(params=dict(OVERFIT, metric=["l1", "l2"], first_metric_only=True),
         label="regression", n_train=N_TRAIN, rounds=30, feval="mae",
         early_stopping_rounds=3),
    dict(params=dict(BASE, objective="binary", metric="auc",
                     tpu_hist_precision="hilo", tpu_hist_impl="pallas2"),
         label="binary", n_train=N_TRAIN, rounds=5),
]
# hilo binary: the valid AUC of the two packages, whose f32 histogram
# sums round in another order
AUC_TOL = 5e-3


def _data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(N, 10))
    X[rng.random(X.shape) < 0.02] = np.nan
    Xn = np.nan_to_num(X)
    signal = Xn[:, 0] + 0.5 * Xn[:, 1] * Xn[:, 2]
    y_reg = signal + 0.3 * rng.normal(size=N)
    y_bin = (signal + 0.3 * rng.normal(size=N) > 0).astype(np.float64)
    return X, {"regression": y_reg, "binary": y_bin}


def _text(text):
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


def _port(run):
    return dict(run, params=dict(run["params"], device_type="cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    X, ys = _data()
    jax = run_jax_nofma("train_valid",
                        {"X": X, **{"y_" + k: v for k, v in ys.items()}},
                        {"runs": RUNS}, tmp_path_factory.mktemp("valid"))
    port = [train_valid_run(tlgb, X, ys[r["label"]], _port(r))
            for r in RUNS]
    return jax, port


def test_evals_result_equal_and_text_byte_identical(runs):
    jax, port = runs
    evals = json.loads(port[0]["evals"])
    assert list(evals) == ["valid"] and len(evals["valid"]["l2"]) == 8
    assert port[0]["evals"] == str(jax["0_evals"])
    assert _text(port[0]["text"]) == _text(str(jax["0_text"]))
    assert port[0]["best_iteration"] == int(jax["0_best_iteration"]) == -1


def test_early_stopping_fires_at_the_same_iteration(runs):
    jax, port = runs
    got = port[1]
    evals = json.loads(got["evals"])
    # the stop fired: 3 rounds past the best, well before 30
    assert len(evals["valid"]["l2"]) == got["best_iteration"] + 3 < 30
    assert got["best_iteration"] == int(jax["1_best_iteration"])
    assert got["best_score"] == str(jax["1_best_score"])
    assert got["evals"] == str(jax["1_evals"])
    assert _text(got["text"]) == _text(str(jax["1_text"]))
    assert _text(got["full_text"]) == _text(str(jax["1_full_text"]))


def test_valid_sets_may_contain_the_training_set(runs):
    jax, port = runs
    evals = json.loads(port[1]["evals"])
    # the training set reports as "training" and never stops the run
    assert list(evals) == ["training", "valid"]
    assert list(evals["training"]) == ["l2", "l1"]
    train_l2 = evals["training"]["l2"]
    assert all(a > b for a, b in zip(train_l2, train_l2[1:]))
    assert json.loads(port[1]["best_score"])["training"]["l2"] == \
        train_l2[port[1]["best_iteration"] - 1]


def test_feval_and_first_metric_only(runs):
    jax, port = runs
    got = port[2]
    evals = json.loads(got["evals"])
    assert list(evals["valid"]) == ["l1", "l2", "mae"]
    # the feval's mae of the raw scores is the l1 metric
    np.testing.assert_allclose(evals["valid"]["mae"], evals["valid"]["l1"],
                               rtol=1e-12)
    assert got["evals"] == str(jax["2_evals"])
    assert got["best_iteration"] == int(jax["2_best_iteration"])
    # only l1, the first metric, decides the stop
    l1 = evals["valid"]["l1"]
    assert got["best_iteration"] == int(np.argmin(l1)) + 1
    assert _text(got["text"]) == _text(str(jax["2_text"]))


def test_hilo_binary_valid_auc_within_tolerance(runs):
    jax, port = runs
    got = json.loads(port[3]["evals"])["valid"]["auc"]
    ref = json.loads(str(jax["3_evals"]))["valid"]["auc"]
    assert len(got) == len(ref) == 5
    assert np.abs(np.subtract(got, ref)).max() <= AUC_TOL
    assert got[-1] > 0.8


def test_predict_and_text_default_to_the_best_iteration():
    X, ys = _data()
    y = ys["regression"]
    p = dict(OVERFIT, device_type="cpu")
    train = tlgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN])
    valid = train.create_valid(X[N_TRAIN:], label=y[N_TRAIN:])
    b = tlgb.train(p, train, 30, valid_sets=[valid],
                   early_stopping_rounds=3, verbose_eval=False)
    best = b.best_iteration
    assert 0 < best < b.current_iteration() < 30
    Xv = X[N_TRAIN:]
    np.testing.assert_array_equal(b.predict(Xv), b.predict(Xv, best))
    assert not np.array_equal(b.predict(Xv), b.predict(Xv, -1))
    assert b.model_to_string() == b.model_to_string(num_iteration=best)
    assert b.model_to_string().count("\nTree=") == best
    assert list(b.best_score) == ["valid_0"]


def test_valid_set_added_later_replays_its_scores():
    X, ys = _data()
    y = ys["regression"]
    p = dict(BASE, device_type="cpu")

    def booster():
        train = tlgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN])
        return train, tlgb.Booster(p, train)

    train, early = booster()
    early.add_valid(train.create_valid(X[N_TRAIN:], label=y[N_TRAIN:]),
                    "v")
    train, late = booster()
    for b in (early, late):
        for _ in range(4):
            b.update()
    late.add_valid(tlgb.Dataset(X[N_TRAIN:], label=y[N_TRAIN:],
                                reference=train), "v")
    for b in (early, late):
        b.update()
    # evaluation materializes the pending trees into the valid scores
    (_, name, ve, _), = early.eval_valid()
    (_, _, vl, _), = late.eval_valid()
    assert name == "l2" and abs(ve - vl) <= 1e-6 * ve
    se = early._driver.valid_scores[0].numpy()
    sl = late._driver.valid_scores[0].numpy()
    # the replay sums the four trees first (XLA's order), then adds them
    assert np.abs(se - sl).max() <= 1e-6 * np.abs(se).max()
    # an ad-hoc dataset replays the same way without registering
    (_, _, va, _), = late.eval(tlgb.Dataset(
        X[N_TRAIN:], label=y[N_TRAIN:], reference=train), "adhoc")
    assert abs(va - ve) <= 1e-6 * ve
    assert len(late._driver.valid_sets) == 1


def test_dataset_reference_shares_the_mappers():
    X, ys = _data()
    y = ys["regression"]
    p = {"max_bin": 63, "device_type": "cpu"}
    train = tlgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN], params=p)
    valid = tlgb.Dataset(X[N_TRAIN:], label=y[N_TRAIN:], reference=train)
    # the reference, not yet constructed, is constructed first
    valid.construct()
    assert train._inner is not None
    assert valid._inner.mappers is train._inner.mappers
    assert valid._inner.used_feature_idx == train._inner.used_feature_idx
    assert valid._inner.bins_t.shape == (len(train._inner.used_feature_idx),
                                         N - N_TRAIN)
    np.testing.assert_array_equal(valid.get_label(),
                                  y[N_TRAIN:].astype(np.float32))
    with pytest.raises(ValueError, match="feature count"):
        tlgb.Dataset(X[:10, :5], reference=train).construct()
    b = tlgb.Booster(dict(BASE, device_type="cpu"), train)
    with pytest.raises(ValueError, match="reference"):
        b.add_valid(tlgb.Dataset(X[N_TRAIN:], label=y[N_TRAIN:], params=p),
                    "v")
