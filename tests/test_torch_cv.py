"""`lgb.cv`, lightgbm_tpu_torch against lightgbm_tpu.

The folds come from the same numpy generator (`_make_n_folds`:
stratified for binary labels, plain, shuffled or not), each fold's
datasets are row subsets of the binned dataset (`Dataset.subset`: the
parent's mappers, its binned rows gathered, nothing binned again), and
the folds train in turns.  On 3,000 rows x 6 features with NaNs, 63
bins, int8 with the leaf refit off, the JAX package in a process
compiled without FMA (tests/test_torch_util.py:cv_run):

- regression: every `-mean`/`-stdv` series equal, with and without an
  early stop that fires; return_cvbooster fans predict out over the
  folds, each fold's raw scores equal to the JAX package's;
- binary: the series within 1e-6 relative (the gradients' `exp` differs
  from XLA's in the last ulps, ROADMAP §C).
"""

import json

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.engine import _make_n_folds as j_make_n_folds
from lightgbm_tpu_torch.engine import _make_n_folds as t_make_n_folds

from .test_torch_util import cv_run, run_jax_nofma

N = 3000
BASE = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 5, "verbosity": -1, "tpu_block_rows": 512,
        "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
        "tpu_hist_impl": "fused", "metric": ["l2", "l1"]}
RUNS = {
    "regression": dict(params=BASE, rounds=6, nfold=3),
    # learns fast enough that the mean l2 turns within 30 rounds
    "early_stop": dict(params=dict(BASE, learning_rate=0.5, num_leaves=31,
                                   min_data_in_leaf=2),
                       rounds=30, nfold=3, early_stopping_rounds=3),
    "binary": dict(params=dict(BASE, objective="binary",
                               metric=["binary_logloss", "auc"]),
                   label="binary", rounds=6, nfold=3),
    "cvbooster": dict(params=BASE, rounds=4, nfold=4, shuffle=False,
                      seed=3, return_cvbooster=True),
}


def _data():
    rng = np.random.default_rng(13)
    X = rng.normal(size=(N, 6))
    X[rng.random(X.shape) < 0.03] = np.nan
    Xn = np.nan_to_num(X)
    y = Xn[:, 0] + 0.5 * Xn[:, 1] * Xn[:, 2] + 0.3 * rng.normal(size=N)
    logit = Xn[:, :3].sum(1) - 0.5 + rng.logistic(size=N)
    return X, {"regression": y, "binary": (logit > 0).astype(np.float64)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    X, ys = _data()
    port = {}
    for name, run in RUNS.items():
        port[name] = cv_run(
            tlgb, X, ys[run.get("label", "regression")],
            dict(run, params=dict(run["params"], device_type="cpu")))
    runs = [dict(run, kind="cv") for run in RUNS.values()]
    got = run_jax_nofma("boosting", {"X": X, **{"y_" + k: v
                                                for k, v in ys.items()}},
                        {"runs": runs}, tmp_path_factory.mktemp("cv"))
    jax = {name: (str(got[f"{c}_result"]), got.get(f"{c}_raw"))
           for c, name in enumerate(RUNS)}
    return port, jax


@pytest.mark.parametrize("stratified,shuffle", [(True, True), (False, False),
                                                (False, True)],
                         ids=["stratified", "plain", "shuffled"])
def test_folds_equal_jax(stratified, shuffle):
    X, ys = _data()
    y = ys["binary"]
    fj = j_make_n_folds(jlgb.Dataset(X, label=y), 4, {}, 5, stratified,
                        shuffle)
    ft = t_make_n_folds(tlgb.Dataset(X, label=y,
                                     params={"device_type": "cpu"}),
                        4, 5, stratified, shuffle)
    assert len(ft) == len(fj) == 4
    for (tr_t, te_t), (tr_j, te_j) in zip(ft, fj):
        np.testing.assert_array_equal(tr_t, tr_j)
        np.testing.assert_array_equal(te_t, te_j)


@pytest.mark.parametrize("name", ["regression", "early_stop", "cvbooster"])
def test_regression_results_equal(results, name):
    port, jax = results
    got, want = json.loads(port[name][0]), json.loads(jax[name][0])
    assert got == want
    assert set(got) == {"l2-mean", "l2-stdv", "l1-mean", "l1-stdv"}
    if name == "early_stop":
        # the early stop fired: the series end at the best round
        assert len(got["l2-mean"]) < RUNS[name]["rounds"]
        assert np.argmin(got["l2-mean"]) == len(got["l2-mean"]) - 1


def test_binary_results_within_gradient_ulps(results):
    port, jax = results
    got, want = json.loads(port["binary"][0]), json.loads(jax["binary"][0])
    assert set(got) == set(want) == {
        "binary_logloss-mean", "binary_logloss-stdv", "auc-mean", "auc-stdv"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-9, err_msg=key)


def test_cvbooster_fans_predict_out_over_the_folds(results):
    port, jax = results
    raw_t, raw_j = port["cvbooster"][1], jax["cvbooster"][1]
    assert raw_t.shape == raw_j.shape == (4, N)
    np.testing.assert_array_equal(raw_t, raw_j)
    # four different models
    assert len({raw_t[i].tobytes() for i in range(4)}) == 4


def test_given_folds_train_as_the_drawn_ones(results):
    # folds= takes (train, test) index pairs in place of the drawn ones
    X, ys = _data()
    run = RUNS["regression"]
    p = dict(run["params"], device_type="cpu")
    ds = tlgb.Dataset(X, label=ys["regression"],
                      params={"max_bin": p["max_bin"], "device_type": "cpu"})
    folds = t_make_n_folds(ds, run["nfold"], 0, False, True)
    res = tlgb.cv(p, ds, num_boost_round=run["rounds"], folds=folds)
    assert res == json.loads(results[0]["regression"][0])


def test_subset_shares_mappers_and_slices_bins():
    X, ys = _data()
    ds = tlgb.Dataset(X, label=ys["regression"],
                      params={"device_type": "cpu", "max_bin": 63})
    idx = np.arange(0, N, 3)
    sub = ds.subset(idx)
    assert sub._inner.mappers is ds._inner.mappers
    assert sub.num_data() == len(idx)
    np.testing.assert_array_equal(sub._inner.bins_t.numpy(),
                                  ds._inner.bins_t.numpy()[:, idx])
    np.testing.assert_array_equal(sub.get_field("label"),
                                  ds.get_label()[idx])
