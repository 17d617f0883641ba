"""The boosting modes GOSS, DART and RF and feature_fraction_bynode,
lightgbm_tpu_torch against lightgbm_tpu.

3,000 rows x 6 features with NaNs (the first 2,400 train, the rest
validate), 63 bins, 512-row blocks, int8 regression with the leaf refit
off (integer histograms, exact gradients).  Both packages run one script
(tests/test_torch_util.py:train_valid_run), the JAX package in one
process compiled without FMA (job "boosting").

- `prng.uniform` is `jax.random.uniform` bit for bit;
- feature_fraction_bynode=0.5, alone and with feature_fraction=0.8,
  int8 and int16: the whole model text byte-identical, under the port's
  `auto` (which leaves the fused scan, as the JAX grower leaves it under
  its accelerator's `fused`) and under `pallas2`; hilo binary trees
  within assert_trees_match's tolerance;
- GOSS at learning_rate 0.25 (4 warm-up iterations) over 8 iterations:
  the text byte-identical under `fused` and `pallas2`, the row mask of
  every tree as large as the JAX step's, with `fobj` the JAX package's
  unsampled text, and hilo binary trees within tolerance;
- DART with a validation set (drop_rate 0.5, skip_drop 0, max_drop 3),
  weighted, uniform_drop and xgboost_dart_mode: the text byte-identical,
  the eval curve equal, predict after training equal to the JAX
  package's device predict;
- RF (bagging 0.7 every iteration, feature_fraction 0.8): the text
  byte-identical with its `average_output` line, the eval curve equal,
  and a model of either package loads in the other and predicts alike.
"""

import json
import re

import jax
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils import prng

from .test_torch_util import (assert_trees_match, binary_data, run_jax_nofma,
                              train_valid_run)

N, N_TRAIN = 3000, 2400
BASE = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 5, "verbosity": -1, "tpu_block_rows": 512,
        "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
        "tpu_hist_impl": "fused", "tpu_predict_device": "true"}
BYNODE = dict(BASE, feature_fraction_bynode=0.5)
GOSS = dict(BASE, boosting="goss", learning_rate=0.25)
DART = dict(BASE, boosting="dart", drop_rate=0.5, skip_drop=0.0, max_drop=3)
RF = dict(BASE, boosting="rf", bagging_fraction=0.7, bagging_freq=1,
          feature_fraction=0.8)
ROUNDS = 8


def _bynode_cases():
    cases = {}
    for prec in ("int8", "int16"):
        for ff in (1.0, 0.8):
            for impl in ("fused", "pallas2"):
                cases[f"{prec}_ff{ff}_{impl}"] = dict(
                    BYNODE, tpu_hist_precision=prec, feature_fraction=ff,
                    tpu_hist_impl=impl)
    return cases


BYNODE_CASES = _bynode_cases()
GOSS_CASES = {"fused": GOSS, "pallas2": dict(GOSS, tpu_hist_impl="pallas2")}
DART_CASES = {"weighted": DART, "uniform_drop": dict(DART, uniform_drop=True),
              "xgboost_dart_mode": dict(DART, xgboost_dart_mode=True)}


def _data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N, 6))
    X[rng.random(X.shape) < 0.03] = np.nan
    Xn = np.nan_to_num(X)
    y = Xn[:, 0] + 0.5 * Xn[:, 1] * Xn[:, 2] + 0.3 * rng.normal(size=N)
    return X, {"regression": y}


def _runs():
    """name -> the run of train_valid_run, for both packages."""
    runs = {}
    for name, p in BYNODE_CASES.items():
        runs["bynode_" + name] = dict(params=p, n_train=N_TRAIN,
                                      rounds=5, valid="none")
    for name, p in GOSS_CASES.items():
        runs["goss_" + name] = dict(params=p, n_train=N_TRAIN,
                                    rounds=ROUNDS, valid="none")
    runs["goss_fobj"] = dict(params=GOSS, n_train=N_TRAIN, rounds=ROUNDS,
                             valid="none", fobj="l2")
    for name, p in DART_CASES.items():
        runs["dart_" + name] = dict(params=p, n_train=N_TRAIN,
                                    rounds=ROUNDS, callbacks=["record"])
    runs["rf"] = dict(params=RF, n_train=N_TRAIN, rounds=ROUNDS,
                      callbacks=["record"])
    return runs


RUNS = _runs()


def _port_params(p):
    # the port's auto is the accelerator's fused (B2 for int8/int16)
    p = dict(p, device_type="cpu")
    if p.get("feature_fraction_bynode", 1.0) < 1.0 \
            and p["tpu_hist_impl"] == "fused":
        p["tpu_hist_impl"] = "auto"
    return p


def _norm(text):
    for name in ("device_type", "tpu_hist_impl"):
        text = re.sub(rf"^\[{name}: [^\]]*\]$", f"[{name}: -]", text,
                      flags=re.M)
    return text


@pytest.fixture(scope="module")
def port():
    """Each run of the port, on the CPU."""
    X, ys = _data()
    out = {}
    for name, run in RUNS.items():
        out[name] = train_valid_run(
            tlgb, X, ys["regression"],
            dict(run, params=_port_params(run["params"])))
    return out


@pytest.fixture(scope="module")
def jax_ref(port, tmp_path_factory):
    """Every JAX run in one process without FMA: the runs, the GOSS
    step's row masks, and the port's RF model loaded and predicted."""
    X, ys = _data()
    runs = [dict(run, kind="train_valid") for run in RUNS.values()]
    runs.append({"kind": "goss_kept", "params": GOSS, "rounds": ROUNDS})
    runs.append({"kind": "load_predict", "text": port["rf"]["text"],
                 "start": N_TRAIN})
    got = run_jax_nofma("boosting", {"X": X, **{"y_" + k: v
                                                for k, v in ys.items()}},
                        {"runs": runs}, tmp_path_factory.mktemp("boosting"))
    out = {name: {k: got[f"{c}_{k}"] for k in ("text", "evals", "raw")}
           for c, name in enumerate(RUNS)}
    out["goss_kept"] = got[f"{len(RUNS)}_kept"]
    out["rf_port_text_raw"] = got[f"{len(RUNS) + 1}_raw"]
    return out


@pytest.mark.parametrize("shape", [(32,), (50, 32)], ids=str)
@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1])
def test_uniform_bit_equal_to_jax(seed, shape):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.uniform(key, shape))
    got = prng.uniform(np.asarray(key), shape)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", list(BYNODE_CASES))
def test_bynode_text_byte_identical(port, jax_ref, name):
    run = "bynode_" + name
    assert _norm(port[run]["text"]) == _norm(str(jax_ref[run]["text"]))


def test_bynode_auto_leaves_the_fused_scan(monkeypatch):
    # auto picks fused for int8, whose grower then runs the B1 histogram
    # and the torch split search every round, never B2
    from lightgbm_tpu_torch.ops import grower as TG

    X, ys = _data()
    called = []
    monkeypatch.setattr(TG, "fused_hist_scan",
                        lambda *a, **k: called.append(1))
    b = tlgb.train(dict(_port_params(BYNODE_CASES["int8_ff1.0_fused"])),
                   tlgb.Dataset(X, label=ys["regression"]), 2,
                   keep_training_booster=True)
    learner = b._driver.learner
    assert learner.params.hist_impl == "fused"
    assert learner.params.feature_fraction_bynode == 0.5
    assert b.num_trees() == 2 and not called


@pytest.mark.parametrize("boosting", ["bynode", "goss"])
def test_hilo_binary_trees_agree(boosting):
    X, y = binary_data(n=2000, f=6, seed=0)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 31,
         "min_data_in_leaf": 20, "tpu_split_batch": 4,
         "tpu_hist_impl": "pallas2", "verbosity": -1}
    p.update({"bynode": {"feature_fraction_bynode": 0.5},
              "goss": {"boosting": "goss", "learning_rate": 0.34}}[boosting])
    rounds = 5
    bj = jlgb.train(dict(p), jlgb.Dataset(X, label=y), rounds,
                    keep_training_booster=True)
    bt = tlgb.train(dict(p, device_type="cpu"), tlgb.Dataset(X, label=y),
                    rounds, keep_training_booster=True)
    bj._driver._materialize()
    bt._driver._materialize()
    assert_trees_match(bj._driver.models, bt._driver.models)


@pytest.mark.parametrize("name", ["goss_fused", "goss_pallas2", "goss_fobj"])
def test_goss_text_byte_identical(port, jax_ref, name):
    assert _norm(port[name]["text"]) == _norm(str(jax_ref[name]["text"]))


def test_goss_row_mask_counts_equal_jax(jax_ref, monkeypatch):
    from lightgbm_tpu_torch.ops import grower as TG

    X, ys = _data()
    b = tlgb.Booster(dict(GOSS, device_type="cpu"), tlgb.Dataset(
        X, label=ys["regression"], params={"max_bin": GOSS["max_bin"]}))
    kept = []
    grow = TG.grow

    def spy(params, bins_t, g, h, mask, *rest):
        kept.append(float(mask.sum()))
        return grow(params, bins_t, g, h, mask, *rest)

    monkeypatch.setattr(TG, "grow", spy)
    for _ in range(ROUNDS):
        b.update()
    np.testing.assert_array_equal(kept, jax_ref["goss_kept"])
    # 1/0.25 = 4 full iterations, then about 0.2 + 0.8 * 0.125 of the rows
    assert kept[:4] == [N] * 4
    assert all(0.25 < k / N < 0.35 for k in kept[4:])


@pytest.mark.parametrize("name", list(DART_CASES) + ["rf"])
def test_dart_and_rf_text_curve_and_predict_equal(port, jax_ref, name):
    run = name if name == "rf" else "dart_" + name
    got, want = port[run], jax_ref[run]
    assert _norm(got["text"]) == _norm(str(want["text"]))
    assert json.loads(got["evals"]) == json.loads(str(want["evals"]))
    np.testing.assert_array_equal(got["raw"], want["raw"])
    if name == "rf":
        assert "\naverage_output\n" in got["text"]


def test_rf_model_loads_across_packages(port, jax_ref):
    X, _ = _data()
    # the JAX package's RF model in the port: its device predict
    bt = tlgb.Booster(model_str=str(jax_ref["rf"]["text"]),
                      params={"device_type": "cpu"})
    assert bt._driver.average_output
    np.testing.assert_array_equal(bt.predict(X[N_TRAIN:], raw_score=True),
                                  jax_ref["rf"]["raw"])
    # the port's RF model in the JAX package, on its device path
    np.testing.assert_array_equal(jax_ref["rf_port_text_raw"],
                                  port["rf"]["raw"])
