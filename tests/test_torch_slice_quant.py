"""The quantized slice end to end, lightgbm_tpu_torch against lightgbm_tpu.

The shape of the JAX package's own fused-growth gate
(tests/test_fused_grow.py): 4,096 rows x 10 features, 15 leaves, 63
bins, 512-row blocks, 5 iterations.  Both packages run
tpu_hist_impl=fused (the grow megakernel; the port's twin on the CPU):
the JAX package in interpret mode, in a process compiled without FMA
(see tests/test_torch_util.py).

- objective=regression: integer histograms and exact gradients (score -
  label), so the whole model text is byte-identical (the trees, the
  parameters apart from device_type, and the tpu_bin_mappers: and
  tpu_feature_profile: trailers), int8 and int16 with the leaf refit
  off, and int8 with it on (the refit adds each leaf's rows in row
  order, as XLA:CPU's scatter does);
- objective=binary with the leaf refit on (the default): the binary
  gradients may differ from XLA's in the last ulps (exp), so the
  refitted leaf values, and the raw scores, are held to a tolerance;
- the threefry key stream ends where the JAX package's does;
- tpu_hist_impl=pallas (kernel B4's twin on the CPU) and fused grow the
  same trees as pallas2; models load in the other package.
"""

import re

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from .test_torch_util import run_jax_nofma

ROUNDS = 5
BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 5,
        "verbosity": -1, "tpu_block_rows": 512}
RUNS = [("regression", "int8", False), ("regression", "int16", False),
        ("binary", "int8", True), ("regression", "int8", True)]
# binary, refit on: |port - JAX| raw score, relative to the largest |score|
SCORE_RTOL = 1e-5


def _data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(4096, 10))
    X[rng.random(X.shape) < 0.02] = np.nan
    Xn = np.nan_to_num(X)
    signal = Xn[:, 0] + 0.5 * Xn[:, 1] * Xn[:, 2]
    y_reg = signal + 0.3 * rng.normal(size=4096)
    y_bin = (signal + 0.3 * rng.normal(size=4096) > 0).astype(np.float64)
    return X, {"regression": y_reg, "binary": y_bin}


def _params(objective, precision, refit, impl):
    return dict(BASE, objective=objective, tpu_hist_precision=precision,
                tpu_quant_refit_leaves=refit, tpu_hist_impl=impl)


def _trees(text):
    return text.split("\nparameters:")[0]


def _text(text):
    """The whole model text, with the one parameter line that names the
    device (the port's "cpu", the JAX package's default) normalized."""
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    X, ys = _data()
    runs = [dict(_params(o, p, r, "fused"), label=o) for o, p, r in RUNS]
    out = run_jax_nofma("train", {"X": X, **{"y_" + k: v
                                             for k, v in ys.items()}},
                        {"runs": runs, "rounds": ROUNDS,
                         "device_predict_iterations": [ROUNDS]},
                        tmp_path_factory.mktemp("train"))
    return X, ys, out


@pytest.fixture(scope="module")
def port_runs():
    X, ys = _data()
    return [tlgb.train(dict(_params(o, p, r, "fused"), device_type="cpu"),
                       tlgb.Dataset(X, label=ys[o]), num_boost_round=ROUNDS,
                       keep_training_booster=True)
            for o, p, r in RUNS]


@pytest.mark.parametrize("c", [0, 1], ids=["int8", "int16"])
def test_regression_model_text_byte_identical(jax_ref, port_runs, c):
    _, _, out = jax_ref
    bt = port_runs[c]
    assert bt._driver.learner.params.hist_impl == "fused"
    assert not bt._driver.learner.refits_leaves
    text = bt.model_to_string()
    assert "\ntpu_feature_profile:" in text
    assert _text(text) == _text(str(out[f"{c}_text"]))


def test_regression_refit_model_text_byte_identical(jax_ref, port_runs):
    _, _, out = jax_ref
    bt = port_runs[3]
    assert bt._driver.learner.refits_leaves
    assert _text(bt.model_to_string()) == _text(str(out["3_text"]))


def test_binary_refit_scores_within_tolerance(jax_ref, port_runs):
    X, _, out = jax_ref
    bt = port_runs[2]
    assert bt._driver.learner.refits_leaves
    got = bt.predict(X, raw_score=True)
    ref = out["2_raw"]
    assert np.abs(got - ref).max() <= SCORE_RTOL * np.abs(ref).max()


@pytest.mark.parametrize("c", range(len(RUNS)))
def test_key_stream_ends_where_jax_does(jax_ref, port_runs, c):
    _, _, out = jax_ref
    port_runs[c].num_trees()
    np.testing.assert_array_equal(port_runs[c]._driver._key, out[f"{c}_key"])


@pytest.mark.parametrize("impl", ["pallas", "pallas2"])
@pytest.mark.parametrize("precision", ["int8", "hilo"])
def test_histogram_impls_grow_the_same_trees(port_runs, impl, precision):
    X, ys = _data()
    p = dict(_params("regression", precision, False, impl),
             device_type="cpu")
    b = tlgb.train(p, tlgb.Dataset(X, label=ys["regression"]),
                   num_boost_round=ROUNDS, keep_training_booster=True)
    assert b._driver.learner.params.hist_impl == impl
    ref = (port_runs[0] if precision == "int8" else
           tlgb.train(dict(p, tpu_hist_impl="auto"),
                      tlgb.Dataset(X, label=ys["regression"]),
                      num_boost_round=ROUNDS))
    assert _trees(b.model_to_string()) == _trees(ref.model_to_string())


def test_auto_resolution_and_blocks():
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.learner import TreeLearner

    def resolve(**kw):
        return TreeLearner._resolve_hist_impl(Config(kw),
                                              kw["tpu_hist_precision"], 255)

    assert resolve(tpu_hist_precision="int8") == ("fused", 8192)
    assert resolve(tpu_hist_precision="int16") == ("fused", 8192)
    assert resolve(tpu_hist_precision="hilo") == ("pallas2", 8192)
    assert resolve(tpu_hist_precision="hilo",
                   tpu_hist_impl="pallas") == ("pallas", 256)
    assert resolve(tpu_hist_precision="f32",
                   tpu_hist_impl="xla") == ("xla", 16384)


def test_models_cross_load(jax_ref, port_runs):
    X, _, out = jax_ref
    # the port's int8 model in the JAX package, and the JAX one in the port
    bt = port_runs[2]
    bj = jlgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(bj.predict(X, raw_score=True),
                               bt.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    # the JAX model in the port predicts equal to the JAX package's own
    # device predict (f32 sums over trees in XLA's order)
    back = tlgb.Booster(model_str=str(out["2_text"]),
                        params={"device_type": "cpu"})
    np.testing.assert_array_equal(back.predict(X, raw_score=True),
                                  out[f"2_device_raw_{ROUNDS}"])
