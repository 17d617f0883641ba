"""What predict of lightgbm_tpu_torch checks before it walks the trees:
the feature count (with predict_disable_shape_check), and the predict
routes and keywords it does not honor yet, refused by name
(tpu_predict_device=false at train, at load and at predict; pred_leaf,
pred_contrib, pred_early_stop*).  The model is one JAX-trained text
loaded by both packages, so their raw scores compare exactly; the JAX
side predicts on its device path (tpu_predict_device=true), the f32
walk the port makes."""

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from .test_torch_util import binary_data

CPU = {"device_type": "cpu", "verbosity": -1}
SMALL = {"objective": "binary", "num_leaves": 7, "max_bin": 15,
         "min_data_in_leaf": 10, "tpu_pack_bins": False}
N_FEAT = 6


@pytest.fixture(scope="module")
def model():
    X, y = binary_data(n=1500, f=N_FEAT, seed=4)
    bj = jlgb.train(dict(SMALL, verbosity=-1), jlgb.Dataset(X, label=y),
                    num_boost_round=4)
    return X, bj.model_to_string()


def _cols(X, ncols, layout):
    """X cut to ncols columns, or widened with seeded extra columns;
    dense or CSR."""
    if ncols <= X.shape[1]:
        out = X[:, :ncols]
    else:
        extra = np.random.default_rng(9).normal(
            size=(X.shape[0], ncols - X.shape[1]))
        out = np.concatenate([X, extra], axis=1)
    return sp.csr_matrix(np.nan_to_num(out)) if layout == "csr" else out


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("layout", ["dense", "csr"])
@pytest.mark.parametrize("ncols", [N_FEAT - 2, N_FEAT + 2])
def test_feature_count_mismatch_raises_the_jax_error(model, layout, ncols):
    X, text = model
    Xc = _cols(X[:200], ncols, layout)
    bj = jlgb.Booster(model_str=text)
    bt = tlgb.Booster(model_str=text, params=CPU)
    got = _raised(lambda: bt.predict(Xc))
    assert got == _raised(lambda: bj.predict(Xc))
    assert got[0] == "LightGBMError" and f"data ({ncols})" in got[1]


@pytest.mark.parametrize("given", ["parameter", "keyword"])
@pytest.mark.parametrize("layout", ["dense", "csr"])
@pytest.mark.parametrize("ncols", [N_FEAT - 2, N_FEAT + 2])
def test_disabled_shape_check_pads_and_drops_as_jax(model, given, layout,
                                                    ncols):
    X, text = model
    Xc = _cols(X[:300], ncols, layout)
    flag = {"predict_disable_shape_check": True}
    params, kw = (flag, {}) if given == "parameter" else ({}, flag)
    bj = jlgb.Booster(model_str=text, params=params or None)
    bt = tlgb.Booster(model_str=text, params=dict(CPU, **params))
    want = bj.predict(Xc, raw_score=True, tpu_predict_device=True, **kw)
    got = bt.predict(Xc, raw_score=True, **kw)
    np.testing.assert_array_equal(got, want)
    # missing trailing columns predict as NaN, extra ones are dropped
    dense = Xc.toarray() if layout == "csr" else Xc
    full = np.full((dense.shape[0], N_FEAT), np.nan)
    full[:, :min(ncols, N_FEAT)] = dense[:, :N_FEAT]
    np.testing.assert_array_equal(got, bt.predict(full, raw_score=True))


def test_training_parameter_disables_the_shape_check():
    X, y = binary_data(n=600, f=N_FEAT, seed=6)
    bt = tlgb.train(dict(SMALL, **CPU, predict_disable_shape_check=True),
                    tlgb.Dataset(X, label=y), num_boost_round=2)
    few = X[:, :N_FEAT - 1]
    padded = np.concatenate([few, np.full((len(X), 1), np.nan)], axis=1)
    np.testing.assert_array_equal(bt.predict(few), bt.predict(padded))
    np.testing.assert_array_equal(bt.predict(np.c_[X, X[:, :2]]),
                                  bt.predict(X))
    # the keyword overrides the parameter
    with pytest.raises(tlgb.LightGBMError, match=r"data \(5\)"):
        bt.predict(few, predict_disable_shape_check=False)


@pytest.mark.parametrize("value", [False, "false"])
def test_host_predict_is_refused_at_train(value):
    X, y = binary_data(n=300, f=3, seed=1)
    with pytest.raises(NotImplementedError,
                       match="tpu_predict_device=false .*training"):
        tlgb.train(dict(SMALL, **CPU, tpu_predict_device=value),
                   tlgb.Dataset(X, label=y), num_boost_round=1)


def test_host_predict_is_refused_at_load(model):
    X, text = model
    y = (X[:, 0] > 0).astype(float)
    bj = jlgb.train(dict(SMALL, verbosity=-1, tpu_predict_device="false"),
                    jlgb.Dataset(X, label=y), num_boost_round=2)
    pinned = bj.model_to_string()
    assert "[tpu_predict_device: false]" in pinned
    with pytest.raises(NotImplementedError,
                       match="tpu_predict_device=false .*model text"):
        tlgb.Booster(model_str=pinned, params=CPU)
    with pytest.raises(NotImplementedError,
                       match="tpu_predict_device=false .*loading Booster"):
        tlgb.Booster(model_str=text,
                     params=dict(CPU, tpu_predict_device=False))


def test_host_predict_is_refused_as_a_keyword(model):
    X, text = model
    bt = tlgb.Booster(model_str=text, params=CPU)
    for value in (False, "false", "0"):
        with pytest.raises(NotImplementedError,
                           match="tpu_predict_device=false .*keyword"):
            bt.predict(X[:10], tpu_predict_device=value)
    # auto and true are the device walk the port always makes
    want = bt.predict(X[:50])
    for value in ("auto", True, "true"):
        np.testing.assert_array_equal(
            bt.predict(X[:50], tpu_predict_device=value), want)


@pytest.mark.parametrize("kw", [
    {"pred_leaf": True}, {"pred_contrib": True}, {"pred_early_stop": True},
    {"pred_early_stop_freq": 5}, {"pred_early_stop_margin": 2.0},
    {"num_threads": 2}], ids=lambda d: next(iter(d)))
def test_unhonored_predict_keywords_raise_by_name(model, kw):
    X, text = model
    bt = tlgb.Booster(model_str=text, params=CPU)
    (name, _), = kw.items()
    with pytest.raises(NotImplementedError, match=f"predict\\({name}="):
        bt.predict(X[:10], **kw)
    # their defaults leave predict as it is
    np.testing.assert_array_equal(
        bt.predict(X[:10], pred_leaf=False, pred_contrib=False,
                   pred_early_stop=False, pred_early_stop_freq=10,
                   pred_early_stop_margin=10.0),
        bt.predict(X[:10]))
