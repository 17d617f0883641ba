"""What predict of lightgbm_tpu_torch checks before it walks the trees,
and where it walks them: the feature count (with
predict_disable_shape_check); tpu_predict_device=false at train, at load
and at predict, and the keywords pred_leaf, pred_contrib and
pred_early_stop*, which take the raw-value walker as the JAX package
takes its f64 host walker; other keywords raise by name.  The model is
one JAX-trained text loaded by both packages, so their raw scores
compare exactly; the JAX side predicts on its device path
(tpu_predict_device=true) where the port makes its f32 bin-space walk,
and on its host walker where the port takes the raw-value walker."""

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
    """Once refused; now trained, and its predict is the raw-value walk,
    the JAX package's host walker on the same text."""
    X, y = binary_data(n=300, f=3, seed=1)
    bt = tlgb.train(dict(SMALL, **CPU, tpu_predict_device=value),
                    tlgb.Dataset(X, label=y), num_boost_round=2)
    text = bt.model_to_string()
    assert bt._driver.host_predict()
    want = jlgb.Booster(model_str=text).predict(X, raw_score=True,
                                                tpu_predict_device=False)
    np.testing.assert_array_equal(bt.predict(X, raw_score=True), want)


def test_host_predict_is_refused_at_load(model):
    """Once refused; now a text whose parameters say
    tpu_predict_device=false, or a loading Booster's parameter, takes
    the raw-value walker: the JAX package's host walker."""
    X, text = model
    y = (X[:, 0] > 0).astype(float)
    bj = jlgb.train(dict(SMALL, verbosity=-1, tpu_predict_device="false"),
                    jlgb.Dataset(X, label=y), num_boost_round=2)
    pinned = bj.model_to_string()
    assert "[tpu_predict_device: false]" in pinned
    np.testing.assert_array_equal(
        tlgb.Booster(model_str=pinned, params=CPU).predict(X,
                                                           raw_score=True),
        bj.predict(X, raw_score=True))
    want = jlgb.Booster(model_str=text).predict(X, raw_score=True,
                                                tpu_predict_device=False)
    np.testing.assert_array_equal(
        tlgb.Booster(model_str=text,
                     params=dict(CPU, tpu_predict_device=False)).predict(
                         X, raw_score=True), want)


def test_host_predict_is_refused_as_a_keyword(model):
    """Once refused; now the keyword false takes the raw-value walker
    (the JAX host walker's scores), auto and true the device walk."""
    X, text = model
    bt = tlgb.Booster(model_str=text, params=CPU)
    host = jlgb.Booster(model_str=text).predict(X, raw_score=True,
                                                tpu_predict_device=False)
    for value in (False, "false", "0"):
        np.testing.assert_array_equal(
            bt.predict(X, raw_score=True, tpu_predict_device=value), host)
    want = bt.predict(X[:50])
    for value in ("auto", True, "true"):
        np.testing.assert_array_equal(
            bt.predict(X[:50], tpu_predict_device=value), want)


@pytest.mark.parametrize("kw", [
    {"pred_leaf": True}, {"pred_contrib": True}, {"pred_early_stop": True},
    {"pred_early_stop_freq": 5}, {"pred_early_stop_margin": 2.0},
    {"num_threads": 2}], ids=lambda d: next(iter(d)))
def test_unhonored_predict_keywords_raise_by_name(model, kw):
    """num_threads raises by name; the JAX package's keywords, once
    refused, now predict as its predict does: pred_leaf, pred_contrib
    and pred_early_stop on its host walker, the freq and margin alone
    changing nothing."""
    X, text = model
    bt = tlgb.Booster(model_str=text, params=CPU)
    (name, _), = kw.items()
    if name == "num_threads":
        with pytest.raises(NotImplementedError, match=f"predict\\({name}="):
            bt.predict(X[:10], **kw)
    else:
        host = name in ("pred_leaf", "pred_contrib", "pred_early_stop")
        want = jlgb.Booster(model_str=text).predict(
            X[:200], tpu_predict_device=not host, **kw)
        np.testing.assert_array_equal(bt.predict(X[:200], **kw), want)
    # their defaults leave predict as it is
    np.testing.assert_array_equal(
        bt.predict(X[:10], pred_leaf=False, pred_contrib=False,
                   pred_early_stop=False, pred_early_stop_freq=10,
                   pred_early_stop_margin=10.0),
        bt.predict(X[:10]))
