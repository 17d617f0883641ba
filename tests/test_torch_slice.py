"""The whole slice, lightgbm_tpu_torch against lightgbm_tpu, on the CPU.

One params dict drives both packages: binary objective, 2,000 rows x 6
features with NaNs, num_leaves=15, max_bin=31, tpu_split_batch=4 (so the
grower batches K=4 leaves a round), the frontier ramp, the perfeature
histogram (impl "pallas2", which the JAX package runs in interpret mode
here) and tpu_partition_impl=kernel, 5 iterations.  The port runs its
plain twins on the CPU (device_type="cpu"; the JAX package ignores it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models.objectives import create_objective as j_objective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.models.objectives import \
    create_objective as t_objective

from .test_torch_util import binary_data

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 31,
          "min_data_in_leaf": 20, "learning_rate": 0.1,
          "tpu_split_batch": 4, "tpu_hist_impl": "pallas2",
          "tpu_partition_impl": "kernel", "device_type": "cpu",
          "verbosity": -1}
ROUNDS = 5


@pytest.fixture(scope="module")
def trained():
    X, y = binary_data(n=2000, f=6, seed=0)
    dj, dt = jlgb.Dataset(X, label=y), tlgb.Dataset(X, label=y)
    bj = jlgb.train(dict(PARAMS), dj, num_boost_round=ROUNDS,
                    keep_training_booster=True)
    bt = tlgb.train(dict(PARAMS), dt, num_boost_round=ROUNDS,
                    keep_training_booster=True)
    bj.datasets = (dj._inner, dt._inner)
    return X, y, bj, bt


def _close(got, ref, rtol=1e-5):
    """|got - ref| <= rtol * max|ref|: leaf sums are differences of f32
    row sums, so their rounding scales with the largest sums in play,
    not with each (possibly near-zero) value."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


def test_bin_mappers_and_bins_equal(trained):
    _, _, bj, bt = trained
    tj, tt = bj.datasets
    assert tt.used_feature_idx == tj.used_feature_idx
    assert len(tt.mappers) == len(tj.mappers)
    for mt, mj in zip(tt.mappers, tj.mappers):
        dt, dj = mt.to_dict(), mj.to_dict()
        # the upper bounds end in NaN when NaN is a bin of its own
        np.testing.assert_array_equal(dt.pop("bin_upper_bound"),
                                      dj.pop("bin_upper_bound"))
        assert dt == dj
    np.testing.assert_array_equal(tt.bins, tj.bins)
    # the port does no EFB: the JAX package formed no bundles here either
    assert bj._driver.learner.bundle_plan is None


def test_layout_matches(trained):
    _, _, bj, bt = trained
    lj, lt = bj._driver.learner, bt._driver.learner
    assert (lt.n_pad, lt.f_pad) == (lj.n_pad, lj.f_pad)
    assert lt.params.split_batch == lj.params.split_batch == 4
    assert lj.params.hist_impl == "pallas2"
    assert lt.params.partition_impl == lj.params.partition_impl == "kernel"
    assert lt.params.ramp_step == lj.params.ramp_step


def test_trees_equal(trained):
    _, _, bj, bt = trained
    bj._driver._materialize()
    bt._driver._materialize()
    tj, tt = bj._driver.models, bt._driver.models
    assert len(tt) == len(tj) == ROUNDS
    for i, (a, b) in enumerate(zip(tj, tt)):
        assert b.num_leaves == a.num_leaves, i
        ni = a.num_leaves - 1
        for name in ("split_feature_inner", "split_feature",
                     "threshold_in_bin", "decision_type", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:ni],
                                          getattr(a, name)[:ni],
                                          err_msg=f"tree {i} {name}")
        np.testing.assert_array_equal(b.threshold[:ni], a.threshold[:ni])
        _close(b.leaf_value[:a.num_leaves], a.leaf_value[:a.num_leaves])
        np.testing.assert_array_equal(b.leaf_count[:a.num_leaves],
                                      a.leaf_count[:a.num_leaves])


def test_predictions_equal(trained):
    X, _, bj, bt = trained
    _close(bt.predict(X, raw_score=True), bj.predict(X, raw_score=True))
    _close(bt.predict(X), bj.predict(X))


def test_model_text_round_trip(trained):
    X, _, _, bt = trained
    text = bt.model_to_string()
    assert "tpu_bin_mappers:" in text
    again = tlgb.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), bt.predict(X))
    assert again.model_to_string().split("end of trees")[0] == \
        text.split("end of trees")[0]


@pytest.mark.parametrize("impl", ["select", "vselect"])
def test_partition_lowerings_grow_the_same_trees(trained, impl):
    # the whole model text, trailers included, apart from the parameter
    # line that names the lowering
    X, y, _, bt = trained
    b = tlgb.train(dict(PARAMS, tpu_partition_impl=impl),
                   tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                   keep_training_booster=True)
    text = b.model_to_string()
    assert f"[tpu_partition_impl: {impl}]" in text
    assert text.replace(f"[tpu_partition_impl: {impl}]",
                        "[tpu_partition_impl: kernel]") == \
        bt.model_to_string()


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_gradients_within_two_ulps(objective):
    # the port computes exp with torch, the JAX package with XLA: the two
    # may differ in the last ulp.  The gradient (the logistic response r)
    # stays within 2 ulps; the hessian |r| (sigmoid - |r|) cancels as |r|
    # nears the sigmoid, so it is held to 2 ulps of itself plus the
    # 2-ulp difference of r it inherits
    rng = np.random.default_rng(2)
    n = 4096
    label = (rng.random(n) > 0.4).astype(np.float32)
    if objective == "regression":
        label = rng.normal(size=n).astype(np.float32)
    score = (rng.normal(size=(1, n)) * 3).astype(np.float32)
    params = {"objective": objective}
    oj = j_objective(jlgb.Config(params))
    oj.init(jlgb.basic.Metadata(n, label), n)
    gj, hj = (np.asarray(v) for v in oj.get_gradients(jnp.asarray(score)))
    ot = t_objective(TConfig(params))
    ot.init(TMetadata(n, label), n, torch.device("cpu"))
    gt, ht = (v.numpy() for v in ot.get_gradients(torch.from_numpy(score)))
    def ulp(v):
        return np.spacing(np.abs(v).astype(np.float32))

    assert (np.abs(gt - gj) <= 2 * ulp(gj)).all()
    assert (np.abs(ht - hj) <= 2 * ulp(hj) + 2 * ulp(gj)).all()
    assert ot.boost_from_score(0) == oj.boost_from_score(0)
