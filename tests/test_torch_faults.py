"""Where lightgbm_tpu_torch once gave another result than lightgbm_tpu,
on the CPU: an unported objective on load, the `tpu_feature_profile:`
trailer, the order of the sum over trees in device predict, and the
order of the leaf refit's per-leaf sums.  (The refit-on model text is
also held in tests/test_torch_slice_quant.py, and the refit's kernel on
the card in tests/test_torch_kernels_cuda.py.)"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops.predict import sum_trees

from .test_torch_util import binary_data, run_jax_nofma

CPU = {"device_type": "cpu"}
SMALL = {"objective": "binary", "num_leaves": 7, "max_bin": 15,
         "min_data_in_leaf": 10, "verbosity": -1}


def _count_data(n=1500, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    y = rng.poisson(np.exp(0.4 * X[:, 0] - 0.3 * X[:, 1])).astype(np.float64)
    return X, y


def test_unported_objective_refuses_converted_predict():
    X, y = _count_data()
    bj = jlgb.train(dict(SMALL, objective="poisson", tpu_hist_impl="xla"),
                    jlgb.Dataset(X, label=y), num_boost_round=5)
    bt = tlgb.Booster(model_str=bj.model_to_string(), params=CPU)
    with pytest.raises(NotImplementedError, match="poisson"):
        bt.predict(X)
    # the raw scores are the JAX package's device predict, bit for bit
    np.testing.assert_array_equal(
        bt.predict(X, raw_score=True),
        bj.predict(X, raw_score=True, tpu_predict_device="true"))


def test_profile_trailer_written_and_round_trips():
    X, y = binary_data(n=1200, f=4, seed=9)
    bt = tlgb.train(dict(SMALL, **CPU), tlgb.Dataset(X, label=y),
                    num_boost_round=3)
    text = bt.model_to_string()
    lines = [l for l in text.splitlines()
             if l.startswith("tpu_feature_profile:")]
    assert len(lines) == 1
    again = tlgb.Booster(model_str=text, params=CPU)
    assert [l for l in again.model_to_string().splitlines()
            if l.startswith("tpu_feature_profile:")] == lines
    # the JAX package reads the port's trailer as its own
    bj = jlgb.Booster(model_str=text)
    assert bj._driver.health_profile().to_line() == lines[0] + "\n"


def test_profile_capture_off_writes_no_trailer():
    X, y = binary_data(n=1200, f=4, seed=9)
    bt = tlgb.train(dict(SMALL, **CPU, tpu_profile_capture=False),
                    tlgb.Dataset(X, label=y), num_boost_round=2)
    assert "tpu_feature_profile:" not in bt.model_to_string()
    assert "tpu_bin_mappers:" in bt.model_to_string()


@pytest.mark.parametrize("trees", [1, 5, 19, 32, 33, 200, 1100])
def test_sum_trees_takes_xlas_window_order(trees):
    # XLA:CPU's f32 sum over axis 0: in sequence up to 32 terms, past that
    # zero-padded windows of 32 (half the padding in front), recursively
    rng = np.random.default_rng(trees)
    v = (rng.normal(size=(trees, 257))
         * rng.random((trees, 1)) * 10).astype(np.float32)

    def seq(a):
        acc = np.zeros(a.shape[1:], np.float32)
        for row in a:
            acc = acc + row
        return acc

    ref = v
    while ref.shape[0] > 32:
        nb = -(-ref.shape[0] // 32)
        pad = nb * 32 - ref.shape[0]
        z = np.zeros((1,) + ref.shape[1:], np.float32)
        ref = np.concatenate([z.repeat(pad // 2, 0), ref,
                              z.repeat(pad - pad // 2, 0)])
        ref = np.stack([seq(w) for w in ref.reshape(nb, 32, -1)])
    np.testing.assert_array_equal(sum_trees(torch.from_numpy(v)).numpy(),
                                  seq(ref))


@pytest.fixture(scope="module")
def jax_forest(tmp_path_factory):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(3000, 6))
    y = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=3000)
    run = {"objective": "regression", "num_leaves": 15, "max_bin": 255,
           "min_data_in_leaf": 5, "tpu_hist_precision": "int8",
           "tpu_hist_impl": "xla", "verbosity": -1, "label": "reg"}
    out = run_jax_nofma("train", {"X": X, "y_reg": y},
                        {"runs": [run], "rounds": 200,
                         "device_predict_iterations": [30, 200]},
                        tmp_path_factory.mktemp("forest"))
    return X, out


@pytest.mark.parametrize("trees", [30, 200])
def test_device_predict_equals_jax_device_predict(jax_forest, trees):
    # an int8 model of the JAX package, loaded into the port, predicts
    # equal to the JAX package's jitted device predict (compiled without
    # FMA, as every bitwise gate here: on an AVX-512 host XLA vectorizes
    # the in-fusion sum of 19-32 trees into 8 lanes, a host-dependent
    # order)
    X, out = jax_forest
    bt = tlgb.Booster(model_str=str(out["0_text"]), params=CPU)
    assert bt.num_trees() == 200
    np.testing.assert_array_equal(
        bt.predict(X, raw_score=True, num_iteration=trees),
        out[f"0_device_raw_{trees}"])


def test_leaf_sums_twin_adds_in_row_order_as_xla():
    # the leaf refit's per-leaf sums: the twin (index_add_ on the CPU),
    # XLA:CPU's scatter-add and the card kernel's walk (a stable sort of
    # the leaf ids, then each leaf's rows in order from 0) agree bitwise
    import jax
    import jax.numpy as jnp

    from lightgbm_tpu_torch.ops.leafsum import leaf_sums, leaf_sums_plain

    rng = np.random.default_rng(13)
    n, L = 50_000, 64
    ids = rng.integers(0, L - 2, size=n).astype(np.int32)
    ids[rng.random(n) < 0.5] = 3
    vals = np.stack([rng.normal(size=n) * 3, rng.random(n)]).astype(
        np.float32)
    got = leaf_sums_plain(torch.from_numpy(ids), torch.from_numpy(vals), L)
    assert torch.equal(got, leaf_sums(torch.from_numpy(ids),
                                      torch.from_numpy(vals), L))
    scatter = jax.jit(lambda i, v: jnp.zeros(L, jnp.float32).at[i].add(v))
    for v in range(2):
        np.testing.assert_array_equal(
            got[v].numpy(), np.asarray(scatter(ids, vals[v])))
    order = np.argsort(ids, kind="stable")
    starts = np.searchsorted(ids[order], np.arange(L + 1))
    walk = np.zeros((2, L), np.float32)
    for v in range(2):
        sv = vals[v][order]
        for leaf in range(L):
            acc = np.float32(0.0)
            for x in sv[starts[leaf]:starts[leaf + 1]]:
                acc = np.float32(acc + x)
            walk[v, leaf] = acc
    np.testing.assert_array_equal(got.numpy(), walk)
