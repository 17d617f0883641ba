"""Sparse train-time storage (tpu_sparse_threshold) of lightgbm_tpu_torch
against lightgbm_tpu (tests/test_sparse_storage.py's cases).

The features whose share of rows off their zero bin is at most the
threshold keep only those rows' (row, bin) entries; their histograms are
torch ops over the entries, their zero bins are rebuilt from a dense
feature's totals, and the partition rebuilds a sparse split feature's
column from its entries.  Seeded data: tests/test_sparse_storage.py's
problem (4,000 rows, four dense normal columns and eight columns with 3%
nonzero rows) and its categorical table.  The JAX package trains in two
processes compiled without FMA (tests/test_torch_util.py: job
"sparse_storage"), the deterministic (x64) runs in one of them, started
before the port trains beside them.  The objective is regression, whose
gradients are exact in both packages (binary's `exp` differs in the last
ulp, which can flip a tied default direction).

- deterministic=true: the port's sparse text equals its dense text
  (select and vselect), as the JAX package's does; its f64 trees match
  the JAX package's sparse run within F64_RTOL; also with bagging and
  row weights; and with a categorical sparse column (port only: the JAX
  package's categorical search raises a TypeError under
  deterministic=true, dense or sparse);
- hilo: trees within FLOAT_RTOL of the JAX package's sparse run, the
  categorical sparse column too;
- the refusals (int8, enable_bundle=true, forced splits, the kernel
  partition) raise the JAX package's class and text.
"""

import json

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import grower as TG

from .test_torch_util import (assert_trees_match, sparse_storage_run,
                              start_jax_nofma)

CPU = {"device_type": "cpu"}
BASE = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 5, "verbosity": -1, "enable_bundle": False,
        "tpu_shape_buckets": 0, "tpu_hist_impl": "xla"}
ROUNDS = 4
F64_RTOL = 1e-12
FLOAT_RTOL = 1e-5
DET = dict(BASE, deterministic=True)
SP = {"tpu_sparse_threshold": 0.2}
# (name, run) of the deterministic runs (the x64 process)
F64_RUNS = {
    "det_dense": {"params": DET},
    "det_sparse": {"params": dict(DET, **SP)},
    "det_vsel": {"params": dict(DET, **SP, tpu_partition_impl="vselect")},
    "det_bag_dense": {"params": dict(DET, bagging_fraction=0.6,
                                     bagging_freq=1)},
    "det_bag": {"params": dict(DET, tpu_sparse_threshold=0.35,
                               bagging_fraction=0.6, bagging_freq=1)},
    "det_weights_dense": {"params": DET, "weight": True},
    "det_weights": {"params": dict(DET, tpu_sparse_threshold=0.35),
                    "weight": True},
    "det_cat_dense": {"params": DET, "data": "cat", "cat": [4, 5]},
    "det_cat": {"params": dict(DET, tpu_sparse_threshold=0.35),
                "data": "cat", "cat": [4, 5]},
}
FLOAT_RUNS = {
    "hilo_sparse": {"params": dict(BASE, **SP)},
    "hilo_vsel": {"params": dict(BASE, **SP, tpu_partition_impl="vselect")},
    "hilo_cat": {"params": dict(BASE, tpu_sparse_threshold=0.35),
                 "data": "cat", "cat": [4, 5]},
}


def _sparse_problem(n=4000, n_dense=4, n_sparse=8, density=0.03, seed=3):
    rng = np.random.default_rng(seed)
    F = n_dense + n_sparse
    X = np.zeros((n, F))
    X[:, :n_dense] = rng.normal(size=(n, n_dense))
    for f in range(n_dense, F):
        nz = rng.choice(n, size=max(4, int(n * density)), replace=False)
        X[nz, f] = rng.normal(size=len(nz)) + (f - F // 2) * 0.5
    y = (X[:, 0] + 2.0 * X[:, n_dense + 1] - 1.5 * X[:, F - 3]
         + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    w = np.random.default_rng(5).random(n) + 0.5
    return X, y, w


def _cat_problem():
    rng = np.random.default_rng(13)
    n = 3000
    X = np.zeros((n, 6))
    X[:, :3] = rng.normal(size=(n, 3))
    nz = rng.choice(n, size=200, replace=False)
    X[nz, 4] = rng.integers(1, 6, size=200)  # a sparse categorical column
    X[:, 5] = rng.integers(0, 4, size=n)     # a dense categorical one
    y = ((X[:, 0] > 0) ^ (X[:, 4] == 2)).astype(np.float64)
    return X, y, np.ones(n)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sparse_storage")
    arrays = {}
    for key, (X, y, w) in (("base", _sparse_problem()),
                           ("cat", _cat_problem())):
        arrays.update({f"X_{key}": X, f"y_{key}": y, f"w_{key}": w})
    jobs = []
    for j, runs in enumerate((F64_RUNS, FLOAT_RUNS)):
        d = tmp / f"jax{j}"
        d.mkdir()
        spec = {"runs": [dict(r, rounds=ROUNDS) for r in runs.values()]}
        jobs.append((list(runs), start_jax_nofma("sparse_storage", arrays,
                                                 spec, d)))
    port = {name: sparse_storage_run(tlgb, arrays, dict(run, rounds=ROUNDS))
            for name, run in {**F64_RUNS, **FLOAT_RUNS}.items()}
    ref = {}
    for names, job in jobs:
        got = job()
        for i, name in enumerate(names):
            ref[name] = {k[len(f"{i}_"):]: v for k, v in got.items()
                         if k.startswith(f"{i}_")}
    return port, ref


def _model(text):
    return str(text).split("\nparameters:")[0]


def _trees(text):
    """The trees of a model text, read by the port's loader for both
    packages' texts (the JAX loader leaves a categorical node's bitset
    index at 0, ROADMAP §C)."""
    return tlgb.Booster(model_str=str(text), params=CPU)._driver.models


@pytest.mark.parametrize("sparse,dense", [
    ("det_sparse", "det_dense"), ("det_vsel", "det_dense"),
    ("det_bag", "det_bag_dense"), ("det_weights", "det_weights_dense"),
    ("det_cat", "det_cat_dense")])
def test_f64_sparse_text_equals_dense(both, sparse, dense):
    port, ref = both
    assert port[sparse]["sparse_features"] > 0
    assert port[dense]["sparse_features"] == 0
    assert _model(port[sparse]["text"]) == _model(port[dense]["text"])
    if sparse == "det_cat":
        # the JAX package's categorical search fails under
        # deterministic=true, sparse storage or not (its sorted-CTR scan
        # carries f32 into an f64 body): the categorical column is held
        # to it under hilo (hilo_cat)
        assert str(ref[sparse]["error"]) == str(ref[dense]["error"]) \
            == "TypeError"
        return
    # as the JAX package's does
    assert _model(ref[sparse]["text"]) == _model(ref[dense]["text"])


@pytest.mark.parametrize("name", [k for k in F64_RUNS
                                  if not k.startswith("det_cat")])
def test_f64_trees_match(both, name):
    port, ref = both
    assert port[name]["sparse_features"] == int(ref[name]["sparse_features"])
    assert_trees_match(_trees(ref[name]["text"]),
                       _trees(port[name]["text"]), rtol=F64_RTOL)


@pytest.mark.parametrize("name", list(FLOAT_RUNS))
def test_hilo_trees_match(both, name):
    port, ref = both
    assert port[name]["sparse_features"] == int(ref[name]["sparse_features"])
    assert port[name]["sparse_features"] > 0
    assert_trees_match(_trees(ref[name]["text"]),
                       _trees(port[name]["text"]), rtol=FLOAT_RTOL)
    np.testing.assert_allclose(port[name]["raw"], ref[name]["raw"],
                               rtol=1e-5, atol=1e-5)


def test_sparse_storage_layout():
    X, y, _ = _sparse_problem()
    p = dict(BASE, **SP, **CPU)
    b = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 1,
                   keep_training_booster=True)
    lr = b._driver.learner
    assert lr.params.has_sparse and lr.num_columns == 4
    assert list(lr.sparse["sparse_idx"]) == list(range(4, 12))
    meta = lr.meta
    bins = b._driver.train_data.bins_t
    # every stored entry is a row off its feature's zero bin, and every
    # such row is stored, in (feature, row) order
    off = meta["sp_off"].numpy()
    for s, f in enumerate(lr.sparse["sparse_idx"]):
        rows = meta["sp_rows"][off[s]:off[s + 1]].long()
        want = (bins[f] != lr.meta_np["default_bin"][f]).nonzero()[:, 0]
        assert rows.tolist() == want.tolist()
        keys = meta["sp_key"][off[s]:off[s + 1]].long()
        assert (keys - s * lr.num_bins).tolist() == bins[f][want].tolist()
    assert lr.sparse["window"] == int(np.diff(off).max())


def test_sparse_histograms_match_the_dense_ones():
    """The merged histograms with the zero bins rebuilt equal the dense
    histograms of every feature (f64: bit for bit)."""
    import torch

    X, y, _ = _sparse_problem(n=1000)
    p = dict(DET, **SP, **CPU)
    b = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 1,
                   keep_training_booster=True)
    lr = b._driver.learner
    bins = b._driver.train_data.bins_t
    n, n_pad = lr.n, lr.n_pad
    gen = np.random.default_rng(0)
    leaf = torch.as_tensor(gen.integers(0, 5, n_pad), dtype=torch.int32)
    g = torch.zeros(n_pad, dtype=torch.float64)
    h = torch.zeros(n_pad, dtype=torch.float64)
    mask = torch.zeros(n_pad, dtype=torch.float64)
    g[:n] = torch.as_tensor(gen.normal(size=n).astype(np.float32))
    h[:n] = torch.as_tensor(gen.random(n).astype(np.float32))
    mask[:n] = 1.0
    stats = torch.stack([g, h, mask])
    slots = torch.tensor([3, -1, 0, 4], dtype=torch.int32)
    sp_stats = stats[:, lr.meta["sp_rows"].long()].T.contiguous()
    dense_all = torch.zeros((lr.f_pad, n_pad), dtype=torch.uint8)
    dense_all[:lr.num_features, :n] = bins
    from lightgbm_tpu_torch.ops.histogram import build_histogram_batched_t

    want = build_histogram_batched_t(dense_all, stats, leaf, slots,
                                     lr.num_bins, "f64")
    have_d = build_histogram_batched_t(lr.bins_t, stats, leaf, slots,
                                       lr.num_bins, "f64")
    merged = TG.merged_histograms(have_d, lr.meta, sp_stats, leaf, slots,
                                  lr.num_bins, 15, "f64")
    full = TG.expand_sparse(merged, lr.meta)
    assert torch.equal(full[:, :lr.num_features], want[:, :lr.num_features])


def test_fixed_order_index_sum():
    """The f64 sparse histograms' sums: index_add_'s sums within
    rounding, and the same bits for every order of the entries that keeps
    each index's entries in their order (the order atomics cannot
    keep)."""
    import torch

    gen = np.random.default_rng(8)
    E, size = 5000, 300
    index = torch.as_tensor(gen.integers(0, size, E))
    values = torch.as_tensor(gen.normal(size=(E, 3)) * 10.0 ** gen.integers(
        -8, 8, (E, 1)))
    got = TG.fixed_order_index_sum(index, values, size)
    want = torch.zeros((size, 3), dtype=torch.float64).index_add_(
        0, index, values)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(values.abs().max()))
    # the entries regrouped, stably, by their index's rank in a random
    # permutation of the indices: each index keeps its entries' order
    rank = torch.as_tensor(gen.permutation(size))[index]
    order = torch.sort(rank, stable=True).indices
    again = TG.fixed_order_index_sum(index[order], values[order], size)
    assert torch.equal(got, again)


# ---- refusals ---------------------------------------------------------------

REFUSALS = [
    ({"tpu_hist_precision": "int8"}, ValueError, "quantized"),
    ({"tpu_hist_precision": "int16"}, ValueError, "quantized"),
    ({"enable_bundle": True}, ValueError, "enable_bundle"),
    ({"forcedsplits_filename": "forced"}, ValueError, "forced splits"),
    ({"tpu_partition_impl": "kernel"}, ValueError, "select-family"),
]


@pytest.mark.parametrize("extra,exc,match", REFUSALS,
                         ids=lambda v: ",".join(v) if isinstance(v, dict)
                         else None)
def test_refusals_match_the_jax_package(tmp_path, extra, exc, match):
    X, y, _ = _sparse_problem(n=512)
    if "forcedsplits_filename" in extra:
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({"feature": 0, "threshold": 0.0}))
        extra = {"forcedsplits_filename": str(path)}
    params = dict(BASE, **SP, **extra)
    with pytest.raises(exc, match=match) as want:
        jlgb.train(params, jlgb.Dataset(X, label=y), 1)
    with pytest.raises(exc) as got:
        tlgb.train(dict(params, **CPU), tlgb.Dataset(X, label=y), 1)
    assert str(got.value) == str(want.value)


def test_feature_parallel_refusal_matches_the_jax_text():
    """Sparse storage on a feature-sharded learner: with the devices
    for num_machines (the tests' eight CPU devices), the JAX learner
    raises its sparse-storage refusal (learner.py:319-322); the port,
    which refuses more machines than one, raises it first with the same
    class and text.  A row-sharded learner passes that check."""
    from lightgbm_tpu_torch.models.learner import check_sparse_storage

    X, y, _ = _sparse_problem(n=512)
    params = dict(BASE, **SP, tree_learner="feature", num_machines=4)
    with pytest.raises(NotImplementedError,
                       match="tree_learner=serial, data, or voting") as want:
        jlgb.train(params, jlgb.Dataset(X, label=y), 1)
    with pytest.raises(NotImplementedError) as got:
        tlgb.train(dict(params, **CPU), tlgb.Dataset(X, label=y), 1)
    assert str(got.value) == str(want.value)
    check_sparse_storage(tlgb.Config(dict(BASE, **SP)), "hilo", "data",
                         forced=False)


def test_grower_refuses_sparse_with_bundles_or_packing():
    p = TG.GrowerParams(num_leaves=4, num_bins=16, precision="hilo", l1=0.0,
                        l2=0.0, max_delta_step=0.0, min_data_in_leaf=1.0,
                        min_sum_hessian=0.0, min_gain_to_split=0.0,
                        max_depth=-1, has_sparse=True)
    TG.check_params(p)
    for bad in ({"has_bundles": True}, {"packed_bins": True},
                {"partition_impl": "kernel"}):
        with pytest.raises(ValueError, match="select-family"):
            TG.check_params(p._replace(**bad))
    with pytest.raises(ValueError, match="quantized"):
        TG.check_params(p._replace(precision="int8"))
