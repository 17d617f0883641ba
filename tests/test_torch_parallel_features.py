"""The sharded tree learners of lightgbm_tpu_torch with the features they
once refused, against lightgbm_tpu: monotone constraints,
feature_fraction_bynode, CEGB (coupled and split penalties), categorical
features, forced splits, deterministic=true and sparse COO storage under
tree_learner data, feature, voting and data_feature, in one process.

The contract, as tests/test_torch_parallel.py holds the plain grid:

* int8: model text byte-identical to the JAX package's at the same grid,
  and, where the JAX package gives its serial text (data, data_feature,
  and feature but with per-node sampling, whose masks are drawn over
  the grid's padded width), the port's serial text;
* hilo: `assert_trees_match` against the JAX trees, train AUC within
  1e-4;
* f64 (deterministic=true): text equal to the JAX package's and to the
  port's serial f64 text;
* every tree starts with the forced splits; no prediction of a monotone
  case breaks its constraints along a grid; each shard's CEGB state is
  its own tensor and agrees with every other shard's after every tree;
* what the JAX learner still refuses, the port refuses with the same
  exception and text.

Every JAX run of this file is one job (tests/test_torch_util.py:
sharded_run, job "train_sharded"), started before the port's runs.  The
port places its shards on the CPU (device_type=cpu).
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from .test_torch_parallel import (HILO, INT8, ROUNDS, _learner, _problem,
                                  check_trees_match, grid_cases, run_grid)

F64 = dict(INT8, tpu_hist_precision="f32", deterministic=True)
CAT = dict(INT8, tpu_partition_impl="select")
# columns 3 (three categories: the one-hot mode) and 4 (twelve: sorted
# CTR) of the "cat" data
CAT_COLS = [3, 4]
MONO = [1, 1, -1] + [0] * 7
BYNODE = {"feature_fraction_bynode": 0.5}
CEGB = {"cegb_penalty_split": 0.002,
        "cegb_penalty_feature_coupled": [30.0] * 10}
SPARSE = {"tpu_sparse_threshold": 0.1, "enable_bundle": False}
# the root on column 0 at 0.0, its children on columns 1 and 2
FORCED_TREE = {"feature": 0, "threshold": 0.0,
               "left": {"feature": 1, "threshold": 0.0},
               "right": {"feature": 2, "threshold": 0.0}}
FORCED_HEAD = [0, 1, 2]
# filled in with the forced splits' JSON file by the module fixture
FORCED = {"forcedsplits_filename": None}


def _mono(**kw):
    return dict(INT8, monotone_constraints=MONO, **kw)


# name -> (data, label, params, checks, run extras); checks: "jax" the
# JAX package's text, "serial" the port's serial text, "trees"
# assert_trees_match + AUC, and each feature's own ("mono", "forced").
# The f64 runs come last: the JAX learner turns x64 on for its process
GRID = {
    "mono_data2_int8": ("a", "reg", _mono(**_learner("data", 2)),
                        ("jax", "serial", "mono")),
    "mono_feature2_int8": ("a", "reg", _mono(**_learner("feature", 2)),
                           ("jax", "serial", "mono")),
    "mono_voting2_int8": ("a", "reg", _mono(**_learner("voting", 2)),
                          ("jax", "mono")),
    "bynode_data2_int8": ("a", "reg", dict(INT8, **BYNODE,
                                           **_learner("data", 2)),
                          ("jax", "serial")),
    "bynode_feature2_int8": ("a", "reg", dict(INT8, **BYNODE,
                                              **_learner("feature", 2)),
                             ("jax",)),
    "bynode_data_feature4_hosts2_int8": (
        "a", "reg", dict(INT8, **BYNODE, **_learner("data_feature", 4, 2)),
        ("jax",)),
    "cegb_data2_int8": ("a", "reg", dict(INT8, **CEGB,
                                         **_learner("data", 2)),
                        ("jax", "serial")),
    "cegb_voting2_int8": ("a", "reg", dict(INT8, **CEGB,
                                           **_learner("voting", 2)),
                          ("jax",)),
    "cat_data2_int8": ("cat", "cat", dict(CAT, **_learner("data", 2)),
                       ("jax", "serial"), {"cat": CAT_COLS}),
    "cat_feature2_int8": ("cat", "cat", dict(CAT, **_learner("feature", 2)),
                          ("jax", "serial"), {"cat": CAT_COLS}),
    "cat_voting2_int8": ("cat", "cat", dict(CAT, **_learner("voting", 2)),
                         ("jax",), {"cat": CAT_COLS}),
    "forced_data2_hilo": ("nan", "bin", dict(HILO, **FORCED,
                                             **_learner("data", 2)),
                          ("trees", "forced")),
    "forced_feature2_hilo": ("nan", "bin", dict(HILO, **FORCED,
                                                **_learner("feature", 2)),
                             ("trees", "forced")),
    # regression: the binary objective's gradients part from the JAX
    # package's in exp's last ulp from the second tree on, which flips a
    # default_left tie of this grid (a feature split before with its NaN
    # rows sent the other way); its first tree is byte-identical
    "sparse_data2_hilo": ("sp", "spreg", dict(HILO, **SPARSE,
                                              objective="regression",
                                              **_learner("data", 2)),
                          ("jax", "trees")),
    "sparse_voting2_hilo": ("sp", "spbin", dict(HILO, **SPARSE,
                                                **_learner("voting", 2)),
                            ("trees",)),
    "det_data2_f64": ("a", "reg", dict(F64, **_learner("data", 2)),
                      ("jax", "serial")),
    "det_data_feature4_f64": ("a", "reg", dict(F64, **_learner(
        "data_feature", 4)), ("jax", "serial")),
    # voting's vote adds the f64 local gains into f32 votes
    "det_voting2_f64": ("a", "reg", dict(F64, **_learner("voting", 2)),
                        ("jax",)),
    "sparse_data2_f64": ("sp", "spreg", dict(F64, **SPARSE,
                                             **_learner("data", 2)),
                         ("jax", "serial")),
}


def _inputs():
    """The data sets: "a" and "nan" as tests/test_torch_parallel.py's;
    "cat" with columns 3 and 4 as category codes that move the label;
    "sp" with columns 6-9 off zero in 4% of the rows (stored as COO at
    tpu_sparse_threshold=0.1) and NaNs in the dense columns."""
    X, yb, yr = _problem()
    n = X.shape[0]
    rng = np.random.default_rng(23)
    Xn = X.copy()
    Xn[np.random.default_rng(11).random(X.shape) < 0.05] = np.nan
    Xc = X.copy()
    Xc[:, 3] = rng.integers(0, 3, n)
    Xc[:, 4] = rng.integers(0, 12, n)
    effect = rng.normal(size=12)
    y_cat = yr + 0.8 * (Xc[:, 3] == 1) + effect[Xc[:, 4].astype(int)]
    Xs = X.copy()
    Xs[:, 6:] *= rng.random((n, 4)) < 0.04
    lat = Xs[:, 0] + 0.5 * Xs[:, 1] * Xs[:, 2] + 2.0 * Xs[:, 6:].sum(1)
    Xs[:, :6][rng.random((n, 6)) < 0.05] = np.nan
    return {"X_a": X, "y_bin": yb, "y_reg": yr, "X_nan": Xn, "X_cat": Xc,
            "y_cat": y_cat, "X_sp": Xs, "y_spbin": (lat > 0) * 1.0,
            "y_spreg": lat + 0.1 * rng.normal(size=n)}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    path = tmp_path_factory.mktemp("forced") / "forced.json"
    path.write_text(json.dumps(FORCED_TREE))
    cases = {k: (v[0], v[1], dict(v[2], forcedsplits_filename=str(path))
                 if "forcedsplits_filename" in v[2] else v[2]) + v[3:]
             for k, v in GRID.items()}
    port, jax, inp = run_grid(cases, tmp_path_factory, _inputs())
    return port, jax, inp, cases


@pytest.mark.parametrize("name", grid_cases(GRID, "jax"))
def test_text_equals_jax(grid, name):
    port, jax, _, _ = grid
    assert port[name]["text"] == str(jax[name]["text"])


@pytest.mark.parametrize("name", list(GRID))
def test_every_round_grows_a_tree(grid, name):
    port, _, _, _ = grid
    b = tlgb.Booster(model_str=port[name]["text"],
                     params={"device_type": "cpu"})
    assert b.num_trees() == ROUNDS
    assert all(t.num_leaves > 2 for t in b._driver.models)


@pytest.mark.parametrize("name", grid_cases(GRID, "serial"))
def test_text_equals_serial(grid, name):
    port, _, _, _ = grid
    assert port[name]["text"] == port[name]["serial"]


@pytest.mark.parametrize("name", grid_cases(GRID, "trees"))
def test_float_trees_match_jax(grid, name):
    port, jax, inp, cases = grid
    check_trees_match((port, jax, inp), cases, name)


@pytest.mark.parametrize("name", grid_cases(GRID, "forced"))
def test_every_tree_starts_with_the_forced_splits(grid, name):
    port, _, _, _ = grid
    b = tlgb.Booster(model_str=port[name]["text"],
                     params={"device_type": "cpu"})
    for tree in b._driver.models:
        assert [int(f) for f in tree.split_feature[:3]] == FORCED_HEAD
        assert np.allclose(tree.threshold[:3], 0.0, atol=0.1)


@pytest.mark.parametrize("name", grid_cases(GRID, "mono"))
def test_monotone_predictions_on_a_grid(grid, name):
    """chip_smoke.py's mono check at small size: the predictions of 100
    rows along 16 values of each constrained column never move against
    its constraint."""
    port, _, inp, _ = grid
    b = tlgb.Booster(model_str=port[name]["text"],
                     params={"device_type": "cpu"})
    rows = inp["X_a"][:100]
    values = np.linspace(-3.0, 3.0, 16)
    for j, c in enumerate(MONO):
        if not c:
            continue
        probe = np.repeat(rows, len(values), axis=0)
        probe[:, j] = np.tile(values, len(rows))
        pred = b.predict(probe, raw_score=True).reshape(len(rows), -1)
        assert (np.diff(pred, axis=1) * c).min() >= 0.0, (name, j)


@pytest.mark.parametrize("learner", ["data", "voting"])
def test_cegb_state_is_a_shard_own_and_agrees(learner):
    """The CEGB state across trees: each shard starts every tree from
    its own tensor, and the copies agree after each tree with the
    learner's (one shard's state given to all would train, but on
    another shard's history)."""
    X, _, y = _problem(n=2048, f=10)
    p = dict(INT8, **CEGB, **_learner(learner, 2), device_type="cpu",
             verbosity=-1)
    b = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))
    lrn = b._driver.learner
    used = []
    for _ in range(4):
        b.update()
        b.num_trees()
        copies = [m["cegb_used"] for m in lrn.shard_metas]
        assert len({c.data_ptr() for c in copies}) == len(copies)
        for c in copies:
            assert torch.equal(c, lrn.meta["cegb_used"])
        used.append(float(lrn.meta["cegb_used"].sum()))
    assert used[-1] > 0


# (name, params, Dataset arguments): what the JAX learner refuses under a
# sharded learner, with its exception and text
REFUSALS = {
    "lazy_cegb_data": (dict(INT8, cegb_penalty_feature_lazy=[1.0] * 10,
                            **_learner("data", 2)), {}),
    "sparse_feature": (dict(HILO, **SPARSE, **_learner("feature", 2)), {}),
    "forced_int8": (dict(INT8, forcedsplits_filename="forced.json",
                         **_learner("data", 2)), {}),
    "kernel_partition_cat": (dict(INT8, tpu_partition_impl="kernel",
                                  **_learner("data", 2)),
                             {"categorical_feature": CAT_COLS}),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_are_the_jax_learners(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "forced.json").write_text(json.dumps(FORCED_TREE))
    params, ds_kw = REFUSALS[case]
    X = _inputs()["X_cat" if ds_kw else "X_a"][:1024]
    y = X[:, 0].copy()
    y[np.isnan(y)] = 0.0

    def train(lgb, device):
        p = dict(params, device_type=device, verbosity=-1)
        lgb.train(p, lgb.Dataset(X, label=y, params=p, **ds_kw), 1)

    with pytest.raises(Exception) as want:
        train(jlgb, "tpu")
    with pytest.raises(Exception) as got:
        train(tlgb, "cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
