"""Monotone constraints, CEGB, forced splits and deterministic=true of
lightgbm_tpu_torch against lightgbm_tpu.

Seeded data: 2,000 rows of ten columns, eight normal (column 3 with 5%
NaNs), column 8 an integer code of six values (categorical in one case)
and column 9 constant (an unused feature); a regression label additive
in columns 0-3 and 8 with a product of 4 and 5, and a binary label from
it.  A second table has two normal columns and one-hot blocks of 6 and 5
columns, which EFB would bundle.  The JAX package trains in processes
compiled without FMA (tests/test_torch_util.py: job "constraints"), the
deterministic (x64) runs in a process of their own so that JAX's x64
switch stays there; they start before the port trains beside them.

- monotone constraints: int8/int16 model text byte-identical under
  tpu_hist_impl xla, pallas, pallas2 and fused (B2's constraint branch,
  through its twin), with the quantized refit on (clipped to each leaf's
  bounds), bagged, with a categorical column, in DART; hilo trees within
  `assert_trees_match`'s tolerance; predictions monotone on a grid;
- CEGB: int8 text byte-identical with coupled, lazy and split penalties
  alone and together, and the learner's used/paid state equal after two
  update() calls; with GOSS it raises NotImplementedError in both;
- forced splits: hilo trees within tolerance for a root-only JSON, a
  three-level JSON and a forced split whose gain is negative (it and the
  forced splits after it are dropped), in RF too; forced splits form no
  EFB plan; int8 (ValueError), a categorical feature
  (NotImplementedError) and an unused feature (ValueError) are refused
  as the JAX package refuses them;
- deterministic=true: f64 trees within 1e-12 of the tree's largest leaf
  of the JAX package's, two port runs byte-identical, int8 text
  unchanged by the flag; pallas2/fused (ValueError), forced splits
  (TypeError) and tpu_hist_precision=f64 without the flag (ValueError)
  refused as there;
- every feature's model text loads and predicts the same in the other
  package, and its parameters block is byte-identical; lgb.cv and
  LGBMRegressor(monotone_constraints=...) give the JAX package's results.
"""

import json
import re

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import grower as TG

from .test_torch_util import (assert_trees_match, constraints_run, cv_run,
                              sklearn_run, start_jax_nofma)

N = 2000
CPU = {"device_type": "cpu"}
REG = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
       "min_data_in_leaf": 5, "verbosity": -1, "tpu_hist_precision": "int8",
       "tpu_quant_refit_leaves": False}
ROUNDS = 3
MONO = [1, -1, 0, 1, 0, 0, 0, 0, 0, 0]
# the JAX package runs its Pallas kernels in interpret mode here, slowly:
# the cases that are not about the histogram impl take its XLA branch
HILO = dict(REG, tpu_hist_precision="hilo", tpu_hist_impl="xla")
# f64 trees: leaf values within this share of the tree's largest
F64_RTOL = 1e-12
FORCED = {
    "root": {"feature": 1, "threshold": 0.0},
    "three": {"feature": 4, "threshold": 0.3,
              "left": {"feature": 5, "threshold": -0.5,
                       "left": {"feature": 6, "threshold": 0.0}},
              "right": {"feature": 3, "threshold": 0.2}},
    # column 7 is noise: its forced gain falls below min_gain_to_split,
    # so it and its child are dropped
    "negative": {"feature": 7, "threshold": 0.0,
                 "left": {"feature": 0, "threshold": 0.0}},
    "categorical": {"feature": 8, "threshold": 2.0},
    "unused": {"feature": 9, "threshold": 1.0},
}
# (case, extra params, run options) of the byte-identical int8/int16 runs
TEXT_CASES = [
    ("mono_int8_xla", {"monotone_constraints": MONO,
                       "tpu_hist_impl": "xla"}, {}),
    ("mono_int8_pallas", {"monotone_constraints": MONO,
                          "tpu_hist_impl": "pallas",
                          "tpu_partition_impl": "vselect"}, {}),
    ("mono_int8_pallas2", {"monotone_constraints": MONO,
                           "tpu_hist_impl": "pallas2"}, {}),
    ("mono_int8_fused", {"monotone_constraints": MONO,
                         "tpu_hist_impl": "fused"}, {}),
    ("mono_int16_fused", {"monotone_constraints": MONO,
                          "tpu_hist_impl": "fused",
                          "tpu_hist_precision": "int16"}, {}),
    ("mono_int8_refit", {"monotone_constraints": MONO,
                         "tpu_hist_impl": "fused",
                         "tpu_quant_refit_leaves": True}, {}),
    ("mono_int8_bagged", {"monotone_constraints": MONO,
                          "tpu_hist_impl": "xla", "bagging_fraction": 0.7,
                          "bagging_freq": 1, "feature_fraction": 0.8}, {}),
    ("mono_int8_cat", {"monotone_constraints": MONO,
                       "tpu_hist_impl": "xla", "min_data_per_group": 10,
                       "cat_smooth": 5}, {"cat": [8]}),
    ("mono_cegb_dart", {"monotone_constraints": MONO, "boosting": "dart",
                        "drop_rate": 0.5, "skip_drop": 0.0,
                        "cegb_penalty_split": 0.1,
                        "tpu_hist_impl": "xla"}, {}),
    ("cegb_coupled", {"cegb_penalty_feature_coupled": [150.0] * 10,
                      "tpu_hist_impl": "xla"}, {}),
    ("cegb_lazy", {"cegb_penalty_feature_lazy": [1.0] * 10,
                   "tpu_hist_impl": "xla"}, {}),
    ("cegb_split", {"cegb_penalty_split": 0.5,
                    "tpu_hist_impl": "xla"}, {}),
    ("cegb_all", {"cegb_penalty_split": 0.1,
                  "cegb_penalty_feature_coupled": [150.0, 0.0, 200.0, 50.0]
                  + [80.0] * 6,
                  "cegb_penalty_feature_lazy": [0.3] * 10,
                  "cegb_tradeoff": 0.8, "tpu_hist_impl": "fused"}, {}),
    ("cegb_updates", {"cegb_penalty_feature_coupled": [150.0] * 10,
                      "cegb_penalty_feature_lazy": [0.5] * 10,
                      "tpu_hist_impl": "xla"}, {"kind": "updates"}),
    ("int8_deterministic", {"deterministic": True,
                            "tpu_hist_impl": "xla"}, {}),
]
# (case, extra params, run options) of the float runs, held within
# assert_trees_match's tolerance
TREE_CASES = [
    ("mono_hilo", dict(HILO, monotone_constraints=MONO,
                       tpu_hist_impl="pallas2"), {}),
    ("forced_root", dict(HILO, forcedsplits_filename="root"), {}),
    ("forced_three", dict(HILO, forcedsplits_filename="three"), {}),
    ("forced_negative", dict(HILO, forcedsplits_filename="negative",
                             min_gain_to_split=40.0), {}),
    ("forced_rf", dict(HILO, forcedsplits_filename="three", boosting="rf",
                       bagging_fraction=0.7, bagging_freq=1), {}),
    ("forced_onehot", dict(HILO, forcedsplits_filename="root"),
     {"data": "onehot"}),
]
# the deterministic (f64) runs, in the x64 process
F64_CASES = [
    ("det_reg", dict(HILO, deterministic=True, tpu_hist_impl="xla"), {}),
    ("det_bagged", dict(HILO, deterministic=True, tpu_hist_impl="auto",
                        bagging_fraction=0.8, bagging_freq=1,
                        feature_fraction=0.9), {}),
]
# refusals that run in a JAX process (the deterministic ones turn JAX's
# x64 switch on before they raise)
X64_ERRORS = [
    ("det_pallas2", dict(HILO, deterministic=True, tpu_hist_impl="pallas2"),
     "ValueError"),
    ("det_fused", dict(REG, deterministic=True, tpu_hist_precision="f32",
                       tpu_hist_impl="fused"), "ValueError"),
    ("det_forced", dict(HILO, deterministic=True, tpu_hist_impl="xla",
                        forcedsplits_filename="root"), "TypeError"),
]


def _data(seed=21):
    """(X, regression label, binary label) of the base table."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 10))
    X[rng.random(N) < 0.05, 3] = np.nan
    X[:, 8] = rng.integers(0, 6, N)
    X[:, 9] = 1.0
    x3 = np.nan_to_num(X[:, 3])
    y = (1.5 * X[:, 0] - 1.0 * X[:, 1] + np.sin(2 * X[:, 2]) + 0.7 * x3
         + 0.5 * X[:, 4] * X[:, 5]
         + np.array([0, 1, -1, 2, -2, 0.5])[X[:, 8].astype(int)]
         + 0.3 * rng.normal(size=N))
    yb = (y + rng.logistic(size=N) > np.median(y)).astype(np.float64)
    return X, y, yb


def _onehot(seed=22):
    """(X, regression label, binary label) of the table EFB bundles: two
    normal columns and one-hot blocks of 6 and 5 columns."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 6, N), rng.integers(0, 5, N)
    X = np.concatenate([rng.normal(size=(N, 2)), np.eye(6)[a],
                        np.eye(5)[b]], axis=1)
    y = (X[:, 0] - 0.5 * X[:, 1] + rng.normal(size=6)[a]
         + rng.normal(size=5)[b] + 0.2 * rng.normal(size=N))
    yb = (y > np.median(y)).astype(np.float64)
    return X, y, yb


def _norm(text):
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


def _params_block(text):
    text = _norm(str(text))
    return text[text.index("\nparameters:"):text.index("end of parameters")]


def _with_paths(params, paths):
    """The params with forcedsplits_filename's case name made a path."""
    p = dict(params)
    if p.get("forcedsplits_filename"):
        p["forcedsplits_filename"] = paths[p["forcedsplits_filename"]]
    return p


def _runs(paths):
    runs = {}
    for name, extra, opts in TEXT_CASES:
        runs[name] = dict({"kind": "train"}, **opts, rounds=ROUNDS,
                          params=_with_paths(dict(REG, **extra), paths))
    for name, params, opts in TREE_CASES + F64_CASES:
        runs[name] = dict({"kind": "train"}, **opts, rounds=ROUNDS,
                          params=_with_paths(params, paths))
    runs["cegb_updates"]["rounds"] = 2
    runs["cv"] = {"kind": "cv", "rounds": 3, "nfold": 3, "stratified": False,
                  "params": dict(REG, monotone_constraints=MONO,
                                 cegb_penalty_split=0.1,
                                 cegb_penalty_feature_lazy=[0.3] * 10,
                                 tpu_hist_impl="xla")}
    runs["regressor"] = {"kind": "sklearn", "est": "LGBMRegressor",
                         "kw": {"n_estimators": 3, "num_leaves": 7,
                                "max_bin": 63, "min_child_samples": 5,
                                "verbosity": -1, "monotone_constraints": MONO,
                                "tpu_hist_precision": "int8",
                                "tpu_hist_impl": "xla",
                                "tpu_quant_refit_leaves": False}}
    for name, params, _ in X64_ERRORS:
        runs[name] = {"kind": "train", "rounds": 1,
                      "params": _with_paths(params, paths)}
    runs["orders"] = {"kind": "orders"}
    # refused by the JAX learner in a process without x64: its f64 pool
    # meets f32 histograms
    runs["f64_direct"] = {"kind": "train", "rounds": 1,
                          "params": dict(HILO, tpu_hist_precision="f64",
                                         tpu_hist_impl="xla")}
    return runs


X64_RUNS = [c[0] for c in F64_CASES + X64_ERRORS] + ["orders"]
# the models loaded across the packages
LOADED = ("mono_int8_fused", "cegb_all", "forced_three", "det_reg")
# the processes the other JAX runs are spread over
JAX_PROCESSES = 4


def _order_operands():
    """f64 operands of the XLA summation orders: [C, F, B] bin values to
    prefix-sum and [C, B, 3] histograms to sum over the bins, B = 300,
    of mixed magnitudes."""
    rng = np.random.default_rng(23)
    scan = rng.normal(size=(6, 4, 300)) * rng.choice([1e-3, 1.0, 1e5],
                                                     size=(6, 4, 300))
    sums = rng.normal(size=(6, 300, 3)) * rng.choice([1e-3, 1.0, 1e5],
                                                     size=(6, 300, 3))
    return {"orders_scan": scan, "orders_sum": sums}


def _port_run(name, run, data):
    if run["kind"] == "orders":
        return {}
    X, y, yb = data[run.get("data", "base")]
    lab = yb if run.get("label") == "bin" else y
    if run["kind"] == "sklearn":
        return sklearn_run(tlgb, X, lab, dict(run, kw=dict(run["kw"],
                                                          **CPU)))
    p = dict(run["params"], **CPU)
    if run["kind"] == "cv":
        return cv_run(tlgb, X, lab, dict(run, params=p))
    return constraints_run(tlgb, X, lab, dict(run, params=p))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's results, the JAX package's, the data sets, the forced
    split files) of every run of `_runs`."""
    tmp = tmp_path_factory.mktemp("constraints")
    paths = {}
    for name, tree in FORCED.items():
        paths[name] = str(tmp / f"forced_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(tree, f)
    data = {"base": _data(), "onehot": _onehot()}
    arrays = {}
    for key, (X, y, yb) in data.items():
        arrays.update({f"X_{key}": X, f"y_{key}_reg": y, f"y_{key}_bin": yb})
    arrays.update(_order_operands())
    runs = _runs(paths)
    rest = [k for k in runs if k not in X64_RUNS]
    groups = [X64_RUNS] + [rest[j::JAX_PROCESSES]
                           for j in range(JAX_PROCESSES)]
    jobs = []
    for j, names in enumerate(groups):
        d = tmp / f"jax{j}"
        d.mkdir()
        jobs.append((names, start_jax_nofma(
            "constraints", arrays, {"runs": [runs[k] for k in names]}, d)))
    port = {name: _port_run(name, run, data) for name, run in runs.items()}
    # the deterministic runs once more: the second must give the same text
    port["det_reg_again"] = _port_run("det_reg", runs["det_reg"], data)
    port["int8_plain"] = _port_run("int8_plain", dict(
        runs["int8_deterministic"], params=dict(
            runs["int8_deterministic"]["params"], deterministic=False)),
        data)
    # the port's texts loaded by the JAX package, predicted on its device
    # path
    d = tmp / "load"
    d.mkdir()
    jobs.append(([f"loaded_{k}" for k in LOADED], start_jax_nofma(
        "constraints", arrays, {"runs": [
            {"kind": "load", "text": port[k]["text"]} for k in LOADED]}, d)))
    ref = {}
    for names, job in jobs:
        got = job()
        for i, name in enumerate(names):
            ref[name] = {k[len(f"{i}_"):]: v for k, v in got.items()
                         if k.startswith(f"{i}_")}
    return port, ref, data, paths


def _trees(text, lgb):
    kw = {"params": CPU} if lgb is tlgb else {}
    return lgb.Booster(model_str=str(text), **kw)._driver.models


@pytest.mark.parametrize("name", [c[0] for c in TEXT_CASES])
def test_int_model_text_is_byte_identical(both, name):
    port, ref, _, _ = both
    assert "error" not in port[name], port[name].get("message")
    assert _norm(port[name]["text"]) == _norm(str(ref[name]["text"]))
    np.testing.assert_array_equal(port[name]["raw"], ref[name]["raw"])


def test_monotone_splits_use_the_constrained_features(both):
    port, _, _, _ = both
    trees = _trees(port["mono_int8_fused"]["text"], tlgb)
    used = {int(f) for t in trees for f in t.split_feature[:t.num_leaves - 1]}
    assert {0, 1, 3} <= used


def test_cegb_state_crosses_trees(both):
    port, ref, _, _ = both
    for name in ("cegb_updates", "cegb_all", "cegb_lazy"):
        np.testing.assert_array_equal(port[name]["used"], ref[name]["used"])
        np.testing.assert_array_equal(port[name]["paid"], ref[name]["paid"])
    # the second tree started from the first one's state: features used,
    # rows paid
    assert port["cegb_updates"]["used"].sum() > 0
    assert 0 < port["cegb_updates"]["paid"].mean() < 1
    assert "paid" not in port["cegb_coupled"]


def test_cegb_penalties_take_fewer_features(both):
    port, _, _, _ = both

    def features(name):
        return {int(f) for t in _trees(port[name]["text"], tlgb)
                for f in t.split_feature[:t.num_leaves - 1]}

    plain = features("int8_plain")
    assert features("cegb_coupled") < plain
    assert len(features("cegb_all")) < len(plain)


@pytest.mark.parametrize("name", [c[0] for c in TREE_CASES])
def test_float_trees_match(both, name):
    port, ref, _, _ = both
    assert "error" not in port[name], port[name].get("message")
    trees_t = _trees(port[name]["text"], tlgb)
    trees_j = _trees(ref[name]["text"], jlgb)
    # a one-hot column has no missing values, and its two scan directions
    # find the same split with gains equal up to the f32 sums' rounding,
    # which then picks the default-left flag; a node of missing type None
    # never reads it (reference Tree::NumericalDecision), so it is
    # cleared on such nodes, and only there (tests/test_torch_bundling.py)
    for tree in trees_t + trees_j:
        dt = tree.decision_type
        dt[((dt >> 2) & 3) == 0] &= ~np.int8(2)
    assert_trees_match(trees_j, trees_t)
    assert _params_block(port[name]["text"]) == _params_block(
        str(ref[name]["text"]))


@pytest.mark.parametrize("name,head", [
    ("forced_root", [1]), ("forced_three", [4, 5, 3, 6]),
    ("forced_rf", [4, 5, 3, 6]), ("forced_onehot", [1])])
def test_forced_splits_head_every_tree(both, name, head):
    # the forced splits are a tree's first nodes, in their BFS order
    port, _, _, _ = both
    for t in _trees(port[name]["text"], tlgb):
        assert list(t.split_feature[:len(head)]) == head


def test_negative_forced_gain_drops_the_forced_splits(both):
    port, ref, _, _ = both
    for text in (port["forced_negative"]["text"],
                 ref["forced_negative"]["text"]):
        for t in _trees(text, tlgb):
            assert t.num_leaves > 1 and t.split_feature[0] != 7


def test_forced_splits_form_no_bundle_plan(both):
    port, ref, data, _ = both
    assert not port["forced_onehot"]["plan"]
    assert not bool(ref["forced_onehot"]["plan"])
    X, y, _ = data["onehot"]
    b = tlgb.train(dict(HILO, **CPU), tlgb.Dataset(X, label=y), 1,
                   keep_training_booster=True)
    assert b._driver.learner.bundle_plan is not None


@pytest.mark.parametrize("name", [c[0] for c in F64_CASES])
def test_f64_trees_match(both, name):
    port, ref, _, _ = both
    assert "error" not in ref[name], ref[name].get("message")
    assert_trees_match(_trees(ref[name]["text"], jlgb),
                       _trees(port[name]["text"], tlgb), rtol=F64_RTOL)
    assert _params_block(port[name]["text"]) == _params_block(
        str(ref[name]["text"]))


def test_deterministic_runs_are_byte_identical(both):
    port, _, _, _ = both
    assert port["det_reg"]["text"] == port["det_reg_again"]["text"]
    np.testing.assert_array_equal(port["det_reg"]["raw"],
                                  port["det_reg_again"]["raw"])


def test_int8_text_unchanged_by_deterministic(both):
    port, _, _, _ = both
    flag = re.compile(r"^\[deterministic: [01]\]$", flags=re.M)
    assert flag.sub("-", port["int8_deterministic"]["text"]) == \
        flag.sub("-", port["int8_plain"]["text"])


@pytest.mark.parametrize("name,exc", [(c[0], c[2]) for c in X64_ERRORS]
                         + [("f64_direct", "ValueError")])
def test_deterministic_refusals_match(both, name, exc):
    port, ref, _, _ = both
    assert str(ref[name]["error"]) == exc
    assert port[name]["error"] == exc


def test_models_load_across_packages(both):
    port, ref, data, _ = both
    X = data["base"][0]
    for name in LOADED:
        got = tlgb.Booster(model_str=str(ref[name]["text"]),
                           params=CPU).predict(X, raw_score=True)
        np.testing.assert_array_equal(got, ref[name]["raw"])
        np.testing.assert_array_equal(ref[f"loaded_{name}"]["raw"],
                                      port[name]["raw"])


def test_cv_and_regressor(both):
    port, ref, _, _ = both
    assert port["cv"][0] == str(ref["cv"]["result"])
    assert _norm(port["regressor"]["text"]) == _norm(
        str(ref["regressor"]["text"]))
    np.testing.assert_array_equal(port["regressor"]["pred"],
                                  ref["regressor"]["pred"])


@pytest.mark.parametrize("params", [
    dict(HILO, forcedsplits_filename="three"),
    dict(HILO, deterministic=True, tpu_hist_impl="xla")],
    ids=["forced", "deterministic"])
def test_cv_takes_forced_splits_and_deterministic(both, params):
    _, _, data, paths = both
    X, y, _ = data["base"]
    res = tlgb.cv(dict(_with_paths(params, paths), **CPU),
                  tlgb.Dataset(X, label=y), num_boost_round=2, nfold=3,
                  stratified=False)
    assert np.all(np.isfinite(res["l2-mean"])) and len(res["l2-mean"]) == 2


def test_f64_sums_take_xla_order(both):
    # the split search's bin prefix sums and the forced splits' bin sums
    # take XLA:CPU's order in f64 as in f32 (blocks of 16, windows of 32)
    from lightgbm_tpu_torch.ops.split import cumsum_last, reduce_sum

    _, ref, _, _ = both
    ops = _order_operands()
    np.testing.assert_array_equal(
        cumsum_last(torch.from_numpy(ops["orders_scan"])).numpy(),
        ref["orders"]["cumsum"])
    np.testing.assert_array_equal(
        reduce_sum(torch.from_numpy(ops["orders_sum"]), 1).numpy(),
        ref["orders"]["sum"])


# ---- monotone predictions and the refit's clip -------------------------


@pytest.mark.parametrize("name", ["mono_int8_fused", "mono_int8_refit",
                                  "mono_hilo", "mono_int8_cat"])
def test_predictions_are_monotone_on_a_grid(both, name):
    port, _, data, _ = both
    X = data["base"][0][:200]
    b = tlgb.Booster(model_str=port[name]["text"], params=CPU)
    grid = np.linspace(-3, 3, 25)
    for j, sign in enumerate(MONO):
        if not sign:
            continue
        rows = np.repeat(X, len(grid), axis=0)
        rows[:, j] = np.tile(grid, len(X))
        pred = b.predict(rows, raw_score=True).reshape(len(X), len(grid))
        assert np.all(np.diff(pred, axis=1) * sign >= 0), j


def test_refit_is_clipped_to_the_leaf_bounds(both):
    # a leaf whose output the search clipped to its bounds has a refit
    # output past them too: the refit clips it back (grower.py:1749-1752
    # of the JAX package), and the text equals the JAX package's
    port, ref, data, _ = both
    X, y, _ = data["base"]
    p = dict(REG, monotone_constraints=MONO, tpu_hist_impl="fused",
             tpu_quant_refit_leaves=True, **CPU)
    b = tlgb.train(p, tlgb.Dataset(X, label=y), 1,
                   keep_training_booster=True)
    learner = b._driver.learner
    grad = torch.as_tensor(-y, dtype=torch.float32)
    out = TG.grow(learner.params, learner.bins_t, learner.pad_vector(grad),
                  learner.pad_vector(torch.ones(N)), learner._ones_mask,
                  learner.feature_mask, learner.meta,
                  np.array([0, 7], np.uint32))
    L = learner.params.num_leaves
    ids = out["leaf_ids"][:N].long()
    g = torch.zeros(L, dtype=torch.float64).index_add_(0, ids,
                                                       grad.double())
    h = torch.zeros(L, dtype=torch.float64).index_add_(
        0, ids, torch.ones(N, dtype=torch.float64))
    free = (-g / h.clamp(min=1.0)).float()
    live = out["leaf_cnt"] > 0
    gap = (out["leaf_output"] - free).abs()[live]
    assert gap.max() > 1e-3 * free[live].abs().max()
    assert _norm(port["mono_int8_refit"]["text"]) == _norm(
        str(ref["mono_int8_refit"]["text"]))


# ---- refusals --------------------------------------------------------------


@pytest.mark.parametrize("extra,exc,match", [
    ({"forcedsplits_filename": "root"}, ValueError, "forced splits"),
    ({"forcedsplits_filename": "categorical", "tpu_hist_precision": "hilo"},
     NotImplementedError, "categorical"),
    ({"forcedsplits_filename": "unused", "tpu_hist_precision": "hilo"},
     ValueError, "unused"),
    ({"boosting": "goss", "cegb_penalty_split": 0.1}, NotImplementedError,
     "GOSS"),
], ids=["forced_int8", "forced_categorical", "forced_unused", "goss_cegb"])
def test_refusals_match_the_jax_package(both, extra, exc, match):
    _, _, data, paths = both
    X, y, _ = data["base"]
    params = _with_paths(dict(REG, **extra), paths)
    cat = [8] if "categorical" in str(extra) else "auto"
    with pytest.raises(exc, match=match):
        jlgb.train(params, jlgb.Dataset(X, label=y, categorical_feature=cat),
                   1)
    with pytest.raises(exc, match=match):
        tlgb.train(dict(params, **CPU),
                   tlgb.Dataset(X, label=y, categorical_feature=cat), 1)


def test_grower_refuses_forced_splits_with_bundles_or_f64():
    p = TG.GrowerParams(num_leaves=4, num_bins=16, precision="hilo", l1=0.0,
                        l2=0.0, max_delta_step=0.0, min_data_in_leaf=1.0,
                        min_sum_hessian=0.0, min_gain_to_split=0.0,
                        max_depth=-1, forced=((0, 0, 3),))
    TG.check_params(p)
    with pytest.raises(ValueError, match="EFB bundling"):
        TG.check_params(p._replace(has_bundles=True))
    with pytest.raises(TypeError, match="deterministic"):
        TG.check_params(p._replace(precision="f64"))


def test_unported_features_stay_refused_by_name(tmp_path):
    X, y, _ = _data()
    # the streamed layout is ported; CEGB, which it cannot serve, stays
    # refused by name there, with the JAX package's text
    cegb = {"tpu_stream_mode": "streamed", "cegb_penalty_split": 0.1}
    with pytest.raises(NotImplementedError, match="tpu_stream_mode") as want:
        jlgb.train(dict(REG, **cegb), jlgb.Dataset(X, label=y), 1)
    with pytest.raises(NotImplementedError) as got:
        tlgb.train(dict(REG, **CPU, **cegb), tlgb.Dataset(X, label=y), 1)
    assert str(got.value) == str(want.value)
    # sparse storage is ported, and refuses the int8 precision of REG as
    # the JAX package does
    extra = {"tpu_sparse_threshold": 0.5, "enable_bundle": False}
    with pytest.raises(ValueError, match="quantized") as want:
        jlgb.train(dict(REG, **extra), jlgb.Dataset(X, label=y), 1)
    with pytest.raises(ValueError) as got:
        tlgb.train(dict(REG, **CPU, **extra), tlgb.Dataset(X, label=y), 1)
    assert str(got.value) == str(want.value)
    # file input is ported: the file's bins are the JAX package's
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",")
    got = tlgb.Dataset(str(path), params=dict(REG, **CPU)).construct()
    want = jlgb.Dataset(str(path), params=REG).construct()
    np.testing.assert_array_equal(got._inner.bins, want._inner.bins)
    np.testing.assert_array_equal(got.get_label(), want.get_label())
