"""Sparse data and EFB bundles of lightgbm_tpu_torch against lightgbm_tpu.

Seeded one-hot data in the shape of the Flight Delay table LightGBM's EFB
paper trains on: 2,000 rows of two numerical columns (one gamma
distributed, one normal with NaNs) and one-hot blocks of 12, 7, 24 and 31
categories, 76 features in a scipy CSR matrix, binary and regression
labels from per-category effects.  The JAX package trains in one process
compiled without FMA (tests/test_torch_util.py: job "sparse"), started
before the port trains beside it on the CPU.

- the port's `find_bundles`/`apply_bundles` give the JAX plan and
  columns: exclusive one-hots, a conflict budget, the capacity cap and
  dense data left unbundled; the learners' plans and bundle columns are
  equal on every training below, a categorical column inside a bundle
  among them;
- `from_sparse` gives the JAX bins from CSR and from CSC with duplicate
  coordinates, stored zeros and stored NaNs, and a CSR validation set
  bins through the training mappers;
- `expand_bundles` is bit-equal to the JAX grower's expansion (its body,
  grower.py:625-660, jitted and vmapped over the leaves as there);
- int8/int16 model text is byte-identical under tpu_hist_impl xla,
  pallas, pallas2 and fused, with bagging, feature_fraction_bynode, GOSS,
  max_bin=15 (a plan, so no packing), max_bin=511 (wide bundle columns),
  the shape buckets off, CSC input, a CSR validation set and a bundled
  categorical column; hilo binary trees match within
  `assert_trees_match`'s tolerance;
- predict of the CSR matrix equals predict of its dense copy and the JAX
  package's device predict, and models load across the two packages;
- lgb.cv trains and predicts on CSR as the JAX package does, and
  LGBMClassifier on CSR as the JAX wrapper on the densified rows;
- tpu_partition_impl=kernel with bundles raises the JAX package's
  ValueError, and so does tpu_sparse_threshold>0 with enable_bundle=true.
"""

import json
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.io import bundling as JB
from lightgbm_tpu_torch.io import bundling as TB
from lightgbm_tpu_torch.ops.grower import expand_bundles

from .test_torch_util import (assert_trees_match, csr_arrays, cv_run,
                              sklearn_run, sparse_run, start_jax_nofma)

N = 2000
BLOCKS = (12, 7, 24, 31)
CPU = {"device_type": "cpu"}
REG = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
       "min_data_in_leaf": 5, "verbosity": -1, "tpu_hist_precision": "int8",
       "tpu_quant_refit_leaves": False}
ROUNDS = 4
# the processes the JAX runs on the base data are spread over
JAX_PROCESSES = 3
# (case, extra params, run options); the shape buckets are on (the
# default) but in one case
TEXT_CASES = [
    ("int8_xla_select", {"tpu_hist_impl": "xla"}, {}),
    ("int8_pallas_vselect", {"tpu_hist_impl": "pallas",
                             "tpu_partition_impl": "vselect"}, {}),
    ("int8_pallas2_buckets_off", {"tpu_hist_impl": "pallas2",
                                  "tpu_shape_buckets": 0}, {}),
    ("int8_fused_vselect", {"tpu_hist_impl": "fused",
                            "tpu_partition_impl": "vselect"}, {}),
    ("int16_fused_select", {"tpu_hist_impl": "fused",
                            "tpu_hist_precision": "int16"}, {}),
    ("int8_bagging", {"tpu_hist_impl": "fused", "bagging_fraction": 0.7,
                      "bagging_freq": 1, "feature_fraction": 0.8}, {}),
    ("int8_bynode", {"tpu_hist_impl": "fused",
                     "feature_fraction_bynode": 0.5}, {}),
    ("int8_goss", {"tpu_hist_impl": "fused", "boosting": "goss",
                   "learning_rate": 0.5}, {}),
    ("int8_packed15", {"tpu_hist_impl": "pallas2", "max_bin": 15}, {}),
    ("int8_wide511", {"tpu_hist_impl": "fused", "max_bin": 511,
                      "min_data_in_bin": 1}, {}),
    ("int8_csc_valid", {"tpu_hist_impl": "xla", "metric": "l2"},
     {"csc": True, "n_train": 1500}),
    ("int8_categorical", {"tpu_hist_impl": "fused", "min_data_per_group": 10,
                          "cat_smooth": 5}, {"cat": [2]}),
]


def _data(seed=3, cat_col=False):
    """(CSR X, regression label, binary label): column 0 gamma distances,
    column 1 normal with 3% NaNs, then the one-hot blocks, one 1.0 a row
    each.  cat_col: column 2 is a categorical column with a dominant
    category, 7, which takes its bin 0; its other codes, 1-5, sit on the
    rows whose first block takes its last category, and that block's
    last column is dropped, so the column can share a bundle with the
    block."""
    rng = np.random.default_rng(seed)
    dist = rng.gamma(2.0, 400.0, N)
    x1 = rng.normal(size=N)
    x1[rng.random(N) < 0.03] = np.nan
    lat = 0.002 * dist + np.nan_to_num(x1) * 0.5
    rows, cols, vals = [np.arange(N)] * 2, [np.zeros(N, int),
                                            np.ones(N, int)], [dist, x1]
    off = 2 + int(cat_col)
    first = None
    for b, k in enumerate(BLOCKS):
        p = rng.dirichlet(np.ones(k) * 2.0)
        c = rng.choice(k, size=N, p=p)
        lat = lat + rng.normal(size=k)[c]
        keep = np.ones(N, bool)
        if b == 0:
            first = c
            if cat_col:
                keep = c < k - 1
        rows.append(np.flatnonzero(keep))
        cols.append(off + c[keep])
        vals.append(np.ones(int(keep.sum())))
        off += k
    if cat_col:
        code = np.where(first == BLOCKS[0] - 1, rng.integers(1, 6, N), 7)
        lat += np.array([0, 3.0, -3.0, 2.0, 4.0, -4.0, 0, 0])[code]
        rows.append(np.arange(N))
        cols.append(np.full(N, 2))
        vals.append(code.astype(np.float64))
    X = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(N, off))
    y = lat + 0.3 * rng.normal(size=N)
    yb = (y + rng.logistic(size=N) * 0.5 > np.median(y)).astype(np.float64)
    return X, y, yb


def _norm(text):
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


# ---- the plan ---------------------------------------------------------------


def _plan_case(name):
    """(bins [n, F], num_bin, most_freq_is_zero, max_conflict_rate,
    max_bundle_bins) of a seeded bundling case."""
    rng = np.random.default_rng(11)
    n = 3000
    if name == "dense":
        bins = rng.integers(0, 16, size=(n, 6))
        return bins, np.full(6, 16), np.zeros(6, bool), 0.0, 16
    # one-hot blocks of 4, 9 and 5 columns (0/1 bins) and a 3-bin column
    cols = []
    for k in (4, 9, 5):
        c = rng.integers(0, k + 1, n)           # category k: all zeros
        cols.append(np.eye(k + 1, k, dtype=np.int64)[c])
    sparse3 = np.where(rng.random(n) < 0.1, rng.integers(1, 3, n), 0)
    bins = np.concatenate(cols + [sparse3[:, None]], axis=1)
    F = bins.shape[1]
    num_bin = np.full(F, 2)
    num_bin[-1] = 3
    mfz = (bins == 0).mean(0) >= 0.8
    if name == "conflicts":
        # rows where a second block member is on: within the 10% budget
        extra = rng.random(n) < 0.04
        bins[extra, 4] = 1
        return bins, num_bin, mfz, 0.1, 16
    if name == "capacity":
        return bins, num_bin, mfz, 0.0, 6
    return bins, num_bin, mfz, 0.0, 16


@pytest.mark.parametrize("name", ["exclusive", "conflicts", "capacity",
                                  "dense"])
def test_plan_and_columns_equal_the_jax_package(name):
    bins, num_bin, mfz, rate, cap = _plan_case(name)
    pj = JB.find_bundles(bins, num_bin, mfz, rate, cap, sample_rows=1000)
    pt = TB.find_bundles(bins, num_bin, mfz, rate, cap, sample_rows=1000)
    assert pt.groups == pj.groups
    for k in ("bundle_idx", "bin_offset", "needs_fix", "num_bin"):
        np.testing.assert_array_equal(getattr(pt, k), getattr(pj, k))
    assert pt.is_trivial == pj.is_trivial == (name == "dense")
    if name == "capacity":
        assert max(pj.num_bin) <= cap and pj.num_columns > 4
    np.testing.assert_array_equal(TB.apply_bundles(bins, pt),
                                  JB.apply_bundles(bins, pj))


# ---- ingest -----------------------------------------------------------------


def _messy(fmt):
    """_data's X with duplicate coordinates, stored zeros and stored NaNs,
    as CSR or CSC."""
    X, y, _ = _data(seed=4)
    X = X.tocoo()
    rng = np.random.default_rng(5)
    pick = rng.choice(X.nnz, 300, replace=False)
    r = np.concatenate([X.row, X.row[pick[:100]], rng.integers(0, N, 60),
                        rng.integers(0, N, 40)])
    c = np.concatenate([X.col, X.col[pick[:100]], rng.integers(0, 6, 60),
                        rng.integers(0, 6, 40)])
    v = np.concatenate([X.data, X.data[pick[:100]] * 0.5, np.zeros(60),
                        np.full(40, np.nan)])
    M = sp.coo_matrix((v, (r, c)), shape=X.shape)
    return (M.tocsr() if fmt == "csr" else M.tocsc()), y


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_from_sparse_bins_equal_the_jax_package(fmt):
    X, y = _messy(fmt)
    Xj = X.copy()
    dt = tlgb.Dataset(X, label=y, params=dict(CPU, max_bin=63)).construct()
    dj = jlgb.Dataset(Xj, label=y, params={"max_bin": 63}).construct()
    assert dt._inner.used_feature_idx == dj._inner.used_feature_idx
    np.testing.assert_array_equal(dt._inner.bins, dj._inner.bins)
    for mt, mj in zip(dt._inner.mappers, dj._inner.mappers):
        assert mt.num_bin == mj.num_bin and mt.default_bin == mj.default_bin
        np.testing.assert_array_equal(mt.bin_upper_bound, mj.bin_upper_bound)
    # the dense copy bins alike (duplicates add up, as toarray adds them)
    dd = tlgb.Dataset(X.toarray(), label=y,
                      params=dict(CPU, max_bin=63)).construct()
    np.testing.assert_array_equal(dd._inner.bins, dt._inner.bins)


def test_csr_valid_set_bins_through_the_training_mappers():
    X, y, _ = _data(seed=6)
    Xv, yv, _ = _data(seed=7)
    tt = tlgb.Dataset(X, label=y, params=dict(CPU, max_bin=63))
    tj = jlgb.Dataset(X, label=y, params={"max_bin": 63})
    vt = tlgb.Dataset(Xv, label=yv, reference=tt).construct()
    vj = jlgb.Dataset(Xv, label=yv, reference=tj).construct()
    assert vt._inner.mappers is tt._inner.mappers
    np.testing.assert_array_equal(vt._inner.bins, vj._inner.bins)
    vd = tt._inner.create_valid(Xv.toarray(), yv)
    np.testing.assert_array_equal(vd.bins, vt._inner.bins)


# ---- expand_bundles ---------------------------------------------------------


def _jax_expand(hist_g, sg, sh, cnt, fmeta, B):
    """The JAX grower's `expand_bundles` body (lightgbm_tpu/ops/grower.py:
    625-660, a closure there), jitted and vmapped over the leaves as its
    `select` is."""
    import jax
    import jax.numpy as jnp

    def one(hist_g, sg, sh, cnt):
        bi = jnp.clip(fmeta["bundle_idx"], 0, hist_g.shape[0] - 1)
        off = fmeta["bin_offset"]
        fix = fmeta["needs_fix"] > 0
        iota_b = jnp.arange(B, dtype=jnp.int32)
        src = jnp.clip(off[:, None] + iota_b[None, :], 0, B - 1)
        hist_f = hist_g[bi[:, None], src]
        nbv = fmeta["num_bin"][:, None]
        in_range = (iota_b[None, :] >= 1) & (iota_b[None, :] < nbv)
        keep = jnp.where(fix[:, None], in_range, jnp.ones_like(in_range))
        hist_f = jnp.where(keep[:, :, None], hist_f, 0.0)
        totals = jnp.stack([sg, sh, cnt])
        rest = jnp.sum(hist_f, axis=1)
        bin0 = totals[None, :] - rest
        return hist_f.at[:, 0, :].set(
            jnp.where(fix[:, None], bin0, hist_f[:, 0, :]))

    return np.asarray(jax.jit(jax.vmap(one))(hist_g, sg, sh, cnt))


@pytest.mark.parametrize("B", [16, 63, 255, 300])
def test_expand_bundles_is_bit_equal(B):
    rng = np.random.default_rng(B)
    C, G = 6, 5
    # a singleton column, bundles of one-hot members and of wider members,
    # and padding features (num_bin 1, column 0)
    groups = [[0], [1, 2, 3, 4], [5, 6], [7], [8, 9, 10]]
    num_bin = np.array([B, 2, 2, 2, 2, min(B, 9), 3, B - 1, 4, 2, 5, 1, 1],
                       np.int32)
    F = len(num_bin)
    bidx = np.zeros(F, np.int32)
    boff = np.zeros(F, np.int32)
    fix = np.zeros(F, np.int32)
    for g, members in enumerate(groups):
        o = 0
        for f in members:
            bidx[f], boff[f] = g, o
            fix[f] = len(members) > 1
            o += int(num_bin[f]) - 1
    hist = (rng.normal(size=(C, G, B, 3)) * rng.choice(
        [1e-3, 1.0, 1e3], size=(C, G, B, 3))).astype(np.float32)
    hist[..., 2] = np.abs(np.round(hist[..., 2]))
    sg, sh, cnt = (rng.normal(size=C).astype(np.float32) * 50
                   for _ in range(3))
    meta = {"bundle_idx": bidx, "bin_offset": boff, "needs_fix": fix,
            "num_bin": num_bin}
    got = expand_bundles(torch.from_numpy(hist), torch.from_numpy(sg),
                         torch.from_numpy(sh), torch.from_numpy(cnt),
                         {k: torch.from_numpy(v) for k, v in meta.items()})
    ref = _jax_expand(hist, sg, sh, cnt, meta, B)
    assert got.shape == (C, F, B, 3)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))


# ---- the shared JAX runs ----------------------------------------------------


def _runs():
    runs = {}
    for name, extra, opts in TEXT_CASES:
        runs[name] = dict(opts, kind="train", params=dict(REG, **extra),
                          rounds=ROUNDS,
                          data="cat" if "cat" in opts else "base")
    runs["hilo_binary"] = {"kind": "train", "label": "binary",
                           "data": "base", "rounds": ROUNDS,
                           "params": dict(REG, objective="binary",
                                          tpu_hist_precision="hilo",
                                          tpu_hist_impl="pallas2")}
    runs["cv"] = {"kind": "cv", "data": "base", "rounds": 3, "nfold": 3,
                  "stratified": False, "return_cvbooster": True,
                  "params": dict(REG, tpu_hist_impl="fused")}
    # the JAX wrapper fits the densified rows: its fit reads the feature
    # count off np.asarray(X), which a scipy matrix does not give
    runs["classifier"] = {"kind": "sklearn", "data": "base", "dense": True,
                          "label": "binary", "est": "LGBMClassifier",
                          "kw": {"n_estimators": 3, "num_leaves": 7,
                                 "max_bin": 63, "min_child_samples": 5,
                                 "verbosity": -1}}
    return runs


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's results, the JAX package's) of every run of `_runs`,
    and the raw scores of the port's int8 model loaded by the JAX
    package."""
    tmp = tmp_path_factory.mktemp("bundling")
    data = {"base": _data(), "cat": _data(cat_col=True)}
    runs = _runs()
    # the JAX runs in JAX_PROCESSES processes on the base data and one
    # on the categorical data, all started at once
    jobs = []
    for key, (X, y, yb) in data.items():
        names = [k for k, r in runs.items() if r["data"] == key]
        parts = JAX_PROCESSES if key == "base" else 1
        for j in range(parts):
            chunk = names[j::parts]
            spec = [dict(runs[k], label=runs[k].get("label", "regression"))
                    for k in chunk]
            d = tmp / f"{key}{j}"
            d.mkdir()
            jobs.append((chunk, start_jax_nofma(
                "sparse", {**csr_arrays("X", X), "y_regression": y,
                           "y_binary": yb}, {"runs": spec}, d)))
    port = {}
    for name, run in runs.items():
        X, y, yb = data[run["data"]]
        lab = yb if run.get("label") == "binary" else y
        if run["kind"] == "train":
            port[name] = sparse_run(
                tlgb, X, lab, dict(run, params=dict(run["params"], **CPU)))
        elif run["kind"] == "cv":
            port[name] = cv_run(tlgb, X, lab, dict(
                run, params=dict(run["params"], **CPU)))
        else:
            port[name] = sklearn_run(tlgb, X, lab, dict(
                run, kw=dict(run["kw"], **CPU)))
    load_dir = tmp / "load"
    load_dir.mkdir()
    X = data["base"][0]
    load_job = start_jax_nofma(
        "sparse", {**csr_arrays("X", X), "y_regression": data["base"][1]},
        {"runs": [{"kind": "load_predict",
                   "text": port["int8_xla_select"]["text"]}]}, load_dir)
    ref = {}
    for names, job in jobs:
        got = job()
        for i, name in enumerate(names):
            ref[name] = {k[len(f"{i}_"):]: v for k, v in got.items()
                         if k.startswith(f"{i}_")}
    ref["loaded_port_raw"] = load_job()["0_raw"]
    return port, ref


@pytest.mark.parametrize("name", [c[0] for c in TEXT_CASES])
def test_int_model_text_is_byte_identical(both, name):
    port, ref = both
    plan = json.loads(str(ref[name]["plan"]))
    assert plan is not None and any(len(g) > 1 for g in plan)
    assert json.loads(port[name]["plan"]) == plan
    np.testing.assert_array_equal(port[name]["columns"],
                                  ref[name]["columns"])
    assert _norm(port[name]["text"]) == _norm(str(ref[name]["text"]))
    np.testing.assert_array_equal(port[name]["raw"], ref[name]["raw"])
    np.testing.assert_array_equal(port[name]["raw"],
                                  port[name]["raw_dense"])
    assert port[name]["evals"] == str(ref[name]["evals"])


def test_bundled_categorical_column_splits(both):
    port, ref = both
    plan = json.loads(port["int8_categorical"]["plan"])
    # column 2 is used feature 2: the categorical column sits in a bundle
    assert any(2 in g and len(g) > 1 for g in plan)
    assert re.search(r"^num_cat=[1-9]", port["int8_categorical"]["text"],
                     flags=re.M)


def test_wide_bundle_columns_are_int32(both):
    port, _ = both
    assert port["int8_wide511"]["columns"].dtype == np.int32
    assert port["int8_pallas2_buckets_off"]["columns"].dtype == np.uint8


def test_hilo_trees_match(both):
    port, ref = both
    assert json.loads(port["hilo_binary"]["plan"]) == json.loads(
        str(ref["hilo_binary"]["plan"]))
    trees_t = tlgb.Booster(model_str=port["hilo_binary"]["text"],
                           params=CPU)._driver.models
    trees_j = jlgb.Booster(model_str=str(ref["hilo_binary"]["text"])
                           )._driver.models
    # a one-hot feature has no missing values, and its two scan
    # directions find the same split with gains equal up to the f32
    # sums' rounding, so the rounding picks the default-left flag; a node
    # of missing type None never reads it (reference Tree::
    # NumericalDecision), so it is cleared on such nodes, and only there
    for tree in trees_t + trees_j:
        dt = tree.decision_type
        dt[((dt >> 2) & 3) == 0] &= ~np.int8(2)
    assert_trees_match(trees_j, trees_t)
    np.testing.assert_array_equal(port["hilo_binary"]["raw"],
                                  port["hilo_binary"]["raw_dense"])


def test_models_load_across_packages(both):
    port, ref = both
    X = _data()[0]
    np.testing.assert_array_equal(ref["loaded_port_raw"],
                                  port["int8_xla_select"]["raw"])
    b = tlgb.Booster(model_str=str(ref["int8_xla_select"]["text"]),
                     params=CPU)
    np.testing.assert_array_equal(b.predict(X, raw_score=True),
                                  ref["int8_xla_select"]["raw"])


def test_cv_and_classifier_on_csr(both):
    port, ref = both
    assert port["cv"][0] == str(ref["cv"]["result"])
    np.testing.assert_array_equal(port["cv"][1], ref["cv"]["raw"])
    for k in ("pred", "proba"):
        np.testing.assert_allclose(port["classifier"][k],
                                   ref["classifier"][k], rtol=1e-5,
                                   atol=1e-6)


# ---- refusals ---------------------------------------------------------------


def test_kernel_partition_with_bundles_raises_the_jax_error():
    X, y, _ = _data()
    params = dict(REG, tpu_partition_impl="kernel")
    msg = "EFB bundles"
    with pytest.raises(ValueError, match=msg):
        jlgb.train(params, jlgb.Dataset(X, label=y), 1)
    with pytest.raises(ValueError, match=msg):
        tlgb.train(dict(params, **CPU), tlgb.Dataset(X, label=y), 1)


def test_sparse_threshold_stays_refused_by_name():
    # sparse storage is ported; with EFB on (the default) both packages
    # refuse it by the name of enable_bundle (learner.py:313-318)
    X, y, _ = _data()
    params = dict(REG, tpu_hist_precision="hilo", tpu_sparse_threshold=0.5)
    with pytest.raises(ValueError, match="enable_bundle=false") as want:
        jlgb.train(params, jlgb.Dataset(X, label=y), 1)
    with pytest.raises(ValueError) as got:
        tlgb.train(dict(params, **CPU), tlgb.Dataset(X, label=y), 1)
    assert str(got.value) == str(want.value)


def test_grower_refuses_packed_bundle_columns():
    # the JAX grower's refusal (grower.py:366-372): the learner never
    # packs bundle columns, and the grower refuses them packed
    from lightgbm_tpu_torch.ops import grower as TG

    p = TG.GrowerParams(num_leaves=4, num_bins=16, precision="hilo", l1=0.0,
                        l2=0.0, max_delta_step=0.0, min_data_in_leaf=1.0,
                        min_sum_hessian=0.0, min_gain_to_split=0.0,
                        max_depth=0, packed_bins=True, has_bundles=True)
    z = torch.zeros(256)
    with pytest.raises(ValueError, match="no EFB bundling"):
        TG.grow(p, torch.zeros((32, 128), dtype=torch.uint8), z, z, z,
                torch.ones(40), {})
