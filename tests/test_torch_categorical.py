"""Categorical features of lightgbm_tpu_torch against lightgbm_tpu.

Seeded data of 2,000 rows x 7 features with NaNs: column 1 holds 32
categories with negative codes and NaNs, column 4 three (the one-hot mode
under max_cat_to_onehot=4), column 6 twelve (300 on the wide data, at
max_bin=511; column 1 twelve on the packed data, at max_bin=15).  The
JAX package trains in processes compiled without FMA
(tests/test_torch_util.py: job "boosting" kinds "cat", "cv" and
"load_predict", job "cat_split"), started before the port trains beside
them on the CPU.

- the mappers and binned matrices are equal, arrays and pandas category
  frames, a valid set built with reference=, and past the category LUT's
  capacity (the host bins then);
- `per_feature_best_split_categorical` is bitwise equal on random
  histograms, both modes, CTR ties, features with fewer than two valid
  bins, min_data_per_group groups and the max_cat_threshold cut; its
  bounded scan equals the scan over every bin;
- int8/int16 regression model text is byte-identical under every
  tpu_hist_impl with select and vselect, packed (max_bin=15), wide
  (max_bin=511), bagged, with a valid set, and from a category frame;
  hilo binary trees match within `assert_trees_match`'s tolerance;
- device predict of raw rows (NaN, negative, unseen and too-large
  categories) equals the JAX device predict, models load across the two
  packages both ways, and feature_infos, dump_model and
  trees_to_dataframe agree;
- lgb.cv's folds keep the dataset's categorical features;
- tpu_partition_impl=kernel with categorical features raises the JAX
  package's ValueError.
"""

import io
import json
import re

import numpy as np
import pandas as pd
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import split as TS
from lightgbm_tpu_torch.ops.binning import _CAT_LUT_MAX

from .test_torch_util import (assert_trees_match, cat_frame, cat_run,
                              cv_run, start_jax_nofma)

N = 2000
CAT = [1, 4, 6]
CPU = {"device_type": "cpu"}
REG = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
       "min_data_in_leaf": 5, "min_data_per_group": 20, "cat_smooth": 5,
       "verbosity": -1, "tpu_hist_precision": "int8",
       "tpu_quant_refit_leaves": False}
ROUNDS = 4
# (case, extra params, data): the JAX package's tpu_hist_impl named on
# both sides, as every parity test names it
TEXT_CASES = [
    ("int8_fused_select", {"tpu_hist_impl": "fused"}, "base"),
    ("int8_pallas2_vselect", {"tpu_hist_impl": "pallas2",
                              "tpu_partition_impl": "vselect"}, "base"),
    ("int8_pallas_select", {"tpu_hist_impl": "pallas"}, "base"),
    ("int8_xla_vselect", {"tpu_hist_impl": "xla",
                          "tpu_partition_impl": "vselect"}, "base"),
    ("int16_xla_select", {"tpu_hist_impl": "xla",
                          "tpu_hist_precision": "int16"}, "base"),
    ("int16_fused_vselect", {"tpu_hist_impl": "fused",
                             "tpu_hist_precision": "int16",
                             "tpu_partition_impl": "vselect"}, "base"),
    ("int8_packed15", {"tpu_hist_impl": "pallas2", "max_bin": 15},
     "packed"),
    ("int8_wide511", {"tpu_hist_impl": "xla", "max_bin": 511}, "wide"),
    ("int8_bagging", {"tpu_hist_impl": "fused", "bagging_fraction": 0.7,
                      "bagging_freq": 1, "feature_fraction": 0.8}, "base"),
]


def _data(kind="base", seed=5):
    """(X, regression label, binary label) of the data `kind`: "base",
    "wide" (column 6 with 300 categories) or "packed" (column 1 with 12
    categories, so that every feature fits 16 bins at max_bin=15)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 7))
    X[rng.random(X.shape) < 0.03] = np.nan
    c1 = rng.integers(-2, 12 if kind == "packed" else 30,
                      N).astype(np.float64)
    c1[rng.random(N) < 0.05] = np.nan
    c4 = rng.integers(0, 3, N)
    c6 = rng.integers(0, 300 if kind == "wide" else 12, N)
    X[:, 1], X[:, 4], X[:, 6] = c1, c4, c6
    e1, e6 = rng.normal(size=32), rng.normal(size=300)
    y = (np.nan_to_num(X[:, 0]) + e1[np.nan_to_num(c1, nan=-2).astype(int)
                                     + 2]
         + 0.6 * (c4 == 1) + 0.8 * e6[c6] + 0.2 * rng.normal(size=N))
    yb = (y + rng.logistic(size=N) * 0.5 > np.median(y)).astype(np.float64)
    return X, y, yb


def _probe_rows(X):
    """Rows that reach every categorical route of predict: NaN, negative,
    unseen, past the LUT, fractional, and seen categories."""
    P = np.repeat(X[:8], 6, axis=0)
    for j in CAT:
        P[0::6, j] = np.nan
        P[1::6, j] = -3.0
        P[2::6, j] = 1000.0
        P[3::6, j] = float(_CAT_LUT_MAX) * 4
        P[4::6, j] = 2.7
    return P


def _norm(text):
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


def _runs():
    """The trainings both packages run, keyed by name."""
    runs = {}
    for name, extra, data in TEXT_CASES:
        runs[name] = ({"params": dict(REG, **extra), "rounds": ROUNDS,
                       "cat": CAT}, data)
    runs["int8_valid"] = ({"params": dict(REG, tpu_hist_impl="xla",
                                          metric="l2"),
                           "rounds": ROUNDS, "cat": CAT, "n_train": 1500},
                          "base")
    runs["int8_frame"] = ({"params": dict(REG, tpu_hist_impl="xla"),
                           "rounds": ROUNDS, "cat": CAT, "frame": True},
                          "base")
    runs["hilo_binary"] = ({"params": dict(REG, objective="binary",
                                           tpu_hist_precision="hilo",
                                           tpu_hist_impl="xla"),
                            "rounds": ROUNDS, "cat": CAT, "label": "binary"},
                           "base")
    return runs


# ---- the split search: random histograms ------------------------------------

SPLIT_KW = dict(l1=0.0, l2=0.0, max_delta_step=0.0, min_data_in_leaf=5.0,
                min_sum_hessian=1e-3, min_gain_to_split=0.0, cat_l2=10.0,
                cat_smooth=10.0, max_cat_threshold=32, max_cat_to_onehot=4,
                min_data_per_group=20.0)
SPLIT_CASES = {
    "defaults": {},
    "ctr_ties": {"ties": True},
    "group_and_cut": {"kw": {"min_data_per_group": 60.0,
                             "max_cat_threshold": 3}},
    "regularized": {"kw": {"l1": 0.5, "l2": 1.0, "max_delta_step": 0.3,
                           "min_gain_to_split": 0.1, "cat_l2": 2.0,
                           "cat_smooth": 3.0, "max_cat_to_onehot": 8}},
}


def _split_case(c, opts):
    """Seeded [C, F, B, 3] histograms of 4 children x 7 features x 40
    bins: mixed bin counts (2 to 40) and missing types, f32 count and
    hessian sums, one masked and one penalized feature; `ties` repeats
    bins so that CTRs tie; feature 5 has too few counted bins to split."""
    rng = np.random.default_rng(100 + c)
    C, F, B = 4, 7, 40
    cnt = rng.integers(0, 120, size=(C, F, B)).astype(np.float32)
    cnt[:, 5, 1:] = rng.integers(0, 3, size=(C, B - 1))
    g = (rng.normal(size=(C, F, B)) * cnt * 0.3).astype(np.float32)
    h = (cnt * rng.uniform(0.1, 1.0, size=(C, F, B))).astype(np.float32)
    if opts.get("ties"):
        g[:, :, 1::2], h[:, :, 1::2] = g[:, :, 0::2], h[:, :, 0::2]
        cnt[:, :, 1::2] = cnt[:, :, 0::2]
    num_bin = np.array([3, 4, 40, 17, 2, 40, 9], np.int32)
    for f in range(F):
        cnt[:, f, num_bin[f]:] = g[:, f, num_bin[f]:] = 0.0
        h[:, f, num_bin[f]:] = 0.0
    hist = np.stack([g, h, cnt], axis=-1)
    kw = dict(SPLIT_KW, **opts.get("kw", {}))
    arrays = {"hist": hist, "sum_g": hist[..., 0, :, 0].sum(-1)
              .astype(np.float32),
              "sum_h": hist[..., 0, :, 1].sum(-1).astype(np.float32),
              "num_data": hist[..., 0, :, 2].sum(-1).astype(np.float32),
              "num_bin": num_bin,
              "missing_type": (np.arange(F) % 3).astype(np.int32),
              "penalty": np.array([1, 1, 0.5, 1, 1, 1, 1], np.float32),
              "feature_mask": np.array([1, 1, 1, 0, 1, 1, 1], np.float32)}
    return arrays, kw


def _port_split(arrays, kw, **extra):
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return TS.per_feature_best_split_categorical(
        t["hist"], t["sum_g"], t["sum_h"], t["num_data"], t["num_bin"],
        t["missing_type"], t["penalty"], t["feature_mask"], **kw, **extra)


# ---- the shared JAX runs ----------------------------------------------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's results, the JAX package's) of every training, the
    split cases and the cross loads."""
    tmp = tmp_path_factory.mktemp("categorical")
    X, y, yb = _data()
    Xw, yw, _ = _data("wide")
    Xp, yp, _ = _data("packed")
    runs = _runs()
    probe = _probe_rows(X)
    cases = list(SPLIT_CASES.items())
    split_in = {}
    for c, (_, opts) in enumerate(cases):
        arrays, _ = _split_case(c, opts)
        split_in.update({f"{c}_{k}": v for k, v in arrays.items()})
    split_job = start_jax_nofma(
        "cat_split", split_in,
        {"cases": [{"kw": _split_case(c, o)[1]}
                   for c, (_, o) in enumerate(cases)]}, tmp)
    names = list(runs)
    spec = []
    for name in names:
        run, data = runs[name]
        spec.append(dict(run, kind="cat", data=data,
                         label=(data if data != "base"
                                else run.get("label", "regression")),
                         probe="probe" if name == "int8_fused_select"
                         else ""))
    spec.append({"kind": "cv", "params": dict(REG, tpu_hist_impl="xla"),
                 "rounds": 3, "nfold": 3, "cat": CAT, "stratified": False,
                 "label": "regression", "return_cvbooster": True})
    jax_job = start_jax_nofma(
        "boosting", {"X": X, "X_wide": Xw, "X_packed": Xp,
                     "y_regression": y, "y_binary": yb, "y_wide": yw,
                     "y_packed": yp, "probe": probe},
        {"runs": spec}, tmp)

    port = {}
    for name in names:
        run, data = runs[name]
        Xd, yd = {"wide": (Xw, yw), "packed": (Xp, yp)}.get(data, (
            X, yb if run.get("label") == "binary" else y))
        r = dict(run, params=dict(run["params"], **CPU))
        if name == "int8_fused_select":
            r["probe"] = probe
        port[name] = cat_run(tlgb, Xd, yd, r)
    port["cv"] = cv_run(tlgb, X, y, dict(spec[-1], params=dict(
        spec[-1]["params"], **CPU)))
    # a second "boosting" job: its files go to a directory of their own
    load_dir = tmp / "load"
    load_dir.mkdir()
    load_job = start_jax_nofma(
        "boosting", {"X": X, "y_regression": y},
        {"runs": [{"kind": "load_predict", "device": "false",
                   "text": port["int8_fused_select"]["text"]}]}, load_dir)
    got = jax_job()
    ref = {name: {k[len(f"{i}_"):]: v for k, v in got.items()
                  if k.startswith(f"{i}_")} for i, name in enumerate(names)}
    ref["cv"] = (str(got[f"{len(names)}_result"]),
                 got[f"{len(names)}_raw"])
    ref["split"] = split_job()
    ref["loaded_port_raw"] = load_job()["0_raw"]
    return port, ref


# ---- binning ----------------------------------------------------------------


def _inner_pair(port_ds, jax_ds):
    return port_ds.construct()._inner, jax_ds.construct()._inner


def _assert_same_binning(pi, ji):
    assert pi.used_feature_idx == ji.used_feature_idx
    for c in pi.used_feature_idx:
        # NaN bounds compare equal here
        np.testing.assert_equal(pi.mappers[c].to_dict(),
                                ji.mappers[c].to_dict(), err_msg=str(c))
    np.testing.assert_array_equal(pi.bins, ji.bins)


@pytest.mark.parametrize("kind", ["array", "frame", "valid", "names",
                                  "lut_overflow"])
def test_mappers_and_bins_equal(kind):
    X, y, _ = _data()
    params = {"max_bin": 63, "min_data_in_bin": 3}
    tparams = dict(params, **CPU)
    cat = CAT
    if kind == "lut_overflow":
        X = X.copy()
        X[::7, 6] = _CAT_LUT_MAX + 5       # a category id past the LUT
    if kind in ("frame", "valid"):
        rows = cat_frame(X, CAT)
        pt = tlgb.Dataset(rows[:1500], label=y[:1500], params=tparams)
        jt = jlgb.Dataset(rows[:1500], label=y[:1500], params=params)
    elif kind == "names":
        names = [f"c{j}" for j in range(X.shape[1])]
        cat = [names[j] for j in CAT]
        pt = tlgb.Dataset(X, label=y, feature_name=names,
                          categorical_feature=cat, params=tparams)
        jt = jlgb.Dataset(X, label=y, feature_name=names,
                          categorical_feature=cat, params=params)
    else:
        pt = tlgb.Dataset(X, label=y, categorical_feature=cat,
                          params=tparams)
        jt = jlgb.Dataset(X, label=y, categorical_feature=cat,
                          params=params)
    pi, ji = _inner_pair(pt, jt)
    assert pi.feature_arrays()["is_categorical"].sum() == 3
    np.testing.assert_array_equal(pi.feature_arrays()["is_categorical"],
                                  ji.feature_arrays()["is_categorical"])
    _assert_same_binning(pi, ji)
    if kind == "valid":
        # another category order, an unseen category and a missing value:
        # the codes remap by value through the training tables
        rows = cat_frame(X[1500:], CAT)
        for j in CAT:
            col = rows[f"f{j}"].astype(object)
            col.iloc[0] = "unseen"
            col.iloc[1] = None
            rows[f"f{j}"] = pd.Categorical(
                col, categories=sorted(col.dropna().unique())[::-1])
        pv, jv = _inner_pair(
            tlgb.Dataset(rows, reference=pt), jlgb.Dataset(rows,
                                                           reference=jt))
        np.testing.assert_array_equal(pv.bins, jv.bins)
        assert pt.pandas_categorical == jt.pandas_categorical
    if kind == "frame":
        assert pt.pandas_categorical == jt.pandas_categorical
        assert len(pt.pandas_categorical) == 3


def test_set_categorical_feature_after_construct_raises():
    X, y, _ = _data()
    ds = tlgb.Dataset(X, label=y, params=CPU).construct()
    with pytest.raises(RuntimeError, match="categorical_feature"):
        ds.set_categorical_feature([1])
    ds2 = tlgb.Dataset(X, label=y, params=CPU).set_categorical_feature(CAT)
    assert ds2.construct()._inner.feature_arrays()[
        "is_categorical"].sum() == 3


# ---- the split search -------------------------------------------------------


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_categorical_split_bitwise(both, case):
    _, ref = both
    c = list(SPLIT_CASES).index(case)
    arrays, kw = _split_case(c, SPLIT_CASES[case])
    got = _port_split(arrays, kw)
    for name, v in got._asdict().items():
        np.testing.assert_array_equal(v.numpy(), ref["split"][f"{c}_{name}"],
                                      err_msg=name)
    # real candidates of both modes took part
    onehot = torch.from_numpy(arrays["num_bin"]) <= kw["max_cat_to_onehot"]
    assert (got.gain[:, onehot] > 0).any()
    assert (got.gain[:, ~onehot] > 0).any()


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_categorical_scan_bound_exact(case):
    c = list(SPLIT_CASES).index(case)
    arrays, kw = _split_case(c, SPLIT_CASES[case])
    B = arrays["hist"].shape[-2]
    assert TS.cat_scan_steps(kw["max_cat_threshold"], B) < B
    short = _port_split(arrays, kw)
    full = _port_split(arrays, kw, scan_steps=B)
    for a, b in zip(short, full):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---- training ---------------------------------------------------------------


@pytest.mark.parametrize("name", [c[0] for c in TEXT_CASES]
                         + ["int8_valid", "int8_frame"])
def test_int_text_byte_identical(both, name):
    port, ref = both
    got, want = port[name]["text"], str(ref[name]["text"])
    assert _norm(got) == _norm(want)
    assert re.search(r"^num_cat=[1-9]", got, flags=re.M)
    assert "decision_type=" in got
    np.testing.assert_array_equal(port[name]["raw"], ref[name]["raw"])
    assert port[name]["evals"] == str(ref[name]["evals"])


def test_packed_and_wide_layouts():
    Xp, yp, _ = _data("packed")
    Xw, yw, _ = _data("wide")
    for Xd, yd, extra, packed, dtype in (
            (Xp, yp, {"tpu_hist_impl": "pallas2", "max_bin": 15}, True,
             torch.uint8),
            (Xw, yw, {"tpu_hist_impl": "xla", "max_bin": 511}, False,
             torch.int32)):
        p = dict(REG, **CPU, **extra)
        b = tlgb.train(p, tlgb.Dataset(Xd, label=yd, categorical_feature=CAT,
                                       params={"max_bin": p["max_bin"]}),
                       1, keep_training_booster=True)
        learner = b._driver.learner
        assert learner.packed_bins == packed
        assert learner.bins_t.dtype == dtype
        assert learner.params.has_cat


def test_hilo_binary_trees_match(both):
    port, ref = both
    pt = tlgb.Booster(model_str=port["hilo_binary"]["text"], params=CPU)
    jt = tlgb.Booster(model_str=str(ref["hilo_binary"]["text"]), params=CPU)
    assert_trees_match(jt._driver.models, pt._driver.models)
    _, _, yb = _data()
    from sklearn.metrics import roc_auc_score

    a = roc_auc_score(yb, port["hilo_binary"]["raw"])
    b = roc_auc_score(yb, ref["hilo_binary"]["raw"])
    assert abs(a - b) < 1e-4 and a > 0.7


def test_device_predict_of_every_category_route(both):
    port, ref = both
    np.testing.assert_array_equal(port["int8_fused_select"]["probe_raw"],
                                  ref["int8_fused_select"]["probe_raw"])


def test_models_load_across_packages(both):
    """A JAX-saved model predicts in the port as the JAX booster that
    saved it, and the port's saved model in the JAX package as the port's
    booster.  The JAX side reads the loaded model with its host walker
    (f64 sums over the trees): its device walk of a loaded categorical
    model reads the first bitset at every categorical node (ROADMAP C)."""
    port, ref = both
    X, _, _ = _data()
    jt = tlgb.Booster(model_str=str(ref["int8_fused_select"]["text"]),
                      params=CPU)
    np.testing.assert_array_equal(jt.predict(X, raw_score=True),
                                  ref["int8_fused_select"]["raw"])
    np.testing.assert_allclose(ref["loaded_port_raw"],
                               port["int8_fused_select"]["raw"], rtol=0,
                               atol=1e-6)


def test_loaded_model_predicts_as_trained(both):
    port, _ = both
    X, _, _ = _data()
    b = tlgb.Booster(model_str=port["int8_bagging"]["text"], params=CPU)
    np.testing.assert_array_equal(b.predict(X, raw_score=True),
                                  port["int8_bagging"]["raw"])


def test_dump_and_frame_equal(both):
    port, ref = both
    for name in ("int8_fused_select", "int8_wide511"):
        got = json.loads(port[name]["dump"])
        assert got == json.loads(str(ref[name]["dump"]))
        cats = [n["threshold"] for t in got["tree_info"]
                for n in _nodes(t["tree_structure"])
                if n.get("decision_type") == "=="]
        assert cats and all("||" in c or c.isdigit() for c in cats)
        pd.testing.assert_frame_equal(
            pd.read_json(io.StringIO(port[name]["trees_frame"])),
            pd.read_json(io.StringIO(str(ref[name]["trees_frame"]))))
    infos = re.search(r"^feature_infos=(.*)$",
                      port["int8_fused_select"]["text"], re.M).group(1)
    assert infos.split()[4] == "0:1:2"


def _nodes(node):
    if "split_index" not in node:
        return []
    return [node] + _nodes(node["left_child"]) + _nodes(node["right_child"])


def test_cv_keeps_categorical_features(both):
    port, ref = both
    assert port["cv"][0] == ref["cv"][0]
    np.testing.assert_array_equal(port["cv"][1], ref["cv"][1])


def test_kernel_partition_refused_as_jax_does():
    X, y, _ = _data()
    p = dict(REG, tpu_hist_impl="xla", tpu_partition_impl="kernel")
    with pytest.raises(ValueError) as jerr:
        jlgb.train(p, jlgb.Dataset(X, label=y, categorical_feature=CAT), 1)
    with pytest.raises(ValueError) as terr:
        tlgb.train(dict(p, **CPU), tlgb.Dataset(X, label=y,
                                                categorical_feature=CAT), 1)
    assert str(terr.value) == str(jerr.value)


def test_frame_predict_remaps_categories(both):
    X, y, _ = _data()
    rows = cat_frame(X, CAT)
    b = tlgb.Booster(model_str=both[0]["int8_frame"]["text"], params=CPU)
    assert b.pandas_categorical == [list(rows[f"f{j}"].cat.categories)
                                    for j in CAT]
    # the same values under another category order predict alike
    shuffled = rows.copy()
    for j in CAT:
        col = shuffled[f"f{j}"]
        shuffled[f"f{j}"] = col.cat.reorder_categories(
            list(col.cat.categories)[::-1])
    np.testing.assert_array_equal(b.predict(shuffled, raw_score=True),
                                  b.predict(rows, raw_score=True))
    np.testing.assert_array_equal(b.predict(rows, raw_score=True),
                                  both[0]["int8_frame"]["raw"])
