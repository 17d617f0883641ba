"""The objective zoo of lightgbm_tpu_torch (models/objectives_ext.py)
against lightgbm_tpu.

2,000 rows x 6 features with NaNs, 63 bins, 15 leaves, 512-row blocks,
`tpu_hist_impl=xla` on both sides; the JAX package's trainings run in
one process compiled without FMA (job "boosting", kind "zoo" of
tests/test_torch_util.py), the port's on the CPU, both through
`zoo_run`.

- Gradients, on seeded scores and labels, with and without weights: the
  objectives with exact gradients (regression_l1, huber, fair, quantile,
  mape) and both ranking objectives bit-equal; for the exp family
  (poisson, gamma, tweedie, multiclass, multiclassova, cross_entropy,
  cross_entropy_lambda) every exp and log1p within 2 ulps of XLA's (the
  binary objective's rule, tests/test_torch_slice.py), and the
  gradients bit-equal with XLA's exp and log1p values put in.
- Model text, int8 and int16 with the leaf refit off: byte-identical for
  the exact objectives and the ranking ones (queries of 5 to 30 rows),
  for GOSS (the host sampler) and RF (the refit against the constant
  init scores) with regression_l1, and for binary data with a single
  label class.
- The exp family under hilo: the first iteration's trees take the same
  splits (default_left up to an f32 tie at nodes no missing row
  reaches), and the models' training metric agrees within 1e-4 of it.
- Multiclass (k = 3) predict of a JAX-trained model at 10 and 70 trees a
  class: the port's raw scores equal the JAX package's device predict.
- lambdarank with a validation set and early stopping on ndcg@1..5, and
  lgb.cv with group folds: the curves and results equal.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.models.objectives import create_objective as j_objective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.models.metrics import create_metrics
from lightgbm_tpu_torch.models.objectives import create_objective as t_objective

from .test_torch_util import cv_run, start_jax_nofma, zoo_run

N, F = 2000, 6
BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 5,
        "verbosity": -1, "tpu_block_rows": 512, "tpu_hist_impl": "xla",
        "tpu_quant_refit_leaves": False}
EXACT = ("regression_l1", "huber", "fair", "quantile", "mape", "lambdarank",
         "rank_xendcg")
EXP_FAMILY = ("poisson", "gamma", "tweedie", "multiclass", "multiclassova",
              "cross_entropy", "cross_entropy_lambda")
# each objective's label (a key of _data's labels) and extra params
SETUP = {"regression_l1": ("reg", {}), "huber": ("reg", {"alpha": 0.7}),
         "fair": ("reg", {}), "quantile": ("reg", {"alpha": 0.3}),
         "mape": ("reg", {}), "poisson": ("pos", {}), "gamma": ("pos", {}),
         "tweedie": ("pos", {}), "multiclass": ("cls", {"num_class": 3}),
         "multiclassova": ("cls", {"num_class": 3}),
         "cross_entropy": ("p01", {}), "cross_entropy_lambda": ("p01", {}),
         "lambdarank": ("rel", {}), "rank_xendcg": ("rel", {})}
RANKING = ("lambdarank", "rank_xendcg")
ROUNDS = 5


def _groups(n, seed):
    """Query sizes of 5 to 30 rows covering n rows."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.integers(5, 31)))
    sizes[-1] -= sum(sizes) - n
    if sizes[-1] <= 0:
        sizes[-2] += sizes.pop()
    return sizes


GROUP = _groups(N, 3)


def _data():
    rng = np.random.default_rng(17)
    X = rng.normal(size=(N, F))
    X[rng.random(X.shape) < 0.03] = np.nan
    Xn = np.nan_to_num(X)
    lat = Xn[:, 0] + 0.5 * Xn[:, 1] * Xn[:, 2] + 0.3 * rng.normal(size=N)
    cuts = np.quantile(lat, [0.2, 0.4, 0.6, 0.8])
    ys = {"reg": lat,
          "pos": np.exp(0.5 * lat),
          "p01": 1.0 / (1.0 + np.exp(-lat)),
          "cls": np.digitize(lat, cuts[1:3]).astype(np.float64),
          "rel": np.digitize(lat, cuts).astype(np.float64),
          "ones": np.ones(N)}
    return X, ys


def _run(objective, prec, **extra):
    label, p = SETUP.get(objective, ("ones", {}))
    params = dict(BASE, objective=objective, tpu_hist_precision=prec, **p)
    params.update(extra.pop("params", {}))
    run = dict(params=params, rounds=ROUNDS, label=label, **extra)
    if objective in RANKING:
        run["group"] = GROUP
    return run


def _runs():
    runs = {}
    for obj in EXACT:
        for prec in ("int8", "int16"):
            runs[f"{obj}_{prec}"] = _run(obj, prec)
    runs["goss_regression_l1_int8"] = _run(
        "regression_l1", "int8",
        params={"boosting": "goss", "learning_rate": 0.34})
    runs["single_class_int8"] = _run("binary", "int8")
    runs["rf_regression_l1_int8"] = _run(
        "regression_l1", "int8",
        params={"boosting": "rf", "bagging_fraction": 0.7,
                "bagging_freq": 1})
    for obj in EXP_FAMILY:
        runs[f"{obj}_hilo"] = _run(obj, "hilo")
    runs["multiclass_predict"] = _run(
        "multiclass", "hilo", params={"num_leaves": 7},
        predict_iterations=[10, 70])
    runs["multiclass_predict"]["rounds"] = 70
    # 1,600 training rows (whole queries), the rest validate
    runs["lambdarank_valid_int8"] = _run(
        "lambdarank", "int8", n_train=1600, early_stopping_rounds=2,
        params={"learning_rate": 0.5})
    runs["lambdarank_valid_int8"]["rounds"] = 30
    return runs


RUNS = _runs()
CV_RUN = {"params": dict(BASE, objective="lambdarank",
                         tpu_hist_precision="int8", eval_at=[1, 3]),
          "rounds": 3, "nfold": 3, "group": GROUP}


def _norm(text):
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's runs, the JAX package's): every JAX run in one process
    without FMA, which works while the port trains on the CPU."""
    X, ys = _data()
    runs = [dict(run, kind="zoo") for run in RUNS.values()]
    runs.append(dict(CV_RUN, kind="cv", label="rel"))
    wait = start_jax_nofma("boosting", {"X": X, **{"y_" + k: v
                                                  for k, v in ys.items()}},
                           {"runs": runs}, tmp_path_factory.mktemp("zoo"))
    port = {}
    for name, run in RUNS.items():
        if name == "multiclass_predict":
            continue
        run = dict(run, params=dict(run["params"], device_type="cpu"))
        port[name] = zoo_run(tlgb, X, ys[run["label"]], run)
    port["cv"] = cv_run(tlgb, X, ys["rel"], dict(
        CV_RUN, params=dict(CV_RUN["params"], device_type="cpu")))
    got = wait()
    ref = {}
    for c, name in enumerate(RUNS):
        ref[name] = {k[len(f"{c}_"):]: v for k, v in got.items()
                     if k.startswith(f"{c}_")}
    ref["cv"] = str(got[f"{len(RUNS)}_result"])
    return port, ref


@pytest.fixture(scope="module")
def port(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_ref(both):
    return both[1]


def _gradient_inputs(objective, weighted):
    rng = np.random.default_rng(5)
    n = 1000
    _, ys = _data()
    label = ys[SETUP[objective][0]][:n].astype(np.float32)
    k = 3 if objective.startswith("multiclass") else 1
    score = (rng.normal(size=(k, n)) * 2).astype(np.float32)
    weight = (rng.random(n) * 2 + 0.1).astype(np.float32) if weighted \
        else None
    group = None
    if objective in RANKING:
        group = np.asarray(_groups(n, 4))
    return label, score, weight, group


def _gradients(objective, weighted):
    label, score, weight, group = _gradient_inputs(objective, weighted)
    n = len(label)
    params = dict(objective=objective, **SETUP[objective][1])
    oj = j_objective(jlgb.Config(params))
    oj.init(JMetadata(n, label, weight, group), n)
    gj, hj = (np.asarray(v).reshape(score.shape)
              for v in oj.get_gradients(jnp.asarray(score)))
    ot = t_objective(TConfig(params))
    ot.init(TMetadata(n, label, weight, group), n, torch.device("cpu"))
    gt, ht = (v.numpy().reshape(score.shape)
              for v in ot.get_gradients(torch.from_numpy(score)))
    assert gt.dtype == ht.dtype == np.float32
    for c in range(score.shape[0]):
        assert ot.boost_from_score(c) == oj.boost_from_score(c)
        assert ot.class_need_train(c) == oj.class_need_train(c)
    assert ot.to_model_string() == oj.to_model_string()
    assert (ot.needs_renew, ot.host_only) == (oj.needs_renew, oj.host_only)
    return gt, ht, gj, hj


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("objective", EXACT)
def test_exact_gradients_bit_equal(objective, weighted):
    gt, ht, gj, hj = _gradients(objective, weighted)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(ht, hj)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("objective", EXP_FAMILY)
def test_exp_family_gradients_match(objective, weighted, monkeypatch):
    # torch's exp and log1p may differ from XLA's in the last ulp (the
    # binary objective's rule, tests/test_torch_slice.py); these formulas
    # then cancel (poisson's e^s - y, tweedie's two exp terms), so the
    # rule is held where the difference arises: every exp and log1p the
    # port takes is within 2 ulps of XLA's on the same argument, and with
    # XLA's values put in their place the gradients are bit-equal
    seen = []

    def via_jax(name):
        real, ref = getattr(torch, name), getattr(jnp, name)

        def f(x):
            want = np.asarray(ref(jnp.asarray(x.numpy())))
            seen.append((real(x).numpy(), want))
            return torch.from_numpy(want.copy())
        return f

    monkeypatch.setattr(torch, "exp", via_jax("exp"))
    monkeypatch.setattr(torch, "log1p", via_jax("log1p"))
    gt, ht, gj, hj = _gradients(objective, weighted)
    monkeypatch.undo()
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(ht, hj)
    assert seen
    tiny = np.finfo(np.float32).tiny
    for got, want in seen:
        normal = np.isfinite(want) & (np.abs(want) >= tiny)
        assert (np.abs(got - want)[normal]
                <= 2 * np.spacing(np.abs(want[normal]))).all()
        np.testing.assert_array_equal(got[~normal], want[~normal])


TEXT_CASES = [f"{o}_{p}" for o in EXACT for p in ("int8", "int16")] + [
    "goss_regression_l1_int8", "rf_regression_l1_int8", "single_class_int8"]


@pytest.mark.parametrize("name", TEXT_CASES)
def test_text_byte_identical(port, jax_ref, name):
    assert _norm(port[name]["text"]) == _norm(str(jax_ref[name]["text"]))
    np.testing.assert_array_equal(port[name]["raw"], jax_ref[name]["raw"])


def test_single_class_keeps_one_constant_tree(port):
    b = tlgb.Booster(model_str=port["single_class_int8"]["text"],
                     params={"device_type": "cpu"})
    assert b.num_trees() == 1
    assert b._driver.models[0].num_leaves == 1


def _metric(objective, raw, label):
    """The objective's default metric of raw scores ([n] or [n, k])."""
    params = dict(objective=objective, **SETUP[objective][1])
    cfg = TConfig(params)
    obj = t_objective(cfg)
    obj.init(TMetadata(N, label), N, torch.device("cpu"))
    (m,) = create_metrics(cfg, objective)
    m.init(TMetadata(N, label), N)
    return m.eval(np.asarray(raw, np.float64).reshape(N, -1).T, obj)


@pytest.mark.parametrize("objective", EXP_FAMILY)
def test_exp_family_trees_agree(port, jax_ref, objective):
    # the first iteration's trees take the JAX trees' splits: the same
    # features, bins, children and leaf counts, and decision types up to
    # default_left, which an f32 tie between the two missing directions
    # may flip at a node no row missing the feature reaches (ROADMAP
    # findings).  Later trees grow on scores whose exp differed in the
    # last ulp, and a near-tie of two gains can then pick another bin
    # (multiclass, class 0 of the fifth iteration, here), so the whole
    # models are held by their training metric, within 1e-4 of it
    name = f"{objective}_hilo"
    dev = {"device_type": "cpu"}
    bt = tlgb.Booster(model_str=port[name]["text"], params=dev)
    bj = tlgb.Booster(model_str=str(jax_ref[name]["text"]), params=dev)
    k = bt.num_model_per_iteration()
    assert bt.num_trees() == bj.num_trees() == ROUNDS * k
    for i in range(k):
        a, b = bj._driver.models[i], bt._driver.models[i]
        assert b.num_leaves == a.num_leaves, i
        ni, nl = a.num_leaves - 1, a.num_leaves
        for field in ("split_feature", "threshold_in_bin", "left_child",
                      "right_child"):
            np.testing.assert_array_equal(getattr(b, field)[:ni],
                                          getattr(a, field)[:ni],
                                          err_msg=f"tree {i} {field}")
        np.testing.assert_array_equal(b.decision_type[:ni] & ~2,
                                      a.decision_type[:ni] & ~2)
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
    _, ys = _data()
    label = ys[SETUP[objective][0]]
    got = _metric(objective, port[name]["raw"], label)
    want = _metric(objective, jax_ref[name]["raw"], label)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


@pytest.mark.parametrize("iterations", [10, 70])
def test_multiclass_predict_equals_jax_device_predict(jax_ref, iterations):
    X, _ = _data()
    ref = jax_ref["multiclass_predict"]
    b = tlgb.Booster(model_str=str(ref["text"]),
                     params={"device_type": "cpu"})
    assert b.num_trees() == 3 * 70
    got = b.predict(X, raw_score=True, num_iteration=iterations)
    assert got.shape == (N, 3)
    np.testing.assert_array_equal(got, ref[f"raw_{iterations}"])


def test_lambdarank_early_stopping_on_ndcg_equal(port, jax_ref):
    got, want = port["lambdarank_valid_int8"], jax_ref["lambdarank_valid_int8"]
    evals = json.loads(got["evals"])
    assert sorted(evals["valid_0"]) == [f"ndcg@{k}" for k in range(1, 6)]
    assert evals == json.loads(str(want["evals"]))
    assert int(got["best_iteration"]) == int(want["best_iteration"])
    assert 0 < int(got["best_iteration"]) < 30
    assert _norm(got["text"]) == _norm(str(want["text"]))


def test_lambdarank_cv_group_folds_equal(port, jax_ref):
    res, _ = port["cv"]
    assert json.loads(res) == json.loads(jax_ref["cv"])
    assert sorted(json.loads(res)) == ["ndcg@1-mean", "ndcg@1-stdv",
                                       "ndcg@3-mean", "ndcg@3-stdv"]


def test_dataset_group_round_trip():
    X, ys = _data()
    ds = tlgb.Dataset(X, label=ys["rel"], group=GROUP,
                      params={"device_type": "cpu"})
    np.testing.assert_array_equal(ds.get_group(), GROUP)
    np.testing.assert_array_equal(ds.get_field("group"),
                                  np.concatenate([[0], np.cumsum(GROUP)]))
    sub = ds.subset(np.arange(GROUP[0], GROUP[0] + GROUP[1] + GROUP[2]))
    np.testing.assert_array_equal(sub.get_group(), GROUP[1:3])
    ds.set_group(GROUP[::-1])
    np.testing.assert_array_equal(ds.get_group(), GROUP[::-1])


def _softmax_fobj(seen):
    def fobj(scores, train_set):
        seen.append(("fobj", scores.shape))
        p = np.exp(scores - scores.max(axis=0))
        p /= p.sum(axis=0)
        onehot = np.arange(3)[:, None] == train_set.get_label()[None, :]
        return p - onehot, 2.0 * p * (1.0 - p)
    return fobj


def _feval(seen):
    def feval(preds, data):
        seen.append(("feval", preds.shape, preds.copy()))
        return "zero", 0.0, False
    return feval


@pytest.mark.parametrize("lgb", [jlgb, tlgb], ids=["jax", "port"])
def test_multiclass_fobj_and_feval_layout(lgb):
    # fobj sees the [k, n] scores, feval the [k * n] class-major ones, as
    # the JAX package hands them over
    X, ys = _data()
    X, y = X[:600], ys["cls"][:600]
    seen = []
    params = dict(BASE, objective="none", num_class=3, num_leaves=7,
                  tpu_hist_precision="hilo")
    if lgb is tlgb:
        params["device_type"] = "cpu"
    train = lgb.Dataset(X, label=y, params={"max_bin": 63})
    b = lgb.train(params, train, 2, fobj=_softmax_fobj(seen),
                  feval=_feval(seen), valid_sets=[train],
                  keep_training_booster=True)
    assert [s[:2] for s in seen] == [("fobj", (3, 600)),
                                     ("feval", (1800,))] * 2
    kw = {} if lgb is tlgb else {"tpu_predict_device": "true"}
    np.testing.assert_allclose(
        seen[-1][2].reshape(3, 600).T, b.predict(X, raw_score=True, **kw),
        rtol=0, atol=1e-6)
