"""The model utilities of lightgbm_tpu_torch against lightgbm_tpu: the
raw-value walker (models without the `tpu_bin_mappers:` trailer,
tpu_predict_device=false, pred_leaf, pred_early_stop), Booster.refit,
init_model continuation, snapshot_freq, rollback_one_iter and
reset_parameter.

The training cases run one script in both packages
(tests/test_torch_util.py:utilities_run), the JAX package's in one
process compiled without FMA (job "utilities"), started before the
port's runs.  Integer histograms and regression (exact gradients), so
the model texts are byte-identical.  The JAX side of a predict-only
comparison loads the same model text in this process and predicts on
its f64 host walker (tpu_predict_device=false).
"""

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops.predict import raw_scores_plain

from .test_torch_util import (binary_data, start_jax_nofma,
                              strip_mapper_trailer, utilities_run)

CPU = {"device_type": "cpu", "verbosity": -1}
INT8 = {"objective": "regression", "num_leaves": 7, "max_bin": 63,
        "min_data_in_leaf": 5, "tpu_hist_precision": "int8",
        "tpu_quant_refit_leaves": False, "tpu_hist_impl": "xla"}
# the JAX package's replay takes its host walk under tpu_predict_min_rows
# (4096) rows with tpu_predict_device=auto, its device walk at or above
SMALL, BIG = 1500, 5000


def _data(n, seed, cat=False):
    """Seeded rows with NaNs, a regression label and a binary one; with
    `cat`, column 0 holds categories 0-5 (some NaN, one -1)."""
    X, yb = binary_data(n=n, f=6, seed=seed)
    if cat:
        rng = np.random.default_rng(seed + 1)
        X[:, 0] = rng.integers(0, 6, n).astype(np.float64)
        X[rng.random(n) < 0.05, 0] = np.nan
        X[rng.random(n) < 0.02, 0] = -1.0
    Xn = np.nan_to_num(X)
    y = Xn[:, 1] - 0.7 * Xn[:, 2] ** 2 + 0.4 * Xn[:, 3] + np.where(
        np.nan_to_num(X[:, 0]) > 2, 0.8, -0.3)
    return X, y, yb


CASES = [
    {"name": "continue_small_path", "kind": "continue", "data": "small",
     "n_train": SMALL, "init_rounds": 4, "rounds": 3, "from": "path",
     "params": INT8},
    {"name": "continue_small_booster", "kind": "continue", "data": "small",
     "n_train": SMALL, "init_rounds": 4, "rounds": 3, "from": "booster",
     "params": INT8},
    # 35 init trees: the device walk's sum goes in windows of 32
    {"name": "continue_big_path", "kind": "continue", "data": "big",
     "n_train": BIG, "init_rounds": 35, "rounds": 2, "from": "path",
     "params": dict(INT8, num_leaves=4)},
    {"name": "continue_big_host", "kind": "continue", "data": "big",
     "n_train": BIG, "init_rounds": 4, "rounds": 2, "from": "booster",
     "params": dict(INT8, tpu_predict_device="false")},
    {"name": "snapshot", "kind": "snapshot", "data": "small", "freq": 2,
     "rounds": 4, "params": INT8},
    {"name": "rollback_gbdt", "kind": "rollback", "data": "small",
     "n_train": SMALL, "rounds": 4, "params": INT8},
    {"name": "rollback_dart", "kind": "rollback", "data": "small",
     "n_train": SMALL, "rounds": 4,
     "params": dict(INT8, boosting="dart", drop_rate=0.5, skip_drop=0.0,
                    max_drop=3)},
    {"name": "rollback_rf", "kind": "rollback", "data": "small",
     "n_train": SMALL, "rounds": 4,
     "params": dict(INT8, boosting="rf", bagging_fraction=0.7,
                    bagging_freq=1, feature_fraction=0.8)},
    {"name": "rollback_goss", "kind": "rollback", "data": "small",
     "n_train": SMALL, "rounds": 5,
     "params": dict(INT8, boosting="goss", learning_rate=0.25)},
    {"name": "reset", "kind": "reset", "data": "small", "rounds": 4,
     "params": dict(INT8, bagging_fraction=0.9, bagging_freq=1),
     "schedule": {"num_leaves": [7, 5, 9, 7],
                  "lambda_l2": [0.0, 1.0, 0.5, 0.5],
                  "feature_fraction": [1.0, 0.8, 0.8, 0.6],
                  "bagging_fraction": [0.9, 0.8, 0.7, 0.7]},
     "then": {"num_leaves": 4, "min_data_in_leaf": 20}},
    {"name": "refit", "kind": "refit", "data": "small", "n_train": SMALL,
     "rounds": 4, "decays": [0.9, 1.0], "params": INT8},
    {"name": "sklearn", "kind": "sklearn", "data": "small", "rounds": 4,
     "contrib_rows": 40, "params": INT8},
    # trees with several categorical nodes each
    {"name": "cat_continue", "kind": "cat_continue", "data": "cats",
     "init_rounds": 4, "cat": [0, 1],
     "params": dict(INT8, num_leaves=15, max_cat_to_onehot=2)},
    {"name": "walk", "kind": "walk", "data": "cat", "rounds": 8,
     "cat": [0], "params": {"objective": "binary", "num_leaves": 15,
                            "max_bin": 63, "min_data_in_leaf": 10}},
]
BY_NAME = {c["name"]: i for i, c in enumerate(CASES)}


def _inputs():
    Xs, ys, _ = _data(SMALL + 500, 3)
    Xb, yb, _ = _data(BIG + 1000, 4)
    Xc, _, yc = _data(1200, 5, cat=True)
    rng = np.random.default_rng(3)
    Xk = rng.normal(size=(3000, 4))
    Xk[:, 0] = rng.integers(0, 12, len(Xk))
    Xk[:, 1] = rng.integers(0, 9, len(Xk))
    yk = (rng.normal(size=12)[Xk[:, 0].astype(int)]
          + rng.normal(size=9)[Xk[:, 1].astype(int)] + 0.5 * Xk[:, 2])
    return {"X_small": Xs, "y_small": ys, "X_big": Xb, "y_big": yb,
            "X_cat": Xc, "y_cat": yc, "X_cats": Xk, "y_cats": yk}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's result, the JAX package's result) of each case."""
    tmp = tmp_path_factory.mktemp("utilities")
    inp = _inputs()
    jax_job = start_jax_nofma("utilities", inp, {"runs": CASES}, tmp)
    port = [utilities_run(tlgb, inp, run, str(tmp)) for run in CASES]
    out = jax_job()
    jax = [{k.split("_", 1)[1]: v for k, v in out.items()
            if k.split("_", 1)[0] == str(c)} for c in range(len(CASES))]
    return inp, port, jax


def _norm(text) -> str:
    """A model text without its device_type line (cpu on the port) and
    its output_model line (each package's own temporary directory)."""
    return "".join(line for line in str(text).splitlines(True)
                   if not line.startswith(("[device_type:",
                                           "[output_model:")))


def _case(runs, name):
    inp, port, jax = runs
    i = BY_NAME[name]
    return inp, port[i], jax[i]


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if c["kind"] == "continue"])
def test_continuation_matches(runs, name):
    _, port, jax = _case(runs, name)
    assert _norm(port["init_text"]) == _norm(jax["init_text"])
    assert _norm(port["text"]) == _norm(jax["text"])
    np.testing.assert_array_equal(port["train_scores"], jax["train_scores"])
    np.testing.assert_array_equal(port["valid_scores"], jax["valid_scores"])
    np.testing.assert_array_equal(port["curve"], jax["curve"])
    rounds = CASES[BY_NAME[name]]
    assert port["iteration"] == rounds["init_rounds"] + rounds["rounds"]


def _trees(text) -> str:
    """The tree blocks of a model text."""
    return str(text).split("\ntree_sizes=")[1].split("\nend of trees")[0]


def test_snapshots_match(runs):
    """Every snapshot_freq rounds the model as it then stands: its trees
    those of the first rounds, the last snapshot the final text."""
    _, port, jax = _case(runs, "snapshot")
    for i in (2, 4):
        assert _norm(port[f"snapshot_{i}"]) == _norm(jax[f"snapshot_{i}"])
        assert _trees(port[f"snapshot_{i}"]) == _trees(port[f"text_{i}"])
    assert port["snapshot_4"] == port["text"]
    assert _norm(port["text"]) == _norm(jax["text"])


@pytest.mark.parametrize("mode", ["gbdt", "dart", "rf", "goss"])
def test_rollback_matches(runs, mode):
    _, port, jax = _case(runs, f"rollback_{mode}")
    for key in ("before_train", "before_valid", "after_train",
                "after_valid"):
        np.testing.assert_array_equal(port[key], jax[key], err_msg=key)
    if mode != "dart":
        # the scores go back to those before the rolled-back iteration, up
        # to the f32 rounding of adding and taking away its tree; DART's
        # rollback leaves the trees its last iteration dropped and scaled
        # as they are, in both packages
        np.testing.assert_allclose(port["after_train"],
                                   port["before_train"], atol=1e-5)
    assert port["iteration"] == jax["iteration"]
    assert _norm(port["text_rolled"]) == _norm(jax["text_rolled"])
    assert _norm(port["text_next"]) == _norm(jax["text_next"])


def test_reset_parameter_matches(runs):
    _, port, jax = _case(runs, "reset")
    assert _norm(port["text"]) == _norm(jax["text"])
    # the schedule's num_leaves reached the trees
    sizes = [int(line.split("=")[1]) for line in port["text"].splitlines()
             if line.startswith("num_leaves=")]
    assert max(sizes) > 7 and sizes[-1] <= 4


@pytest.mark.parametrize("decay", [0.9, 1.0])
def test_refit_matches(runs, decay):
    _, port, jax = _case(runs, "refit")
    assert _norm(port["text"]) == _norm(jax["text"])
    assert port[f"refit_{decay}"] == str(jax[f"refit_{decay}"])
    if decay == 1.0:
        # decay 1 keeps every leaf value
        trees = [t.split("end of trees")[0].split("\nTree=0", 1)[1]
                 for t in (port["text"], port["refit_1.0"])]
        assert trees[0] == trees[1]


def test_sklearn_pred_leaf_and_contrib_match(runs):
    _, port, jax = _case(runs, "sklearn")
    assert _norm(port["text"]) == _norm(jax["text"])
    np.testing.assert_array_equal(port["leaf"], jax["leaf"])
    np.testing.assert_array_equal(port["contrib"], jax["contrib"])


def _jax_host(text, X, **kw):
    return jlgb.Booster(model_str=text).predict(
        X, tpu_predict_device=False, **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_raw_walker_matches_the_jax_host_walker(runs, writer):
    """Categorical and numerical splits with NaN, -1 and unseen values:
    scores and leaves of the stripped text, and of the whole text with
    tpu_predict_device=false, equal the JAX host walker's."""
    inp, _, jax = _case(runs, "walk")
    X = inp["X_cat"].copy()
    X[:20, 0] = 9.0                       # a category never seen
    X[20:40, 0] = -0.5                    # truncates to category 0
    if writer == "jax":
        text = str(jax["text"])
    else:
        run = CASES[BY_NAME["walk"]]
        text = tlgb.train(dict(run["params"], **CPU),
                          tlgb.Dataset(X, label=inp["y_cat"],
                                       categorical_feature=[0],
                                       params={"max_bin": 63}),
                          run["rounds"]).model_to_string()
    stripped = strip_mapper_trailer(text)
    assert "tpu_bin_mappers:" in text and "tpu_bin_mappers:" not in stripped
    want = _jax_host(text, X, raw_score=True)
    leaves = _jax_host(text, X, pred_leaf=True)
    bare = tlgb.Booster(model_str=stripped, params=CPU)
    full = tlgb.Booster(model_str=text, params=CPU)
    for got in (bare.predict(X, raw_score=True),
                full.predict(X, raw_score=True, tpu_predict_device=False),
                tlgb.Booster(model_str=text, params=dict(
                    CPU, tpu_predict_device="false")).predict(
                        X, raw_score=True)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bare.predict(X, pred_leaf=True), leaves)
    np.testing.assert_array_equal(full.predict(X, pred_leaf=True), leaves)
    assert leaves.dtype == np.int32
    # the plain twin, and a num_iteration subset
    np.testing.assert_array_equal(
        want, raw_scores_plain(bare._driver.models, X, 1)[0])
    np.testing.assert_array_equal(
        bare.predict(X, raw_score=True, num_iteration=3),
        _jax_host(text, X, raw_score=True, num_iteration=3))


def test_raw_walker_matches_the_bin_space_walk():
    """The port's own model: the f64 raw walk within 1e-6 of its f32
    bin-space walk, its leaves those of the bin-space leaf index."""
    X, _, yb = _data(2000, 8, cat=True)
    b = tlgb.train(dict(num_leaves=15, max_bin=63, objective="binary",
                        **CPU),
                   tlgb.Dataset(X, label=yb, categorical_feature=[0]), 6,
                   keep_training_booster=True)
    raw = b.predict(X, raw_score=True, tpu_predict_device=False)
    dev = b.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, dev, atol=1e-6)
    np.testing.assert_array_equal(
        b.predict(X, raw_score=True, tpu_predict_device="false"), raw)
    # a scipy matrix takes the same routes, a binned Dataset none
    import scipy.sparse as sp

    csr = sp.csr_matrix(np.nan_to_num(X))
    for kw in ({"pred_leaf": True}, {"raw_score": True,
                                     "tpu_predict_device": False}):
        np.testing.assert_array_equal(b.predict(csr, **kw),
                                      b.predict(np.nan_to_num(X), **kw))
    ds = tlgb.Dataset(X, label=yb, reference=b._train_set)
    with pytest.raises(TypeError, match="native path"):
        b.predict(ds, tpu_predict_device=False)
    # a model trained with tpu_predict_device=false predicts on the walker
    bf = tlgb.train(dict(num_leaves=15, max_bin=63, objective="binary",
                         tpu_predict_device="false", **CPU),
                    tlgb.Dataset(X, label=yb, categorical_feature=[0]), 6)
    np.testing.assert_array_equal(
        bf.predict(X, raw_score=True),
        _jax_host(bf.model_to_string(), X, raw_score=True))


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_early_stop_matches_the_jax_walker(objective):
    X, y, yb = _data(1500, 9)
    label = yb if objective == "binary" else np.digitize(
        y, np.quantile(y, [0.33, 0.66])).astype(np.float64)
    params = dict(objective=objective, num_leaves=15, max_bin=63,
                  learning_rate=0.3, **CPU)
    if objective == "multiclass":
        params["num_class"] = 3
    b = tlgb.train(params, tlgb.Dataset(X, label=label), 10)
    text = b.model_to_string()
    kw = {"pred_early_stop": True, "pred_early_stop_freq": 2,
          "pred_early_stop_margin": 1.5}
    got = b.predict(X, raw_score=True, **kw)
    np.testing.assert_array_equal(got, _jax_host(text, X, raw_score=True,
                                                 **kw))
    full = b.predict(X, raw_score=True, tpu_predict_device=False)
    stopped = (got != full).any(axis=-1) if got.ndim == 2 else got != full
    assert 0.0 < stopped.mean() < 1.0
    k = 3 if objective == "multiclass" else 1
    plain = raw_scores_plain(b._driver.models, X, k, 2, 1.5)
    np.testing.assert_array_equal(got, plain[0] if k == 1 else plain.T)
    # converted outputs equal the JAX walker's too
    np.testing.assert_array_equal(b.predict(X, **kw),
                                  _jax_host(text, X, **kw))


def test_categorical_continuation_replays_its_init_model(runs):
    """The port's categorical continuation is held to its own predict of
    the init model: the replayed train scores are the init booster's raw
    scores on the training rows (the bitset index of every categorical
    node is set at the rebinding).  The JAX package's replay reads each
    tree's first bitset at every categorical node (ROADMAP C), so its
    scores differ wherever a tree has several: that fault is not
    copied."""
    _, port, jax = _case(runs, "cat_continue")
    assert _norm(port["text"]) == _norm(jax["text"])
    assert max(int(line.split("=")[1]) for line in port["text"].splitlines()
               if line.startswith("num_cat=")) > 1
    np.testing.assert_allclose(port["train_scores"][0], port["init_raw"],
                               atol=1e-6)
    assert np.abs(jax["train_scores"][0] - jax["init_raw"]).max() > 0.1
    X, y, _ = _data(1200, 11, cat=True)
    params = dict(INT8, **CPU)
    init = tlgb.train(params, tlgb.Dataset(X, label=y,
                                           categorical_feature=[0]), 4)
    for device_walk in ("auto", "true"):
        b = tlgb.train(dict(params, tpu_predict_device=device_walk),
                       tlgb.Dataset(X, label=y, categorical_feature=[0]), 0,
                       init_model=init, keep_training_booster=True)
        np.testing.assert_array_equal(
            b._driver.train_scores.numpy()[0],
            init.predict(X, raw_score=True).astype(np.float32))
        assert b.current_iteration() == 4 and b.num_trees() == 4
    more = tlgb.train(params, tlgb.Dataset(X, label=y,
                                           categorical_feature=[0]), 2,
                      init_model=init)
    assert more.num_trees() == 6


def test_init_model_checks_the_trees_per_iteration():
    X, y, yb = _data(600, 12)
    multi = tlgb.train(dict(objective="multiclass", num_class=3, **CPU),
                       tlgb.Dataset(X, label=np.digitize(y, [0.0, 1.0])
                                    .astype(float)), 2)
    with pytest.raises(ValueError, match="num_tree_per_iteration"):
        tlgb.train(dict(objective="regression", **CPU),
                   tlgb.Dataset(X, label=y), 1, init_model=multi)


def test_sklearn_fit_passes_init_model_through():
    """fit(init_model=...) continues as lgb.train(init_model=...) does."""
    X, y, _ = _data(800, 13)
    init = tlgb.train(dict(INT8, **CPU), tlgb.Dataset(X, label=y), 3)
    kw = dict(INT8, **CPU)
    kw.pop("objective")
    m = tlgb.LGBMRegressor(n_estimators=2, **kw).fit(X, y, init_model=init)
    want = tlgb.train(dict(m._prepare_params()), tlgb.Dataset(X, label=y),
                      2, init_model=init)
    assert m.booster_.num_trees() == 5
    assert m.booster_.model_to_string() == want.model_to_string()
