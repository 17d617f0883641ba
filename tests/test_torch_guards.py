"""Guards of lightgbm_tpu_torch: what it imports, where it runs, what it
refuses, and the two ways a model carries over from lightgbm_tpu."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.predict import pack_trees as j_pack_trees
from lightgbm_tpu_torch.convert import booster_from_arrays

from .test_torch_util import assert_trees_match, binary_data

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = {"device_type": "cpu", "verbosity": -1}
SMALL = {"objective": "binary", "num_leaves": 7, "max_bin": 15,
         "min_data_in_leaf": 10, "tpu_pack_bins": False}


def _port_sources():
    # the package, the smoke, the probes of the card and the two-process
    # tests' worker (it runs without JAX)
    files = sorted((ROOT / "lightgbm_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "tests" /
                    "torch_mp_worker.py"] + sorted(
                        (ROOT / "probes").glob("*.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    top = module.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "lightgbm_tpu"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_training_without_cuda_raises_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    X, y = binary_data(n=300, f=3)
    for extra in ({}, {"device_type": "gpu"}, {"device": "cuda"},
                  {"device_type": "tpu"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            tlgb.train(dict(SMALL, **extra), tlgb.Dataset(X, label=y),
                       num_boost_round=1)
    # the alias `device` selects the CPU like device_type does
    b = tlgb.train(dict(SMALL, device="cpu"), tlgb.Dataset(X, label=y),
                   num_boost_round=1)
    assert b.num_trees() == 1


OUT_OF_SLICE = [
    {"tpu_sparse_threshold": 0.5, "enable_bundle": False},
    {"tpu_hist_impl": "fused", "tpu_partition_impl": "gather"},
    {"tpu_partition_impl": "gather"},
]

# once refused: the JAX package's telemetry (tpu_telemetry,
# tpu_trace_dir), which now trains (tests/test_torch_telemetry.py holds
# it to the JAX package)
TELEMETRY = [
    {"tpu_telemetry": "trace"},
    {"tpu_trace_dir": "traces"},
]

# once refused: the streamed layout, which now trains as the JAX
# package's (tests/test_torch_stream.py holds it closer)
STREAMED = [{"tpu_stream_mode": "streamed"},
            {"tpu_stream_mode": "streamed", "tpu_stream_block_rows": 128}]

# once refused with the telemetry knobs: the numeric guard, the memory
# preflight and the budget, which now train as the JAX package's
GUARD_AND_MEMORY = [
    {"tpu_guard_numerics": "warn"},
    {"tpu_guard_numerics": "skip"},
    {"tpu_hbm_preflight": "raise"},
    {"tpu_hbm_preflight": "degrade"},
    {"tpu_hbm_budget_bytes": 1000},
]


# once refused: the sharded tree learners with num_machines > 1, which
# now train in one process (tests/test_torch_parallel.py holds them to the
# JAX package)
SHARDED = [{"tree_learner": "data", "num_machines": 2},
           {"tree_learner": "feature", "num_machines": 2},
           {"tree_learner": "voting", "num_machines": 2},
           {"tree_learner": "data_feature", "num_machines": 4,
            "tpu_topology_hosts": 2}]

# once refused under a sharded learner (ROADMAP A9c), now trained
# (tests/test_torch_parallel_features.py holds them to the JAX package):
# the parameters the case adds, and the Dataset's own arguments
SHARDED_FEATURES = {
    "sparse": ({"tpu_sparse_threshold": 0.5, "enable_bundle": False}, {}),
    "cegb": ({"cegb_penalty_split": 0.001}, {}),
    "forced": ({"forcedsplits_filename": "forced.json"}, {}),
    "monotone": ({"monotone_constraints": [1, 0, 0]}, {}),
    "bynode": ({"feature_fraction_bynode": 0.5}, {}),
    "deterministic": ({"deterministic": True}, {}),
    "categorical": ({}, {"categorical_feature": [0]}),
}

# what a sharded learner refuses, as the JAX learner does: the parameters
# the case adds, the message it gives, and the Dataset's own arguments.
# A machine list of several hosts and EFB bundles under data, once
# refused here, now train (tests/test_torch_multiprocess.py)
SHARDED_REFUSALS = {
    "streamed": ({"tpu_stream_mode": "streamed"},
                 "tpu_stream_mode=streamed requires tree_learner=serial",
                 {}),
    "lazy_cegb": ({"cegb_penalty_feature_lazy": [1.0, 0.0, 0.0]},
                  "cegb_penalty_feature_lazy requires tree_learner=serial",
                  {}),
}


# cases that the port now takes, and that raise where the JAX package
# raises: the parameters the case adds, and the JAX exception's class
JAX_REFUSALS = {
    # sparse storage is float only (learner.py:304-311)
    "tpu_sparse_threshold": ({"tpu_hist_precision": "int8"}, ValueError),
}


@pytest.mark.parametrize("extra", OUT_OF_SLICE, ids=lambda d: ",".join(d))
def test_out_of_slice_parameters_raise(extra):
    # 512 rows where the case packs: the JAX learner packs only row blocks
    # of a multiple of 256 rows (300 rows pad to one block of 384)
    n = 512 if extra.get("tpu_pack_bins") else 300
    X, y = binary_data(n=n, f=3, seed=1)
    params = dict(SMALL, **CPU, **extra)
    name = next(iter(extra))
    if name in JAX_REFUSALS:
        more, exc = JAX_REFUSALS[name]
        params.update(more)
        with pytest.raises(exc) as want:
            jlgb.train(dict(params, device_type="tpu"),
                       jlgb.Dataset(X, label=y), num_boost_round=1)
        with pytest.raises(exc) as got:
            tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=1)
        assert str(got.value) == str(want.value)
        return
    with pytest.raises(NotImplementedError, match=name.split("_")[0]):
        tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=1)


@pytest.mark.parametrize("extra", SHARDED, ids=lambda d: d["tree_learner"])
def test_sharded_learners_train(extra):
    X, y = binary_data(n=600, f=3, seed=1)
    b = tlgb.train(dict(SMALL, **CPU, **extra), tlgb.Dataset(X, label=y),
                   num_boost_round=2)
    assert b.num_trees() == 2
    assert np.isfinite(b.predict(X)).all()


def _sharded_case(extra, tmp_path, monkeypatch, categorical):
    """(params, X, y) of a data learner over two shards with the case's
    parameters, in tmp_path (which holds the forced splits' file)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "forced.json").write_text(
        '{"feature": 0, "threshold": 0.0}')
    X, y = binary_data(n=600, f=3, seed=1)
    if categorical:
        X[:, 0] = np.abs(np.nan_to_num(np.round(X[:, 0] * 2)))
    params = dict(SMALL, **CPU, tree_learner="data", num_machines=2,
                  **extra)
    return params, X, y


@pytest.mark.parametrize("case", list(SHARDED_FEATURES))
def test_sharded_learner_features_train(case, tmp_path, monkeypatch):
    extra, ds_kw = SHARDED_FEATURES[case]
    params, X, y = _sharded_case(extra, tmp_path, monkeypatch,
                                 case == "categorical")
    b = tlgb.train(params, tlgb.Dataset(X, label=y, params=params, **ds_kw),
                   num_boost_round=2)
    assert b.num_trees() == 2
    assert np.isfinite(b.predict(X)).all()


@pytest.mark.parametrize("case", list(SHARDED_REFUSALS))
def test_sharded_learner_refusals_name_what(case, tmp_path, monkeypatch):
    extra, what, ds_kw = SHARDED_REFUSALS[case]
    params, X, y = _sharded_case(extra, tmp_path, monkeypatch, False)
    with pytest.raises(NotImplementedError, match=what):
        tlgb.train(params, tlgb.Dataset(X, label=y, params=params, **ds_kw),
                   num_boost_round=1)


def test_sharded_sparse_storage_keeps_the_jax_refusals():
    """Before its own refusal, sparse storage under a sharded learner
    raises what the JAX learner raises (learner.py:303-325)."""
    X, y = binary_data(n=600, f=3, seed=1)
    params = dict(SMALL, **CPU, tree_learner="data", num_machines=2,
                  tpu_sparse_threshold=0.5, tpu_hist_precision="int8")
    with pytest.raises(ValueError, match="quantized histogram precisions"):
        tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=1)


@pytest.mark.parametrize("extra", STREAMED,
                         ids=lambda d: ",".join(f"{k}={v}"
                                                for k, v in d.items()))
def test_streamed_layout_trains_as_the_jax_package(extra):
    """The case `test_out_of_slice_parameters_raise` refused before the
    port had the streamed layout: the same trees as the JAX package's
    streamed run (one block of 384 rows, and three of 128)."""
    X, y = binary_data(n=300, f=3, seed=1)
    got = [lgb.train(dict(SMALL, **p, **extra), lgb.Dataset(X, label=y), 2,
                     keep_training_booster=True)
           for lgb, p in ((jlgb, {"verbosity": -1}), (tlgb, CPU))]
    for b in got:
        assert type(b._driver.learner).__name__ == "StreamedTreeLearner"
    assert_trees_match(got[0]._driver.models, got[1]._driver.models)


@pytest.mark.parametrize("extra", GUARD_AND_MEMORY,
                         ids=lambda d: ",".join(d))
def test_guard_and_memory_knobs_train_as_the_jax_package(extra):
    """Without a tight budget each knob trains, the same trees in both
    packages (no budget resolves on the CPU unless one is given; the
    budget's own case pins the resident layout: the next test takes it
    streamed)."""
    X, y = binary_data(n=300, f=3, seed=1)
    extra = dict(extra)
    if "tpu_hbm_budget_bytes" in extra:
        extra["tpu_stream_mode"] = "resident"
    got = [lgb.train(dict(SMALL, **p, **extra), lgb.Dataset(X, label=y), 2)
           for lgb, p in ((jlgb, {"verbosity": -1}), (tlgb, CPU))]
    assert_trees_match(got[0]._driver.models, got[1]._driver.models)


@pytest.mark.parametrize("extra", GUARD_AND_MEMORY,
                         ids=lambda d: ",".join(d))
def test_guard_and_memory_knobs_under_a_tight_budget(extra):
    """Under a 1,000-byte budget: preflight raise and degrade refuse, as
    the JAX package's do (degrade finds no rung that fits); warn trains.
    Left on auto, the layout streams in both packages, as `select_layout`
    says (the 900-byte matrix is over half the budget): the same trees."""
    X, y = binary_data(n=300, f=3, seed=1)
    params = dict(SMALL, tpu_hbm_budget_bytes=1000,
                  tpu_stream_mode="resident")
    params.update(extra)
    if "tpu_hbm_budget_bytes" in extra:
        del params["tpu_stream_mode"]
        got = [lgb.train(dict(params, **p), lgb.Dataset(X, label=y), 2,
                         keep_training_booster=True)
               for lgb, p in ((jlgb, {"verbosity": -1}), (tlgb, CPU))]
        for b in got:
            assert type(b._driver.learner).__name__ == "StreamedTreeLearner"
        assert_trees_match(got[0]._driver.models, got[1]._driver.models)
        return
    if extra.get("tpu_hbm_preflight") in ("raise", "degrade"):
        for lgb, p in ((jlgb, {"verbosity": -1}), (tlgb, CPU)):
            with pytest.raises(lgb.LightGBMError, match="headroom"):
                lgb.train(dict(params, **p), lgb.Dataset(X, label=y), 1)
        return
    got = [lgb.train(dict(params, **p), lgb.Dataset(X, label=y), 2)
           for lgb, p in ((jlgb, {"verbosity": -1}), (tlgb, CPU))]
    assert_trees_match(got[0]._driver.models, got[1]._driver.models)


@pytest.mark.parametrize("extra", TELEMETRY, ids=lambda d: ",".join(d))
def test_telemetry_knobs_train_on_the_cpu(extra, tmp_path, monkeypatch):
    from lightgbm_tpu_torch import obs

    monkeypatch.chdir(tmp_path)
    X, y = binary_data(n=300, f=3, seed=1)
    try:
        b = tlgb.train(dict(SMALL, **CPU, **extra),
                       tlgb.Dataset(X, label=y), 2)
        assert b.num_trees() == 2
        assert obs.mode() == extra.get("tpu_telemetry", "off")
    finally:
        obs.configure(mode="off", trace_dir="")
        obs.flush()
        obs.reset_events()
    if "tpu_trace_dir" in extra:
        # a directory alone traces nothing
        assert not (tmp_path / "traces").exists()


@pytest.mark.parametrize("extra", [{"tpu_telemetry": "bogus"},
                                   {"tpu_telemetry": "full"}],
                         ids=lambda d: ",".join(f"{k}={v}"
                                                for k, v in d.items()))
def test_knob_refusals_name_the_value(extra):
    # an invalid telemetry mode raises the JAX package's ValueError, which
    # names the value
    X, y = binary_data(n=300, f=3, seed=1)
    (name, value), = extra.items()
    with pytest.raises(ValueError) as want:
        jlgb.train(dict(SMALL, **extra), jlgb.Dataset(X, label=y), 1)
    with pytest.raises(ValueError, match=f"{name}.*{value!r}") as got:
        tlgb.train(dict(SMALL, **CPU, **extra), tlgb.Dataset(X, label=y), 1)
    assert str(got.value) == str(want.value)


def test_invalid_guard_value_raises_value_error():
    # as lightgbm_tpu/models/gbdt.py:319-322 refuses it
    X, y = binary_data(n=300, f=3, seed=1)
    with pytest.raises(ValueError, match="tpu_guard_numerics.*bogus"):
        tlgb.train(dict(SMALL, **CPU, tpu_guard_numerics="bogus"),
                   tlgb.Dataset(X, label=y), 1)


def test_knob_defaults_train():
    X, y = binary_data(n=300, f=3, seed=1)
    defaults = {"tpu_guard_numerics": "off", "tpu_hbm_preflight": "warn",
                "tpu_hbm_budget_bytes": 0, "tpu_telemetry": "off",
                "tpu_trace_dir": ""}
    for extra in ({}, defaults, {"tpu_telemetry": ""}):
        b = tlgb.train(dict(SMALL, **CPU, **extra),
                       tlgb.Dataset(X, label=y), 1)
        assert b.num_trees() == 1


# once refused; now ported with the objective zoo (the parity tests are
# tests/test_torch_objectives.py)
OBJECTIVES_NOW_PORTED = [
    {"objective": "multiclass", "num_class": 3},
    {"objective": "lambdarank"},
]


@pytest.mark.parametrize("extra", OBJECTIVES_NOW_PORTED,
                         ids=lambda d: ",".join(d))
def test_objective_cases_train_on_the_cpu(extra):
    n = 300
    X, y = binary_data(n=n, f=3, seed=1)
    group = None
    if extra["objective"] == "multiclass":
        y = np.arange(n) % 3
    else:
        group = [30] * 10
    b = tlgb.train(dict(SMALL, **CPU, **extra),
                   tlgb.Dataset(X, label=y, group=group), 2)
    k = extra.get("num_class", 1)
    assert b.num_trees() == 2 * k
    assert b.predict(X).shape == ((n, k) if k > 1 else (n,))


# once refused; now sampled as the JAX step samples them (rows by the
# hashed uniforms of the bagging key, features by a permutation of the
# feature key), and the trees equal the JAX package's
SAMPLING_NOW_PORTED = [
    {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"pos_bagging_fraction": 0.5, "bagging_freq": 1},
    {"feature_fraction": 0.5},
]


@pytest.mark.parametrize("extra", SAMPLING_NOW_PORTED,
                         ids=lambda d: ",".join(d))
def test_sampling_cases_train_like_jax(extra):
    X, y = binary_data(n=300, f=3, seed=1)
    params = dict(SMALL, tpu_hist_impl="pallas2", **extra)
    bj = jlgb.train(dict(params, verbosity=-1), jlgb.Dataset(X, label=y), 2)
    bt = tlgb.train(dict(params, **CPU), tlgb.Dataset(X, label=y), 2)
    assert bt.num_trees() == 2
    assert_trees_match(bj._driver.models, bt._driver.models)


# once refused; now the boosting modes and per-node feature sampling of
# the JAX package (tests/test_torch_boosting.py holds them to it)
BOOSTING_NOW_PORTED = [
    {"boosting": "dart"}, {"boosting": "goss"},
    {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
    {"feature_fraction_bynode": 0.5},
]


@pytest.mark.parametrize("extra", BOOSTING_NOW_PORTED,
                         ids=lambda d: ",".join(d))
def test_boosting_cases_train_on_the_cpu(extra):
    X, y = binary_data(n=300, f=3, seed=1)
    b = tlgb.train(dict(SMALL, **CPU, **extra), tlgb.Dataset(X, label=y), 2)
    assert b.num_trees() == 2
    assert np.isfinite(b.predict(X)).all()


@pytest.mark.parametrize("extra", BOOSTING_NOW_PORTED[::2],
                         ids=lambda d: d["boosting"])
def test_rollback_is_refused_by_name(extra):
    """Once refused; now the JAX package's rollback: the last
    iteration's tree leaves the model and its output the scores
    (tests/test_torch_utilities.py holds int8 texts byte for byte)."""
    X, y = binary_data(n=300, f=3, seed=1)
    params = dict(SMALL, tpu_hist_impl="xla", **extra)
    out = []
    for lgb, p in ((jlgb, dict(params, verbosity=-1)),
                   (tlgb, dict(params, **CPU))):
        b = lgb.train(p, lgb.Dataset(X, label=y), 3,
                      keep_training_booster=True)
        b.rollback_one_iter()
        out.append((b, b._driver.train_scores.numpy()))
    (bj, sj), (bt, st) = out
    assert bt.num_trees() == bj.num_trees() == 2
    assert bt.current_iteration() == 2
    assert_trees_match(bj._driver.models, bt._driver.models)
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5)


def _trees(text):
    """The tree blocks of a model text."""
    return text.split("\ntree_sizes=")[1].split("\nend of trees")[0]


# arguments and parameters of lgb.train: init_model, snapshot_freq,
# resume and tpu_checkpoint_dir, once refused, now train
TRAIN_ARGS = [
    ({"init_model": "model.txt"}, {}, "init_model"),
    ({"resume": True}, {}, "resume"),
    ({}, {"tpu_checkpoint_dir": "ckpt"}, "tpu_checkpoint_dir"),
    ({}, {"snapshot_freq": 2}, "snapshot_freq"),
]


@pytest.mark.parametrize("kwargs,extra,name", TRAIN_ARGS,
                         ids=[c[2] for c in TRAIN_ARGS])
def test_unported_train_arguments_raise(kwargs, extra, name, tmp_path):
    X, y = binary_data(n=300, f=3, seed=1)
    params = dict(SMALL, tpu_hist_impl="xla", **extra)
    if name in ("resume", "tpu_checkpoint_dir"):
        # as the JAX package: checkpoints every round, and with resume a
        # run cut after one round goes on from its bundle
        got = []
        for lgb, p in ((jlgb, dict(params, verbosity=-1)),
                       (tlgb, dict(params, **CPU))):
            d = tmp_path / lgb.__name__
            p["tpu_checkpoint_dir"] = str(d)
            if name == "resume":
                lgb.train(p, lgb.Dataset(X, label=y), 1)
            got.append((lgb.train(p, lgb.Dataset(X, label=y), 2, **kwargs),
                        sorted(f.name for f in d.iterdir())))
        (bj, dj), (bt, dt) = got
        assert_trees_match(bj._driver.models, bt._driver.models)
        assert dt == dj == ["ckpt-00000001", "ckpt-00000002"]
        return
    # as the JAX package: a continuation from the JAX model's file, or
    # snapshot files every snapshot_freq rounds
    init = tmp_path / kwargs.get("init_model", "none")
    jlgb.train(dict(SMALL, verbosity=-1), jlgb.Dataset(X, label=y),
               2).save_model(str(init))
    got = []
    for lgb, p in ((jlgb, dict(params, verbosity=-1)),
                   (tlgb, dict(params, **CPU))):
        p["output_model"] = str(tmp_path / f"{lgb.__name__}.txt")
        kw = {"init_model": str(init)} if kwargs else {}
        got.append(lgb.train(p, lgb.Dataset(X, label=y), 2, **kw))
    bj, bt = got
    assert_trees_match(bj._driver.models, bt._driver.models)
    snaps = sorted(f.name.split(".", 1)[1] for f in tmp_path.iterdir()
                   if "snapshot" in f.name)
    if name == "init_model":
        assert bt.num_trees() == 4 and not snaps
        # the init model's trees go first, as they are in its file
        assert _trees(bt.model_to_string(num_iteration=2)) == \
            _trees(init.read_text())
    else:
        assert snaps == ["txt.snapshot_iter_2"] * 2


def test_reset_parameter_refuses_all_but_the_learning_rate():
    """Once only the learning rate; now any parameter, as the JAX
    package takes it: the learner and the train step rebuilt."""
    X, y = binary_data(n=300, f=3, seed=1)
    got = []
    for lgb, p in ((jlgb, dict(SMALL, tpu_hist_impl="xla", verbosity=-1)),
                   (tlgb, dict(SMALL, tpu_hist_impl="xla", **CPU))):
        b = lgb.train(p, lgb.Dataset(X, label=y), 1,
                      keep_training_booster=True)
        b.reset_parameter({"eta": 0.05})
        assert b._driver.shrinkage_rate == 0.05
        b.reset_parameter({"num_leaves": 3})
        b.update()
        b2 = lgb.train(dict(p, bagging_freq=1), lgb.Dataset(X, label=y), 2,
                       callbacks=[lgb.reset_parameter(
                           bagging_fraction=[0.5, 0.6])])
        got.append((b, b2))
    (bj, bj2), (bt, bt2) = got
    for b in (bj, bj2, bt, bt2):
        b.num_trees()                  # the lazy trees materialized
    assert bt._driver.models[-1].num_leaves <= 3
    assert_trees_match(bj._driver.models, bt._driver.models)
    assert_trees_match(bj2._driver.models, bt2._driver.models)


# once refused; now packed as the JAX learner packs, into the packed
# variant of B1 or (tpu_hist_impl=pallas) of B4
PACKED_NOW_PORTED = [
    {"tpu_hist_precision": "int8", "tpu_hist_impl": "pallas2",
     "tpu_pack_bins": True},
    {"tpu_pack_bins": True},
    pytest.param({"tpu_hist_precision": "int16", "tpu_hist_impl": "pallas",
                  "tpu_pack_bins": True},
                 id="int16,pallas,tpu_pack_bins"),
    pytest.param({"tpu_hist_impl": "pallas", "tpu_pack_bins": True},
                 id="pallas,tpu_pack_bins"),
]


@pytest.mark.parametrize("extra", PACKED_NOW_PORTED,
                         ids=lambda d: ",".join(d))
def test_packed_cases_train_like_jax(extra):
    X, y = binary_data(n=512, f=3, seed=1)
    params = dict(SMALL, **extra)
    # the JAX package's own "auto" is "xla" off its accelerator, where it
    # never packs; the port's "auto" is the accelerator's "pallas2"
    impl = extra.get("tpu_hist_impl", "pallas2")
    bj = jlgb.train(dict(params, verbosity=-1, tpu_hist_impl=impl),
                    jlgb.Dataset(X, label=y), 1, keep_training_booster=True)
    bt = tlgb.train(dict(params, **CPU), tlgb.Dataset(X, label=y), 1,
                    keep_training_booster=True)
    lj, lt = bj._driver.learner, bt._driver.learner
    assert lj.packed_bins and lt.packed_bins
    assert lt.params.hist_impl == impl
    # the same bytes; the port pads the features to 32 on every impl, the
    # JAX learner on "pallas" to 8 (padding features hold bin 0)
    fj = lj.bins_t.shape[0]
    assert lt.f_pad == 32 and lj.f_pad == fj == (32 if impl == "pallas2"
                                                 else 8)
    np.testing.assert_array_equal(lt.bins_t[:fj].numpy(),
                                  np.asarray(lj.bins_t))
    assert not lt.bins_t[fj:].any()
    assert bt.num_trees() == 1


def test_packing_follows_the_jax_row_blocks():
    # 300 rows pad to one 384-row block, not a multiple of 256: neither
    # package packs, and the port trains (it once refused this case)
    X, y = binary_data(n=300, f=3, seed=1)
    params = dict(SMALL, tpu_pack_bins=True, tpu_hist_impl="pallas2")
    bj = jlgb.train(dict(params, verbosity=-1), jlgb.Dataset(X, label=y), 1,
                    keep_training_booster=True)
    bt = tlgb.train(dict(params, **CPU), tlgb.Dataset(X, label=y), 1,
                    keep_training_booster=True)
    assert not bj._driver.learner.packed_bins
    assert not bt._driver.learner.packed_bins
    assert bt._driver.learner.n_pad == bj._driver.learner.n_pad == 384


def test_more_bins_than_the_wide_copy_holds_raise():
    # the kernels read wide bins as 16-bit values: 65,536 bins at most
    rng = np.random.default_rng(2)
    n = 70_000
    X = rng.permutation(n).astype(np.float64)[:, None]
    y = (rng.random(n) < 0.5).astype(np.float64)
    params = dict(SMALL, **CPU, max_bin=70_000, min_data_in_bin=1,
                  bin_construct_sample_cnt=n)
    with pytest.raises(NotImplementedError, match="max_bin=70000"):
        tlgb.train(params, tlgb.Dataset(X, label=y, params=params),
                   num_boost_round=1)


def test_max_bin_1000_trains_on_the_cpu():
    # more than 256 bins a feature: the learner stores them int32
    X, y = binary_data(n=3000, f=2, seed=2)
    params = dict(SMALL, **CPU, max_bin=1000, min_data_in_bin=1)
    b = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=2,
                   keep_training_booster=True)
    learner = b._driver.learner
    assert learner.num_bins > 256 and learner.bins_t.dtype == torch.int32
    assert b.num_trees() == 2 and np.isfinite(b.predict(X)).all()


def test_sparse_features_refuse_bundling():
    # data the JAX package bundles: the port forms the same plan (EFB is
    # ported; tests/test_torch_bundling.py holds it to the JAX package),
    # and enable_bundle=false trains on the plain columns
    rng = np.random.default_rng(4)
    X = np.zeros((400, 5))
    rows = np.flatnonzero(rng.random(400) < 0.4)
    # 0/1 features, at most one of them nonzero per row: no conflicts,
    # so they fit one column beside the dense feature's 15 bins
    X[rows, rng.integers(0, 4, rows.size)] = 1.0
    X[:, 4] = rng.normal(size=400)
    y = (rng.random(400) < 0.5).astype(float)
    bj = jlgb.train(dict(SMALL, verbosity=-1), jlgb.Dataset(X, label=y), 1,
                    keep_training_booster=True)
    assert bj._driver.learner.bundle_plan is not None
    bt = tlgb.train(dict(SMALL, **CPU), tlgb.Dataset(X, label=y), 1,
                    keep_training_booster=True)
    assert bt._driver.learner.bundle_plan.groups == \
        bj._driver.learner.bundle_plan.groups
    b = tlgb.train(dict(SMALL, **CPU, enable_bundle=False),
                   tlgb.Dataset(X, label=y), 1, keep_training_booster=True)
    assert b.num_trees() == 1 and b._driver.learner.bundle_plan is None


@pytest.fixture(scope="module")
def jax_booster():
    X, y = binary_data(n=1500, f=5, seed=3)
    b = jlgb.train(dict(SMALL, verbosity=-1), jlgb.Dataset(X, label=y),
                   num_boost_round=4, keep_training_booster=True)
    return X, b


def test_convert_packed_tables_predict_like_jax(jax_booster):
    X, bj = jax_booster
    drv = bj._driver
    drv._materialize()
    td = drv.learner.td
    tables, _ = j_pack_trees(drv.models)
    used = td.used_feature_idx
    ms = [td.mappers[c] for c in used]
    bt = booster_from_arrays(
        tables, [m.bin_upper_bound for m in ms], [m.num_bin for m in ms],
        [m.default_bin for m in ms], [int(m.missing_type) for m in ms],
        used_feature_idx=used, num_total_features=X.shape[1],
        objective=drv.objective.to_model_string(), params=CPU)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)


def test_port_model_text_loads_in_the_jax_package():
    X, y = binary_data(n=1500, f=5, seed=5)
    bt = tlgb.train(dict(SMALL, **CPU), tlgb.Dataset(X, label=y),
                    num_boost_round=4)
    bj = jlgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(bj.predict(X), bt.predict(X), rtol=0,
                               atol=1e-6)


def test_jax_model_text_loads_in_the_port(jax_booster):
    X, bj = jax_booster
    bt = tlgb.Booster(model_str=bj.model_to_string(), params=CPU)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-6)
