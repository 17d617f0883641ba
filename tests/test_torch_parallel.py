"""The sharded tree learners of lightgbm_tpu_torch against lightgbm_tpu:
tree_learner data, feature, voting and data_feature over the (hosts,
data, feature) grid, in one process (parallel/*).

The contract, as the JAX package proves its own grid
(tests/test_sharded_agg.py, tests/test_parallel.py, tests/test_topology.py):

* int8/int16 model text byte-identical to the JAX package's at the same
  shard count, hosts and tpu_hist_agg, with the leaf refit off (its f32
  psum may move the last ulp between shard orders,
  lightgbm_tpu/ops/grower.py:1736-1740), on the regression objective;
* int8 data and data_feature text equal to the serial text (integer sums
  in any order, the shared tie-break);
* hilo and the refit held with `assert_trees_match`, AUC within 1e-4;
* the collective watchdog, the axis vocabulary, and a shard that raises
  or hangs failing the whole train instead of hanging it.

The JAX side runs every grid case in one no-FMA process with 8 virtual
CPU devices (tests/test_torch_util.py:sharded_run, job "train_sharded"),
started before the port's runs, which work beside it.  The port places
its shards on the CPU (device_type=cpu).
"""

import json
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.models.learner import TreeLearner
from lightgbm_tpu_torch.ops import grower as G
from lightgbm_tpu_torch import parallel
from lightgbm_tpu_torch.parallel import (collective, mesh, metric_sync,
                                         strategies, topology)
from lightgbm_tpu_torch.parallel.collective import (CollectiveTimeout,
                                                    HostDropped,
                                                    guarded_collective)
from lightgbm_tpu_torch.parallel.topology import (DATA, FEATURE, HOSTS,
                                                  ROW_AXES, make_topology)
from lightgbm_tpu_torch.utils import faultline, membudget

from .test_torch_util import (SHARDED_FLAGS, assert_trees_match,
                              sharded_run, start_jax_nofma)

BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 5,
        "tpu_block_rows": 512, "tpu_hist_impl": "xla",
        "tpu_shape_buckets": 0}
INT8 = dict(BASE, objective="regression", tpu_hist_precision="int8",
            tpu_quant_refit_leaves=False)
INT16 = dict(INT8, tpu_hist_precision="int16")
HILO = dict(BASE, objective="binary", tpu_hist_precision="hilo")


def _learner(name, P, hosts=1, **kw):
    return dict(tree_learner=name, num_machines=P, tpu_topology_hosts=hosts,
                **kw)


# name -> (data, label, params, checks): "jax" byte-identical text,
# "serial" the port's serial text, "trees" assert_trees_match + AUC.
# The int8 grid runs here; int16, bagging, the refit and hilo in
# tests/test_torch_parallel_precisions.py, in a JAX process of its own
GRID = {
    "data2_int8": ("a", "reg", dict(INT8, **_learner("data", 2)),
                   ("jax", "serial")),
    "data2_psum_int8": ("a", "reg", dict(INT8, **_learner(
        "data", 2, tpu_hist_agg="psum")), ("jax", "serial")),
    "data4_hosts2_int8": ("a", "reg", dict(INT8, **_learner("data", 4, 2)),
                          ("jax", "serial")),
    "voting2_int8": ("a", "reg", dict(INT8, **_learner("voting", 2)),
                     ("jax",)),
    "voting2_psum_int8": ("a", "reg", dict(INT8, **_learner(
        "voting", 2, tpu_hist_agg="psum")), ("jax",)),
    # top_k below the shard count: the voted block pads to a multiple
    "voting4_topk2_int8": ("a", "reg", dict(INT8, **_learner(
        "voting", 4, top_k=2)), ("jax",)),
    "feature2_int8": ("a", "reg", dict(INT8, **_learner("feature", 2)),
                      ("jax", "serial")),
    # feature across two hosts is data_feature with a row shard a host
    "feature4_hosts2_int8": ("a", "reg", dict(INT8, **_learner(
        "feature", 4, 2)), ("jax", "serial")),
    "data_feature4_int8": ("a", "reg", dict(INT8, **_learner(
        "data_feature", 4)), ("jax", "serial")),
    "data_feature4_hosts2_psum_int8": ("a", "reg", dict(INT8, **_learner(
        "data_feature", 4, 2, tpu_hist_agg="psum")), ("jax", "serial")),
    # feature counts that do not divide the shards (test_sharded_agg.py)
    "data4_f9_int8": ("f9", "reg9", dict(INT8, **_learner("data", 4)),
                      ("jax", "serial")),
    "data_feature4_f13_int8": ("f13", "reg13", dict(INT8, **_learner(
        "data_feature", 4)), ("jax", "serial")),
}
ROUNDS = 3


def _problem(n=4096, f=10, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y_bin = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float64)
    y_reg = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    return X, y_bin, y_reg


def _inputs():
    X, yb, yr = _problem()
    X9, _, yr9 = _problem(f=9, seed=3)
    X13, _, yr13 = _problem(f=13, seed=4)
    # NaNs in every feature for the float cases: without a missing value
    # the two missing directions tie, and a float tie can flip
    # default_left between the packages (ROADMAP §C findings)
    Xn = X.copy()
    Xn[np.random.default_rng(11).random(X.shape) < 0.05] = np.nan
    return {"X_a": X, "y_bin": yb, "y_reg": yr, "X_f9": X9, "y_reg9": yr9,
            "X_f13": X13, "y_reg13": yr13, "X_nan": Xn}


def _serial_params(params):
    return {k: v for k, v in params.items()
            if k not in ("tree_learner", "num_machines",
                         "tpu_topology_hosts", "tpu_hist_agg", "top_k")}


def _auc(y, s):
    order = np.argsort(s, kind="stable")
    ranks = np.empty(len(s))
    ranks[order] = np.arange(1, len(s) + 1)
    pos = y > 0.5
    n1, n0 = pos.sum(), (~pos).sum()
    return (ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0)


def run_grid(grid_cases, tmp_path_factory, inputs=None):
    """The cases' runs in both packages: ({name: port result, with the
    port's serial text under "serial" where checked}, {name: JAX
    result}, inputs).  The JAX process starts first and works beside the
    port's runs.  inputs: the data sets by name (default `_inputs()`);
    a case's optional fifth entry adds to its run (`sharded_run`)."""
    inp = _inputs() if inputs is None else inputs
    names = list(grid_cases)
    runs = [dict({"params": grid_cases[k][2], "data": grid_cases[k][0],
                  "label": grid_cases[k][1], "rounds": ROUNDS},
                 **(grid_cases[k][4] if len(grid_cases[k]) > 4 else {}))
            for k in names]
    job = start_jax_nofma("train_sharded", inp, {"runs": runs},
                          tmp_path_factory.mktemp("sharded"),
                          xla_flags=SHARDED_FLAGS)
    port, serial = {}, {}
    for k, run in zip(names, runs):
        X, y = inp["X_" + run["data"]], inp["y_" + run["label"]]
        port[k] = sharded_run(tlgb, X, y, run)
        if "serial" in grid_cases[k][3]:
            key = (run["data"], run["label"],
                   json.dumps(_serial_params(run["params"]), sort_keys=True))
            if key not in serial:
                serial[key] = sharded_run(tlgb, X, y, dict(
                    run, params=_serial_params(run["params"])))["text"]
            port[k]["serial"] = serial[key]
    out = job()
    jax = {k: {f: out[f"{c}_{f}"] for f in ("text", "raw")}
           for c, k in enumerate(names)}
    return port, jax, inp


def grid_cases(grid_cases, check):
    return [k for k, v in grid_cases.items() if check in v[3]]


def check_trees_match(grid, grid_cases, name):
    """assert_trees_match of the two packages' trees, and on the binary
    objective (a label named *bin) their train AUCs within 1e-4."""
    port, jax, inp = grid
    cpu = {"device_type": "cpu"}
    trees_t = tlgb.Booster(model_str=port[name]["text"],
                           params=cpu)._driver.models
    trees_j = tlgb.Booster(model_str=str(jax[name]["text"]),
                           params=cpu)._driver.models
    assert_trees_match(trees_j, trees_t)
    label = grid_cases[name][1]
    if label.endswith("bin"):
        y = inp["y_" + label]
        a_t = _auc(y, port[name]["raw"].ravel())
        a_j = _auc(y, np.asarray(jax[name]["raw"]).ravel())
        assert abs(a_t - a_j) <= 1e-4, (a_t, a_j)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return run_grid(GRID, tmp_path_factory)


@pytest.mark.parametrize("name", grid_cases(GRID, "jax"))
def test_int_text_equals_jax(grid, name):
    port, jax, _ = grid
    assert port[name]["text"] == str(jax[name]["text"])


@pytest.mark.parametrize("name", grid_cases(GRID, "serial"))
def test_int_text_equals_serial(grid, name):
    port, _, _ = grid
    assert port[name]["text"] == port[name]["serial"]


# -- resolution ----------------------------------------------------------------
def _make_learner(n=1024, f=8, **cfg):
    X, _, y = _problem(n=n, f=f)
    config = Config(dict(INT8, device_type="cpu", verbosity=-1) | cfg)
    return TreeLearner(config, TrainingData.from_matrix(X, y, config))


@pytest.mark.parametrize("cfg, want", [
    ({"tree_learner": "data", "num_machines": 4}, ("data", "scatter", 1, 4)),
    ({"tree_learner": "data", "num_machines": 4, "tpu_hist_agg": "psum"},
     ("data", "psum", 1, 4)),
    ({"tree_learner": "feature", "num_machines": 2},
     ("feature", "psum", 2, 1)),
    ({"tree_learner": "voting_parallel", "num_machines": 2},
     ("voting", "scatter", 1, 2)),
    # auto feature shards: 2 where the count factors, else one
    ({"tree_learner": "data_feature", "num_machines": 4},
     ("data_feature", "scatter", 2, 2)),
    ({"tree_learner": "data_feature", "num_machines": 2},
     ("data_feature", "scatter", 1, 2)),
    ({"tree_learner": "feature", "num_machines": 4,
      "tpu_topology_hosts": 2}, ("data_feature", "scatter", 2, 2)),
    ({}, ("serial", "psum", 1, 1)),
])
def test_strategy_resolution(cfg, want):
    lrn = _make_learner(**cfg)
    assert (lrn.strategy, lrn.hist_agg, lrn.f_shards, lrn.d_shards) == want
    assert lrn.params.hist_agg == want[1]
    if want[0] == "serial":
        assert lrn.topology is None and topology.active() is None
    else:
        assert topology.active() is lrn.topology
        assert lrn.topology.size == lrn.n_shards
        # the pool's column axis: a feature shard's slice, of which a row
        # shard keeps 1/P under scatter (never the global histogram)
        _, cols, _ = membudget._pool_shape(lrn)
        per = lrn.g_pad // lrn.f_shards
        if lrn.hist_agg == "scatter" and lrn.strategy != "voting":
            per //= lrn.d_shards
        assert cols == per and lrn.g_pad % (32 * lrn.f_shards) == 0


def test_one_machine_falls_back_to_serial_with_a_warning(capsys):
    lrn = _make_learner(tree_learner="data", num_machines=1, verbosity=0)
    assert lrn.strategy == "serial" and lrn.topology is None
    assert "falling back to serial" in capsys.readouterr().out


@pytest.mark.parametrize("cfg, match", [
    ({"tree_learner": "data_feature", "num_machines": 6,
      "tpu_feature_shards": 4}, "tpu_feature_shards=4 must divide"),
    ({"tree_learner": "feature", "num_machines": 3,
      "tpu_topology_hosts": 2}, "must split evenly across 2 hosts"),
    ({"tree_learner": "data", "num_machines": 3, "tpu_topology_hosts": 2},
     "split evenly across the 2 hosts"),
    ({"tree_learner": "data", "num_machines": 2, "tpu_hist_agg": "ring"},
     "tpu_hist_agg"),
])
def test_bad_grids_raise(cfg, match):
    with pytest.raises(ValueError, match=match):
        _make_learner(**cfg)


def test_more_shards_than_devices_warns_and_shares(capsys):
    lrn = _make_learner(tree_learner="data", num_machines=4, verbosity=0)
    assert len(set(lrn.topology.devices)) == 1
    assert "shards share a device" in capsys.readouterr().out


def test_b2_never_runs_under_a_sharded_learner(monkeypatch):
    """impl fused (the card's auto for int8): every shard takes B1-int and
    the torch split search (lightgbm_tpu/ops/grower.py:557-563)."""
    def refuse(*a, **k):
        raise AssertionError("B2 ran under a sharded learner")

    monkeypatch.setattr(G, "fused_hist_scan", refuse)
    X, _, y = _problem(n=2048, f=6)
    p = dict(INT8, tpu_hist_impl="fused", device_type="cpu", verbosity=-1,
             **_learner("data", 2))
    b = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 2)
    assert b.num_trees() == 2


@pytest.mark.parametrize("extra", [
    {"boosting": "goss"}, {"boosting": "dart"},
    {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1},
    {"bagging_fraction": 0.7, "bagging_freq": 1, "feature_fraction": 0.8},
    {"objective": "multiclass", "num_class": 3}],
    ids=["goss", "dart", "rf", "bagging", "multiclass"])
def test_boosting_modes_under_data_give_the_serial_text(extra):
    """GOSS, bagging and feature masks are drawn on the global rows, and
    DART's drop walk and RF's averaging see the trees put together from
    the row shards: int8 text equal to the serial learner's."""
    X, _, y = _problem(n=3000, f=6)
    if extra.get("objective") == "multiclass":
        y = np.digitize(y, [-0.5, 0.5])
    p = dict(INT8, device_type="cpu", verbosity=-1, **extra)

    def text(**kw):
        q = dict(p, **kw)
        b = tlgb.train(q, tlgb.Dataset(X, label=y, params=q), 8)
        return b.model_to_string().split("parameters:")[0]

    assert text(**_learner("data", 2)) == text()


def test_data_parallel_alias_is_the_data_strategy():
    lrn = _make_learner(tree_learner="data", num_machines=2)
    grow = parallel.make_data_parallel_grower(lrn.params, lrn.topology)
    assert isinstance(grow, strategies.StrategyGrower)
    assert grow.strategy == "data" and grow.data_axis == ROW_AXES
    assert strategies.make_strategy_grower(lrn.params, "serial") is G.grow


def test_sharded_plan_is_the_live_tensors():
    X, _, y = _problem(n=3000, f=7)
    for cfg in (_learner("data", 2), _learner("feature", 2),
                _learner("voting", 2), _learner("data_feature", 4)):
        p = dict(INT8, device_type="cpu", verbosity=-1, **cfg)
        b = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 1,
                       keep_training_booster=True)
        drv = b._driver
        plan = membudget.plan_training(drv.config, drv.learner, 1)
        live = membudget.live_bytes(drv)
        for name, value in live.items():
            assert plan.components[name] == value, (cfg, name)


# -- a shard that fails --------------------------------------------------------
@pytest.fixture
def _watchdog():
    faultline.reset()
    collective.configure(timeout_s=0.0, retries=1, backoff_s=0.25)
    yield
    faultline.reset()
    collective.configure(timeout_s=0.0, retries=1, backoff_s=0.25)


def _shard_fault(monkeypatch, action):
    orig = G.grow

    def grow(*a, **k):
        if topology.current().rank == 1:
            action()
        return orig(*a, **k)

    monkeypatch.setattr(G, "grow", grow)


def test_a_shard_that_raises_fails_train_without_a_hang(monkeypatch,
                                                        _watchdog):
    def boom():
        raise RuntimeError("shard 1 failed")

    _shard_fault(monkeypatch, boom)
    X, _, y = _problem(n=2048, f=6)
    # the peers' barrier is aborted: they raise long before the deadline
    p = dict(INT8, device_type="cpu", verbosity=-1,
             tpu_collective_timeout_s=120.0, **_learner("data", 4))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 2)
    assert time.monotonic() - t0 < 60.0


def test_a_hung_shard_times_out_its_peers(monkeypatch, _watchdog):
    # shard 1 sleeps far past the deadline: train raises after about two
    # deadlines (its peer's wait, then the wait for the hung shard), not
    # after the sleep
    _shard_fault(monkeypatch, lambda: time.sleep(60.0))
    X, _, y = _problem(n=2048, f=6)
    p = dict(INT8, device_type="cpu", verbosity=-1,
             tpu_collective_timeout_s=1.0, **_learner("data", 2))
    t0 = time.monotonic()
    with pytest.raises(CollectiveTimeout):
        tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 1)
    assert time.monotonic() - t0 < 30.0


def test_concurrent_counts_and_exchanges_lose_nothing():
    """More shard threads than cores, a shortened switch interval: the
    launch counters lose no update, and every shard of a 16-shard grid
    gets every exchange's exact sum."""
    import sys

    from lightgbm_tpu_torch.ops import kernels

    t = make_topology(num_data_shards=16, devices=["cpu"])
    before = kernels.launches["leaf_sums"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def shard(ctx):
            sums = []
            for i in range(200):
                kernels.count("leaf_sums")
                sums.append(int(topology.axis_psum(
                    torch.tensor(ctx.rank + i), DATA)))
            return sums

        out = strategies.run_shards(t, shard, [None] * t.size)
    finally:
        sys.setswitchinterval(old)
    assert kernels.launches["leaf_sums"] - before == 16 * 200
    want = [120 + 16 * i for i in range(200)]
    assert all(o == want for o in out)


# -- the collective watchdog (tests/test_collective.py) ------------------------
def _slow():
    time.sleep(5.0)


def _flaky_once():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise OSError("transient hiccup")
        return "ok"
    return flaky, calls


@pytest.mark.parametrize("case", [
    "passthrough", "deadline", "transient_retry", "retry_exhausts",
    "injected_raise_retried", "injected_hang_real_deadline",
    "injected_hang_local", "timeout_never_retries", "host_drop",
    "host_drop_custom_exc", "configure", "booster_keeps_policy",
    "host_addressed", "absolute_index"])
def test_guarded_collective(case, _watchdog):
    if case == "passthrough":
        assert guarded_collective(lambda a, b: a + b, 2, 3, name="t") == 5
    elif case == "deadline":
        with pytest.raises(CollectiveTimeout) as ei:
            guarded_collective(_slow, name="slow", timeout_s=0.05)
        assert (ei.value.name, ei.value.attempts) == ("slow", 1)
        assert ei.value.timeout_s == pytest.approx(0.05)
    elif case == "transient_retry":
        flaky, calls = _flaky_once()
        t0 = time.time()
        assert guarded_collective(flaky, name="t", retries=2,
                                  backoff_s=0.05) == "ok"
        assert len(calls) == 2 and time.time() - t0 >= 0.05
    elif case == "retry_exhausts":
        def broken():
            raise OSError("still down")
        with pytest.raises(OSError):
            guarded_collective(broken, name="t", retries=1, backoff_s=0.0)
    elif case == "injected_raise_retried":
        faultline.arm("collective_sync", action="raise", times=1)
        assert guarded_collective(lambda: 7, name="t", retries=1,
                                  backoff_s=0.0) == 7
        assert faultline.hits("collective_sync") == 2
    elif case == "injected_hang_real_deadline":
        faultline.arm("collective_sync", action="hang")
        with pytest.raises(CollectiveTimeout):
            guarded_collective(lambda: 1, name="t", timeout_s=0.05,
                               retries=3)
    elif case == "injected_hang_local":
        faultline.arm("collective_sync", action="hang")
        with pytest.raises(CollectiveTimeout):
            guarded_collective(lambda: 1, name="t", local=True)
    elif case == "timeout_never_retries":
        faultline.arm("collective_sync", action="hang", times=5)
        with pytest.raises(CollectiveTimeout) as ei:
            guarded_collective(lambda: 1, name="t", timeout_s=0.05,
                               retries=5)
        assert ei.value.attempts == 1
    elif case in ("host_drop", "host_drop_custom_exc"):
        exc = ConnectionError("peer died") if case.endswith("exc") else None
        faultline.arm("host_drop", action="raise", exc=exc, times=5)
        with pytest.raises(HostDropped):
            guarded_collective(lambda: 1, name="t", retries=5,
                               backoff_s=0.0)
        assert faultline.hits("host_drop") == 1
    elif case == "configure":
        collective.configure(timeout_s=12.5, retries=4)
        d = collective.defaults()
        assert d["timeout_s"] == 12.5 and d["retries"] == 4
    elif case == "booster_keeps_policy":
        # tpu_collective_timeout_s unset (-1) leaves the process policy
        collective.configure(timeout_s=60.0)
        X, _, y = _problem(n=512, f=4)
        p = dict(INT8, device_type="cpu", verbosity=-1)
        tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))
        assert collective.defaults()["timeout_s"] == 60.0
    elif case == "host_addressed":
        faultline.arm("host_drop", action="raise", host=3)
        assert guarded_collective(lambda: 1, name="t", backoff_s=0.0) == 1
        faultline.set_host_index(3)
        with pytest.raises(HostDropped):
            guarded_collective(lambda: 1, name="t", backoff_s=0.0)
    elif case == "absolute_index":
        for _ in range(2):
            guarded_collective(lambda: 1, name="t")
        faultline.arm("host_drop", action="raise", at=3, absolute=True)
        with pytest.raises(HostDropped):
            guarded_collective(lambda: 1, name="t", backoff_s=0.0)


# -- the topology and its vocabulary (tests/test_topology.py) ------------------
def _in_shards(t, fn):
    """fn(ctx) on every shard of t, in shard threads."""
    return strategies.run_shards(t, fn, [None] * t.size)


@pytest.mark.parametrize("case", [
    "three_axes", "hosts_factorize", "flat_order", "indivisible_hosts",
    "shares_devices", "resolve_hosts", "row_axes_index", "psum_row_axes",
    "psum_scatter", "pmax_all_gather", "feature_axis_subgroups",
    "best_split_sync", "rows_partitioned", "host_identities",
    "local_collectives_fire_faults", "metric_sync", "multihost_refused"])
def test_topology_vocabulary(case, _watchdog):
    if case == "three_axes":
        t = make_topology(num_data_shards=4)
        assert t.shape == {HOSTS: 1, DATA: 4, FEATURE: 1}
        assert (t.hosts, t.data_shards, t.feature_shards,
                t.local_data_shards) == (1, 4, 1, 4)
    elif case == "hosts_factorize":
        t = make_topology(num_data_shards=4, num_hosts=2)
        assert t.shape == {HOSTS: 2, DATA: 2, FEATURE: 1}
        assert [t.row_shard(r) for r in range(4)] == [0, 1, 2, 3]
    elif case == "flat_order":
        a = make_topology(num_data_shards=4, devices=["cpu"])
        b = make_topology(num_data_shards=4, num_hosts=2, devices=["cpu"])
        assert a.devices == b.devices
    elif case == "indivisible_hosts":
        with pytest.raises(ValueError, match="hosts"):
            make_topology(num_data_shards=3, num_hosts=2)
    elif case == "shares_devices":
        # the JAX package refuses more shards than devices; the port
        # places shard i on device i % count
        t = make_topology(num_data_shards=8, num_feature_shards=2,
                          devices=["cpu"])
        assert t.size == 16 and set(t.devices) == {torch.device("cpu")}
    elif case == "resolve_hosts":
        assert topology.resolve_hosts(0) == 1
        assert topology.resolve_hosts(3) == 3
    elif case == "row_axes_index":
        t = make_topology(num_data_shards=4, num_hosts=2, devices=["cpu"])
        assert _in_shards(t, lambda c: topology.axis_index(ROW_AXES)) \
            == [0, 1, 2, 3]
        assert _in_shards(t, lambda c: topology.axis_index(HOSTS)) \
            == [0, 0, 1, 1]
    elif case == "psum_row_axes":
        t = make_topology(num_data_shards=4, num_hosts=2, devices=["cpu"])
        out = _in_shards(t, lambda c: topology.axis_psum(
            torch.tensor([c.rank], dtype=torch.int32), ROW_AXES))
        assert [int(o) for o in out] == [6] * 4
        assert _in_shards(t, lambda c: topology.axis_size(ROW_AXES)) \
            == [4] * 4
    elif case == "psum_scatter":
        t = make_topology(num_data_shards=2, devices=["cpu"])
        out = _in_shards(t, lambda c: topology.axis_psum_scatter(
            torch.arange(8, dtype=torch.int32).reshape(4, 2) * (c.rank + 1),
            DATA, scatter_dimension=0))
        full = torch.arange(8, dtype=torch.int32).reshape(4, 2) * 3
        assert torch.equal(out[0], full[:2]) and torch.equal(out[1],
                                                             full[2:])
    elif case == "pmax_all_gather":
        t = make_topology(num_data_shards=3, devices=["cpu"])
        mx = _in_shards(t, lambda c: topology.axis_pmax(
            torch.tensor(float(c.rank) * 2.5), DATA))
        assert [float(m) for m in mx] == [5.0] * 3
        g = _in_shards(t, lambda c: topology.axis_all_gather(
            torch.tensor([c.rank, -c.rank]), DATA))
        assert all(torch.equal(x, torch.tensor([[0, 0], [1, -1], [2, -2]]))
                   for x in g)
    elif case == "feature_axis_subgroups":
        # the feature axis groups the shards of one row shard only
        t = make_topology(num_data_shards=2, num_feature_shards=2,
                          devices=["cpu"])
        out = _in_shards(t, lambda c: topology.axis_psum(
            torch.tensor(10 ** c.rank), FEATURE))
        assert [int(o) for o in out] == [11, 11, 1100, 1100]
        assert _in_shards(t, lambda c: topology.axis_index(FEATURE)) \
            == [0, 1, 0, 1]
    elif case == "best_split_sync":
        # a batch of two leaves over three shards: the highest gain, then
        # the lowest feature id, then the lowest bin wins
        t = make_topology(num_data_shards=3, devices=["cpu"])
        gains = [[1.0, 2.0], [3.0, 2.0], [3.0, 2.0]]
        feats = [[4, 9], [7, 9], [5, 9]]
        thrs = [[0, 3], [1, 2], [2, 5]]

        def fn(c):
            r = c.rank
            return topology.axis_best_split_sync(
                DATA, torch.tensor(gains[r]), torch.tensor(feats[r]),
                torch.tensor(thrs[r]), {"who": torch.tensor([r, r])})
        for g, f, th, p in _in_shards(t, fn):
            assert g.tolist() == [3.0, 2.0] and f.tolist() == [5, 9]
            assert th.tolist() == [2, 2] and p["who"].tolist() == [2, 1]
    elif case == "rows_partitioned":
        assert topology.rows_partitioned() is False
        topology.activate(make_topology(num_data_shards=2, devices=["cpu"],
                                        partitioned_rows=True))
        try:
            assert topology.rows_partitioned() is False   # one process
        finally:
            topology.activate(None)
    elif case == "host_identities":
        a = np.arange(6, dtype=np.int64).reshape(2, 3)
        out = topology.host_allgather(a, name="t")
        assert out.shape == (1, 2, 3) and np.array_equal(out[0], a)
        r = np.arange(5, dtype=np.float64)
        assert np.array_equal(topology.ragged_all_gather(r, name="t"), r)
        parts = topology.ragged_all_gather(r, name="t", split=True)
        assert len(parts) == 1 and np.array_equal(parts[0], r)
        assert np.array_equal(topology.host_sum([1.5, 2.0], name="t"),
                              [1.5, 2.0])
        assert mesh.local_row_offset(77) == (0, 77)
    elif case == "local_collectives_fire_faults":
        faultline.arm("collective_sync", action="hang")
        collective.configure(timeout_s=0.2, retries=1, backoff_s=0.0)
        with pytest.raises(CollectiveTimeout):
            topology.host_allgather(np.zeros(2), name="t")
    elif case == "metric_sync":
        assert np.array_equal(metric_sync.sync_sums([1.0, 2.5]), [1.0, 2.5])
        a, b = metric_sync.sync_concat(np.arange(3), np.ones(3))
        assert np.array_equal(a, [0, 1, 2]) and np.array_equal(b, np.ones(3))
        before = faultline.hits("collective_sync")
        faultline.arm("collective_sync", action="raise", times=1)
        collective.configure(backoff_s=0.0)
        assert np.array_equal(metric_sync.sync_sums([3.0]), [3.0])
        assert faultline.hits("collective_sync") - before == 2
    elif case == "multihost_refused":
        # once refused by name, a machine list of several hosts now joins
        # a process group (tests/test_torch_multiprocess.py): without a
        # rank it raises the JAX package's ValueError, and a list of one
        # host needs no group; put_local in one process is put_global
        import os

        env = {k: os.environ.pop(k) for k in ("LIGHTGBM_TPU_HOST_IP",
                                              "LIGHTGBM_TPU_PROCESS_ID")
               if k in os.environ}
        try:
            with pytest.raises(ValueError, match="position in `machines`"):
                mesh.init_multihost("10.0.0.1:12400,10.0.0.2:12400",
                                    12400, 2)
        finally:
            os.environ.update(env)
        assert mesh.init_multihost("10.0.0.1:12400", 12400, 2) is False
        t = make_topology(num_data_shards=2, devices=["cpu"])
        v = torch.arange(8)
        got = mesh.put_local(v, t, (8,), ROW_AXES, 0)
        assert [x.tolist() for x in got] == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_cost_models_are_the_jax_packages():
    from lightgbm_tpu.parallel import mesh as jmesh

    for nbytes in (0, 1000, 3 * 2 ** 20 + 7):
        for shards in (1, 2, 3, 8):
            for fn in ("allreduce_recv_bytes", "reduce_scatter_recv_bytes"):
                assert getattr(mesh, fn)(nbytes, shards) \
                    == getattr(jmesh, fn)(nbytes, shards)
            for hosts in (1, 2):
                for fn in ("tiered_allreduce_recv_bytes",
                           "tiered_reduce_scatter_recv_bytes"):
                    assert getattr(mesh, fn)(nbytes, hosts, shards) \
                        == getattr(jmesh, fn)(nbytes, hosts, shards)
    assert mesh.shard_rows(10, 4) == 3
    off, total = mesh.row_offsets([3, 5, 2])
    assert off.tolist() == [0, 3, 8] and total == 10


def test_strategy_names_and_placement_are_the_jax_packages():
    from lightgbm_tpu.parallel import strategies as js

    assert strategies._CANON == js._CANON
    with pytest.raises(ValueError, match="unknown tree_learner"):
        strategies.resolve_tree_learner("ring")
    for s in ("data", "voting", "feature", "data_feature"):
        want = js.bins_sharding(js_mesh(), s).spec
        got = strategies.bins_sharding(s)
        assert tuple(want) == ((None, got) if got else ())
        for scatter in (False, True):
            spec = js.pool_partition_spec(s, scatter)
            jcol = spec[1] if len(spec) > 1 else None
            got = strategies.pool_partition_spec(s, scatter)
            if s == "voting":
                # voting's pool stays local to each shard
                assert got == ()
                continue
            assert (tuple(jcol) if isinstance(jcol, tuple) else
                    ((jcol,) if jcol else ())) == got


def js_mesh():
    from lightgbm_tpu.parallel.topology import make_topology as jmake

    return jmake(num_data_shards=1).mesh


# -- argbest (lightgbm_tpu/ops/split.py:53) ------------------------------------
def test_argbest_breaks_ties_as_the_jax_package():
    import jax.numpy as jnp
    from lightgbm_tpu.ops.split import argbest as jargbest
    from lightgbm_tpu_torch.ops.split import argbest

    rng = np.random.default_rng(0)
    # many ties: gains from three values, features and bins from a few
    gain = rng.choice([0.5, 1.5, 1.5], size=(200, 6)).astype(np.float32)
    feat = rng.integers(0, 3, size=(200, 6)).astype(np.int32)
    thr = rng.integers(0, 3, size=(200, 6)).astype(np.int32)
    got = argbest(torch.from_numpy(gain), torch.from_numpy(feat),
                  torch.from_numpy(thr)).numpy()
    got2 = argbest(torch.from_numpy(gain), torch.from_numpy(feat)).numpy()
    for i in range(gain.shape[0]):
        assert got[i] == int(jargbest(jnp.asarray(gain[i]),
                                      jnp.asarray(feat[i]),
                                      jnp.asarray(thr[i])))
        assert got2[i] == int(jargbest(jnp.asarray(gain[i]),
                                       jnp.asarray(feat[i])))
