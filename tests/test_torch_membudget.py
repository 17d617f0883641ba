"""Device memory of lightgbm_tpu_torch against lightgbm_tpu: the OOM
classifier, the budget, the preflight plan held to the live tensors,
the preflight modes, the degradation ladder, the guarded chunk sites
and the refusal of the streamed layout.

The ladder's parity cases run one script in both packages
(tests/test_torch_util.py:fault_run, job "fault" of the JAX package in
a no-FMA process): the same injected OOMs descend the same rungs to the
same model text.  On the CPU there is no capacity to read, so the
budget cases set ``tpu_hbm_budget_bytes``, as the JAX package's tests
do.
"""

import json
import types

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs import REGISTRY, flightrecorder
from lightgbm_tpu_torch.ops import kernels
from lightgbm_tpu_torch.utils import faultline, membudget
from lightgbm_tpu_torch.utils.checkpoint import CheckpointManager
from lightgbm_tpu_torch.utils.log import LightGBMError

from .test_torch_util import fault_run, model_text, start_jax_nofma

CPU = {"device_type": "cpu", "verbosity": -1}
INT8 = {"objective": "regression", "num_leaves": 7, "max_bin": 63,
        "min_data_in_leaf": 5, "tpu_hist_precision": "int8",
        "tpu_quant_refit_leaves": False, "tpu_hist_impl": "xla",
        "bagging_fraction": 0.8, "bagging_freq": 1}
# injected OOMs: (iteration armed at, consecutive OOMs)
LADDER = {"once": (2, 1), "five": (1, 5)}


def _inputs(n=1200, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + 300, 5))
    y = X[:, 0] - 0.5 * X[:, 1] ** 2 + 0.3 * X[:, 2]
    return {"X": X[:n], "y": y[:n], "Xv": X[n:], "yv": y[n:]}


def _oom_run(name):
    at, times = LADDER[name]
    return {"name": name, "kind": "oom", "params": INT8, "rounds": 4,
            "oom_at": at, "times": times}


@pytest.fixture(scope="module")
def ladder_runs(tmp_path_factory):
    """(port, JAX) results of the injected-OOM cases and the undisturbed
    run."""
    tmp = str(tmp_path_factory.mktemp("ladder"))
    inp = _inputs()
    runs = [_oom_run(n) for n in LADDER] + [
        {"name": "full", "kind": "full", "params": INT8, "rounds": 4}]
    job = start_jax_nofma("fault", inp, {"runs": runs, "tmp": tmp},
                          tmp_path_factory.mktemp("ladder_job"))
    port = {r["name"]: fault_run(tlgb, inp, r, tmp) for r in runs}
    out = job()
    jax = {r["name"]: {k.split("_", 1)[1]: v for k, v in out.items()
                       if k.split("_", 1)[0] == str(c)}
           for c, r in enumerate(runs)}
    return port, jax


@pytest.fixture(autouse=True)
def _clean_faults():
    faultline.reset()
    yield
    faultline.reset()


def counter(metric, **labels):
    return float(REGISTRY.value(metric, **labels))


def _train(params, rounds=3, data=None, **kw):
    inp = data or _inputs()
    ds = tlgb.Dataset(inp["X"], label=inp["y"], params=params)
    return tlgb.train(params, ds, rounds, keep_training_booster=True,
                      verbose_eval=False, **kw)


def _booster(params, data=None):
    inp = data or _inputs()
    return tlgb.Booster(params=params, train_set=tlgb.Dataset(
        inp["X"], label=inp["y"], params=params))


# -- classification ----------------------------------------------------------
def _check_error(monkeypatch, code):
    """The error `ops/kernels.py:check` raises for a CUDA error code, its
    text from cudaGetErrorString (a stub library here)."""
    text = {2: b"out of memory",
            700: b"an illegal memory access was encountered"}
    stub = types.SimpleNamespace(lgbt_error_string=lambda c: text[c])
    monkeypatch.setattr(kernels, "library", lambda: stub)
    with pytest.raises(RuntimeError) as err:
        kernels.check(code, "hist_batched launch")
    return err.value


def test_classifier_takes_the_cards_oom_shapes(monkeypatch):
    for exc in (torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 2.00 GiB"),
                RuntimeError("CUDA out of memory. Tried to allocate 8 MiB"),
                RuntimeError("CUDA error: out of memory"),
                _check_error(monkeypatch, 2)):
        assert membudget.is_oom_error(exc), exc
    assert "CUDA error 2 (out of memory)" in str(_check_error(monkeypatch,
                                                              2))
    for exc in (_check_error(monkeypatch, 700),
                ValueError("out of memory"), MemoryError("host"),
                RuntimeError("no room left"), KeyError("oom"),
                faultline.FaultInjected("injected fault at 'x'")):
        assert not membudget.is_oom_error(exc), exc


def test_oom_guard_names_its_site_and_passes_other_errors():
    before = counter("lgbm_oom_events_total", site="predict_chunk")
    with pytest.raises(membudget.DeviceOutOfMemory) as ei:
        with membudget.oom_guard("predict_chunk", rows=9):
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 1.00 GiB")
    assert ei.value.site == "predict_chunk" and ei.value.info["rows"] == 9
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)
    assert counter("lgbm_oom_events_total", site="predict_chunk") \
        == before + 1
    with pytest.raises(ValueError):
        with membudget.oom_guard("train_step"):
            raise ValueError("a data error stays itself")
    # the inner site's name wins through nested guards
    with pytest.raises(membudget.DeviceOutOfMemory) as ei:
        with membudget.oom_guard("train_step"):
            with membudget.oom_guard("score_replay"):
                raise RuntimeError("CUDA error: out of memory")
    assert ei.value.site == "score_replay"
    # the device_alloc point's oom action goes down the same path
    faultline.arm("device_alloc", action="oom")
    with pytest.raises(membudget.DeviceOutOfMemory) as ei:
        with membudget.oom_guard("ingest_chunk"):
            pass
    assert ei.value.site == "ingest_chunk"
    assert membudget.OOM_SITES == ("train_step", "ingest_chunk",
                                   "predict_chunk", "score_replay")


# -- the budget --------------------------------------------------------------
def test_budget_explicit_scaled_and_none_on_the_cpu(monkeypatch):
    assert membudget.budget_bytes(Config(dict(CPU))) is None
    assert membudget.device_capacity_bytes("cpu") is None
    assert membudget.budget_bytes(
        Config(dict(CPU, tpu_hbm_budget_bytes=12345))) == 12345
    monkeypatch.setattr(membudget, "device_capacity_bytes",
                        lambda device: 1_000_000)
    assert membudget.budget_bytes(Config(dict(CPU))) == 900_000
    assert membudget.budget_bytes(
        Config(dict(CPU, tpu_hbm_budget_frac=0.5))) == 500_000


# -- the plan ----------------------------------------------------------------
PLAN_CASES = {
    "hilo": {"objective": "binary", "num_leaves": 15, "max_bin": 63},
    "int8": dict(INT8, tpu_hist_impl="fused"),
    "f64": {"objective": "regression", "num_leaves": 7, "max_bin": 63,
            "deterministic": True, "tpu_hist_impl": "xla"},
    "packed": {"objective": "regression", "num_leaves": 7, "max_bin": 15,
               "tpu_hist_impl": "pallas2"},
    "wide": {"objective": "regression", "num_leaves": 7, "max_bin": 600},
    "sparse": {"objective": "regression", "num_leaves": 7, "max_bin": 63,
               "tpu_sparse_threshold": 0.3, "enable_bundle": False},
    "categorical": {"objective": "regression", "num_leaves": 7,
                    "max_bin": 63, "tpu_ingest_chunk_rows": 500},
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_components_are_the_live_tensors(case):
    inp = _inputs()
    if case == "sparse":
        inp["X"][:, 3] = np.where(np.abs(inp["X"][:, 3]) > 1.5,
                                  inp["X"][:, 3], 0.0)
    params = dict(PLAN_CASES[case], **CPU)
    if case == "categorical":
        # column 4 as categories: the binning's two extra planes
        inp["X"][:, 4] = np.floor(np.abs(inp["X"][:, 4]) * 4)
        b = tlgb.train(params, tlgb.Dataset(
            inp["X"], label=inp["y"], params=params,
            categorical_feature=[4]), 1, keep_training_booster=True,
            verbose_eval=False)
    else:
        b = _train(params, rounds=1, data=inp)
    drv = b._driver
    plan = membudget.plan_training(drv.config, drv.learner,
                                   drv.num_tree_per_iteration,
                                   num_valid_rows=0)
    live = membudget.live_bytes(drv)
    for name in ("row_state", "score_buffers", "ingest_scratch"):
        assert name in live, name
    for name, value in live.items():
        assert plan.components[name] == value, name
    assert plan.components["histogram_pool"] > 0
    assert plan.components["binned_matrix"] == drv.learner.bins_t.nbytes
    # the forest's device tables, made by a predict, at their own shape
    b.predict(inp["X"][:50])
    got, closed = membudget.forest_live_bytes(drv._tables.device())
    assert got == closed > 0
    assert plan.components["predict_scratch"] > 0


def test_plan_fits_semantics_and_table():
    drv = _train(dict(INT8, **CPU), rounds=1)._driver
    plan = membudget.plan_training(drv.config, drv.learner, 1)
    assert plan.fits is None and plan.budget is None
    tight = membudget.plan_training(
        Config(dict(INT8, **CPU, tpu_hbm_budget_bytes=10)), drv.learner, 1)
    assert tight.fits is False and tight.headroom < 0
    msg = tight.refuse_message("test")
    assert "histogram_pool" in msg and "budget" in msg
    assert tight.to_dict()["total"] == tight.total


# -- preflight ---------------------------------------------------------------
def _full_plan(params):
    drv = _train(params, rounds=1)._driver
    return membudget.plan_training(drv.config, drv.learner,
                                   drv.num_tree_per_iteration).total


@pytest.mark.parametrize("mode", ["raise", "warn", "degrade", "exhausted",
                                  "bogus"])
def test_preflight_modes(mode):
    p = dict(INT8, **CPU)
    if mode == "bogus":
        with pytest.raises(ValueError, match="tpu_hbm_preflight"):
            _train(dict(p, tpu_hbm_preflight="definitely"), rounds=1)
        return
    if mode in ("raise", "warn", "exhausted"):
        # a resident pin: under auto so small a budget would stream,
        # which the port refuses before the preflight
        budget = 100 if mode != "exhausted" else 50
        q = dict(p, tpu_hbm_budget_bytes=budget, tpu_stream_mode="resident",
                 tpu_hbm_preflight="degrade" if mode == "exhausted"
                 else mode)
        if mode == "warn":
            before = counter("lgbm_log_warnings_total")
            assert _train(q, rounds=1).current_iteration() == 1
            assert counter("lgbm_log_warnings_total") > before
            assert counter("lgbm_hbm_budget_bytes", scope="training") == 100
            return
        with pytest.raises(LightGBMError) as ei:
            _train(q, rounds=1)
        assert "histogram_pool" in str(ei.value)
        assert "headroom" in str(ei.value)
        return
    ref = model_text(_train(p, rounds=3))
    full = _full_plan(p)
    before = counter("lgbm_oom_ladder_steps_total", step="shrink_chunk_rows")
    b = _train(dict(p, tpu_hbm_budget_bytes=full - 1000,
                    tpu_hbm_preflight="degrade"), rounds=3)
    assert model_text(b) == ref
    assert counter("lgbm_oom_ladder_steps_total",
                   step="shrink_chunk_rows") > before
    assert int(b._driver.config.tpu_ingest_chunk_rows) < 65536


# -- the ladder --------------------------------------------------------------
@pytest.mark.parametrize("name", list(LADDER))
def test_injected_oom_descends_the_jax_ladder(ladder_runs, name):
    port, jax = ladder_runs
    assert port[name]["steps"] == str(jax[name]["steps"])
    steps = json.loads(port[name]["steps"])
    assert steps == (["shrink_chunk_rows"] if name == "once" else
                     ["shrink_chunk_rows"] * 4 + ["bucket_policy_fine"])
    assert port[name]["text"] == str(jax[name]["text"])
    assert port[name]["text"] == port["full"]["text"] \
        == str(jax["full"]["text"])


def test_fused_unfuse_rung_leaves_b2_and_the_bytes():
    """With tpu_hist_impl=fused pinned, the second rung takes the grower
    off B2 (B1-int and the torch split search): the same text."""
    # chunks one halving above the floor: the first OOM shrinks them to
    # it, the second unfuses
    p = dict(INT8, **CPU, tpu_hist_impl="fused",
             tpu_ingest_chunk_rows=8192, tpu_predict_chunk_rows=8192)
    ref = model_text(_train(p, rounds=4))
    b = _booster(p)
    rec = counter("lgbm_oom_recoveries_total", site="train_step")
    for it in range(4):
        if it == 2:
            faultline.arm("device_alloc", action="oom", times=2)
        b.update()
    assert b._driver._mem_ladder.describe() == ["shrink_chunk_rows",
                                                "fused_unfuse"]
    assert b._driver.learner.params.hist_impl == "pallas2"
    assert counter("lgbm_oom_recoveries_total", site="train_step") \
        == rec + 2
    assert model_text(b) == ref


def test_recovery_disabled_propagates_structured():
    b = _booster(dict(INT8, **CPU, tpu_oom_recovery=False))
    b.update()
    faultline.arm("device_alloc", action="oom", at=1)
    with pytest.raises(membudget.DeviceOutOfMemory) as ei:
        b.update()
    assert not isinstance(ei.value, membudget.MemoryLadderExhausted)
    assert ei.value.site == "train_step"
    assert b.current_iteration() == 1
    assert np.isfinite(b.predict(_inputs()["X"][:8], raw_score=True)).all()


def test_exhaustion_checkpoint_booster_and_blackbox(tmp_path):
    flightrecorder.configure(dump_dir=str(tmp_path))
    try:
        p = dict(INT8, **CPU, tpu_checkpoint_dir=str(tmp_path / "ck"))
        faultline.arm("device_alloc", action="oom", at=3, times=10 ** 6)
        with pytest.raises(membudget.MemoryLadderExhausted) as ei:
            _train(p, rounds=6)
        faultline.reset()
        # the JAX ladder's last rung streams; the port names it
        assert "stream_layout" in str(ei.value) and "A8" in str(ei.value)
        found = CheckpointManager(str(tmp_path / "ck")).load_latest()
        assert found is not None and found[0] >= 1
        dump = json.loads((tmp_path / "blackbox-host0.json").read_text())
        assert dump["reason"] in ("oom_ladder_exhausted",
                                  "train_interrupt:MemoryLadderExhausted")
        oom = [e for e in dump["entries"] if e["kind"] == "oom"]
        assert any(e["name"] == "ladder_exhausted" for e in oom)
        assert _train(p, rounds=6, resume=True).current_iteration() == 6
    finally:
        flightrecorder.configure(dump_dir="")


def test_rebuild_oom_is_classified_and_training_goes_on():
    b = _booster(dict(INT8, **CPU))
    b.update()
    faultline.arm("device_alloc", action="oom", at=1)
    with pytest.raises(membudget.DeviceOutOfMemory) as ei:
        b._driver.apply_memory_degradation({"tpu_bucket_policy": "fine"})
    assert ei.value.site == "train_step"
    faultline.reset()
    assert b._driver.learner is None and b._driver._ladder_carry
    b.update()   # the rebuild is retried
    assert b.current_iteration() == 2
    assert np.isfinite(b.predict(_inputs()["X"][:8], raw_score=True)).all()


# -- the chunk sites ---------------------------------------------------------
def test_ingest_chunk_oom_shrinks_and_bins_the_same():
    inp = _inputs(n=5000, seed=7)
    ref = tlgb.Dataset(inp["X"], label=inp["y"], params=dict(CPU))
    ref.construct()
    p = dict(CPU, tpu_ingest_chunk_rows=2048)
    faultline.arm("device_alloc", action="oom", at=2)
    dev = tlgb.Dataset(inp["X"], label=inp["y"], params=p)
    dev.construct()
    assert torch.equal(ref._inner.bins_t, dev._inner.bins_t)
    faultline.arm("device_alloc", action="oom", times=10)
    low = tlgb.Dataset(inp["X"], label=inp["y"],
                       params=dict(CPU, tpu_ingest_chunk_rows=256))
    with pytest.raises(membudget.DeviceOutOfMemory) as ei:
        low.construct()
    assert ei.value.site == "ingest_chunk"


def test_predict_chunk_oom_recovers_identically():
    inp = _inputs(n=20000, seed=8)
    b = _train(dict(INT8, **CPU, tpu_predict_chunk_rows=16384), rounds=2,
               data=inp)
    want = b.predict(inp["X"], raw_score=True)
    faultline.arm("device_alloc", action="oom", at=1)
    got = b.predict(inp["X"], raw_score=True)
    np.testing.assert_array_equal(want, got)
    assert int(b._driver.config.tpu_predict_chunk_rows) == 8192


def test_score_replay_oom_is_classified():
    inp = _inputs()
    p = dict(INT8, **CPU)
    ds = tlgb.Dataset(inp["X"], label=inp["y"], params=p)
    b = tlgb.Booster(params=p, train_set=ds)
    for _ in range(2):
        b.update()
    b.current_iteration()
    valid = ds.create_valid(inp["Xv"], label=inp["yv"]).construct()
    faultline.arm("device_alloc", action="oom", times=100)
    with pytest.raises(membudget.DeviceOutOfMemory) as ei:
        b.add_valid(valid, "v")
    assert ei.value.site == "score_replay"


# -- the layout --------------------------------------------------------------
def test_auto_layout_that_would_stream_is_refused_by_name():
    p = dict(INT8, **CPU, tpu_hbm_budget_bytes=8000)
    with pytest.raises(NotImplementedError,
                       match="tpu_stream_mode=auto selecting streamed"):
        _train(p, rounds=1)
    # a resident pin trains (the preflight warns); categorical columns
    # block streaming, so auto keeps the resident layout
    assert _train(dict(p, tpu_stream_mode="resident"),
                  rounds=1).current_iteration() == 1
    cfg = Config(dict(p, categorical_feature="0"))
    assert membudget.stream_config_blockers(cfg) == ["categorical features"]
    assert membudget.select_layout(cfg, None) == "resident"
