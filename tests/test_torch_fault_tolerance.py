"""Fault-tolerant training of lightgbm_tpu_torch against lightgbm_tpu:
the fault-injection harness, the checkpoint manager, resume (bit for
bit, and across the two packages), atomic iterations and the numeric
guard.

The training cases run one script in both packages
(tests/test_torch_util.py:fault_run), the JAX package's in one process
compiled without FMA (job "fault").  The port's cut runs go first: the
JAX process resumes from their bundles, and the port resumes from the
JAX process's bundles once it is done.  Integer histograms and
regression, so the model texts are byte-identical; they are compared
without the parameters block, which names each run's checkpoint
directory and device.
"""

import json
import os
import signal
import threading

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.utils.checkpoint import CheckpointManager as JManager
from lightgbm_tpu_torch.models.gbdt import quant_headroom_check
from lightgbm_tpu_torch.utils import faultline
from lightgbm_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                 flush_checkpoint)
from lightgbm_tpu_torch.utils.log import LightGBMError

from .test_torch_util import fault_run, model_text, start_jax_nofma

CPU = {"device_type": "cpu", "verbosity": -1}
INT8 = {"objective": "regression", "num_leaves": 7, "max_bin": 63,
        "min_data_in_leaf": 5, "tpu_hist_precision": "int8",
        "tpu_quant_refit_leaves": False, "tpu_hist_impl": "xla",
        "bagging_fraction": 0.8, "bagging_freq": 1}
MODES = {
    "gbdt_int8": INT8,
    "gbdt_int16": dict(INT8, tpu_hist_precision="int16"),
    "dart_int8": dict(INT8, boosting="dart", drop_rate=0.5, skip_drop=0.0,
                      max_drop=3),
    "rf_int8": dict(INT8, boosting="rf", bagging_fraction=0.7,
                    feature_fraction=0.8),
    "goss_int8": dict(INT8, boosting="goss", learning_rate=0.25,
                      bagging_fraction=1.0, bagging_freq=0),
}
# the modes whose bundles cross between the packages
CROSS = ("gbdt_int8", "dart_int8")
CUT = 3


def _inputs():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(1900, 6))
    X[rng.random(X.shape) < 0.03] = np.nan
    Xn = np.nan_to_num(X)
    y = Xn[:, 0] - 0.7 * Xn[:, 1] ** 2 + 0.4 * Xn[:, 2] * Xn[:, 3]
    return {"X": X[:1500], "y": y[:1500], "Xv": X[1500:], "yv": y[1500:]}


def _cut(mode):
    return {"name": mode, "kind": "interrupt", "params": MODES[mode],
            "at": CUT}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's and the JAX package's results, by case name."""
    tmp = str(tmp_path_factory.mktemp("fault"))
    inp = _inputs()
    port = {}
    for mode in CROSS:
        port[f"cut_{mode}"] = fault_run(tlgb, inp, _cut(mode), tmp)
    jax_runs = (
        [{"name": f"full_{m}", "kind": "full", "params": p}
         for m, p in MODES.items()]
        + [dict(_cut(m), name=f"cut_{m}") for m in CROSS]
        + [{"name": f"resume_{m}", "kind": "resume", "params": MODES[m],
            "from_dir": str(port[f"cut_{m}"]["dir"])} for m in CROSS]
        + [{"name": "guard", "kind": "guard", "params": INT8,
            "poison_at": 3}])
    job = start_jax_nofma("fault", inp, {"runs": jax_runs, "tmp": tmp},
                          tmp_path_factory.mktemp("fault_job"))
    for mode, params in MODES.items():
        port[f"full_{mode}"] = fault_run(
            tlgb, inp, {"name": mode, "kind": "full", "params": params}, tmp)
        if mode not in CROSS:
            port[f"cut_{mode}"] = fault_run(tlgb, inp, _cut(mode), tmp)
        port[f"resume_{mode}"] = fault_run(
            tlgb, inp, {"name": mode, "kind": "resume", "params": params,
                        "from_dir": str(port[f"cut_{mode}"]["dir"])}, tmp)
    port["guard"] = fault_run(tlgb, inp, jax_runs[-1], tmp)
    out = job()
    jax = {}
    for c, run in enumerate(jax_runs):
        jax[run["name"]] = {k.split("_", 1)[1]: v for k, v in out.items()
                            if k.split("_", 1)[0] == str(c)}
    for mode in CROSS:
        port[f"from_jax_{mode}"] = fault_run(
            tlgb, inp, {"name": f"{mode}_jax", "kind": "resume",
                        "params": MODES[mode],
                        "from_dir": str(jax[f"cut_{mode}"]["dir"])}, tmp)
    return inp, port, jax


@pytest.fixture(autouse=True)
def _clean_faults():
    faultline.reset()
    yield
    faultline.reset()


# -- the fault-injection harness --------------------------------------------
def test_faultline_addressing_and_refusals():
    with pytest.raises(ValueError, match="unknown fault point"):
        faultline.arm("nope")
    with pytest.raises(ValueError, match="unknown fault action"):
        faultline.arm("grow_step", action="explode")
    faultline.arm("grow_step", action="poison", at=2, times=2)
    assert faultline.fire("grow_step") is None
    assert faultline.fire("grow_step") == "poison"
    assert faultline.fire("grow_step") == "poison"
    assert faultline.fire("grow_step") is None  # exhausted + disarmed
    assert faultline.hits("grow_step") == 4
    faultline.arm("h2d_copy")
    with pytest.raises(faultline.FaultInjected, match="rows=7"):
        faultline.fire("h2d_copy", rows=7)
    with faultline.armed("serve_dispatch"):
        with pytest.raises(faultline.FaultInjected):
            faultline.fire("serve_dispatch")
    assert faultline.fire("serve_dispatch") is None


def test_faultline_oom_action_is_the_allocators_error(monkeypatch):
    import torch

    faultline.arm("device_alloc", action="oom")
    with pytest.raises(torch.OutOfMemoryError,
                       match="CUDA out of memory. Tried to allocate"):
        faultline.fire("device_alloc", site="train_step")
    # the host index: the env variable first, else 0 without a group
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_HOST", "3")
    assert faultline.host_index() == 3
    monkeypatch.delenv("LIGHTGBM_TPU_FAULT_HOST")
    assert faultline.host_index() == 0


# -- the checkpoint manager --------------------------------------------------
def _save(mgr, it, text=None):
    return mgr.save(it, text or f"model-{it}", {"iteration": it},
                    {"train_scores": np.full((1, 4), it, np.float32)})


def test_bundles_match_the_jax_managers_byte_for_byte(tmp_path):
    """The same bundle saved by either package's manager: the same
    files with the same bytes, and each loads the other's."""
    state = {"iteration": 2, "key": [0, 7], "b": {"z": 1, "a": [1.5]}}
    arrays = {"train_scores": np.arange(6, dtype=np.float32).reshape(2, 3),
              "valid_scores/v": np.ones((2, 2), np.float32)}
    paths = [m(str(tmp_path / name)).save(2, "tree\nmodel", state, arrays)
             for m, name in ((CheckpointManager, "port"),
                             (JManager, "jax"))]
    files = [sorted(os.listdir(p)) for p in paths]
    assert files[0] == files[1] == ["arrays.npz", "manifest.json",
                                    "model.txt", "state.json"]
    for name in files[0]:
        with open(os.path.join(paths[0], name), "rb") as a, \
                open(os.path.join(paths[1], name), "rb") as b:
            assert a.read() == b.read(), name
    got = CheckpointManager(str(tmp_path / "jax")).load_latest()
    assert got[0] == 2 and got[2] == state
    assert JManager(str(tmp_path / "port")).load_latest()[2] == state


def test_atomic_bundle_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for it in (1, 2, 3):
        _save(mgr, it)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000002",
                                            "ckpt-00000003"]
    it, text, state, arrays, _ = mgr.load_latest()
    assert (it, text, state["iteration"]) == (3, "model-3", 3)
    np.testing.assert_array_equal(arrays["train_scores"],
                                  np.full((1, 4), 3, np.float32))


def test_torn_manifest_and_truncated_payload_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=10)
    for it in (1, 2, 3):
        _save(mgr, it)
    with open(tmp_path / "ckpt-00000003" / "manifest.json", "w") as f:
        f.write("{torn")
    p = tmp_path / "ckpt-00000002" / "model.txt"
    p.write_bytes(p.read_bytes()[:3])
    it, text, _, _, _ = mgr.load_latest()
    assert (it, text) == (1, "model-1")


@pytest.mark.parametrize("action", ["truncate", "raise"])
def test_injected_checkpoint_write_faults(tmp_path, action):
    mgr = CheckpointManager(str(tmp_path))
    with faultline.armed("checkpoint_write", action=action):
        if action == "raise":
            with pytest.raises(faultline.FaultInjected):
                _save(mgr, 1, "model body text")
        else:
            _save(mgr, 1, "model body text")
    assert mgr.load_latest() is None  # a torn write fails its CRC
    _save(mgr, 2)
    assert mgr.load_latest()[0] == 2  # temp debris cleaned, dir usable


def test_interrupted_prune_keeps_newest_and_recovers(tmp_path, monkeypatch):
    """An interrupt inside the pruning hits the oldest bundle first and
    never the one just written; the next save collects the leftovers."""
    import shutil

    backlog = CheckpointManager(str(tmp_path), keep=10)
    for it in (1, 2, 3, 4):
        _save(backlog, it)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    deleted = []

    def dying_rmtree(path, **kw):
        deleted.append(os.path.basename(str(path)))
        raise KeyboardInterrupt("SIGTERM")

    monkeypatch.setattr(shutil, "rmtree", dying_rmtree)
    with pytest.raises(KeyboardInterrupt):
        _save(mgr, 5)
    monkeypatch.undo()
    assert deleted == ["ckpt-00000001"]
    assert mgr.load_latest()[0] == 5
    _save(mgr, 6)
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("ckpt-")) == ["ckpt-00000005",
                                                "ckpt-00000006"]


def test_group_layouts_are_refused_by_name(tmp_path):
    """Once refused by name, the group layouts are the JAX package's: a
    manager of two hosts keeps this host's bundles under host-<k>/, and a
    torn group manifest is skipped, so a resume over it trains from the
    start (tests/test_torch_multiprocess.py holds real groups)."""
    from lightgbm_tpu.utils.checkpoint import CheckpointManager as JMgr

    for k in (0, 1):
        mine = CheckpointManager(str(tmp_path), host_count=2, host_index=k)
        theirs = JMgr(str(tmp_path), host_count=2, host_index=k)
        assert mine.directory == theirs.directory
        assert os.path.basename(mine.directory) == f"host-{k:05d}"
    (tmp_path / "global-00000003.json").write_text("{}")
    assert CheckpointManager(str(tmp_path)).load_latest_group() is None
    X, y = _inputs()["X"], _inputs()["y"]
    p = dict(INT8, **CPU, tpu_checkpoint_dir=str(tmp_path / "run"))
    b = tlgb.train(p, tlgb.Dataset(X, label=y), 2)
    (tmp_path / "run" / "global-00000003.json").write_text("{}")
    again = tlgb.train(p, tlgb.Dataset(X, label=y), 2, resume=True)
    assert again.num_trees() == 2
    assert again.model_to_string() == b.model_to_string()


# -- resume, in either package ----------------------------------------------
@pytest.mark.parametrize("mode", list(MODES))
def test_resume_matches_the_uninterrupted_run(runs, mode):
    """The port's uninterrupted text is the JAX package's; cut at
    iteration 3 and resumed from its bundle, the port gives it again."""
    _, port, jax = runs
    full = str(jax[f"full_{mode}"]["text"])
    assert port[f"full_{mode}"]["text"] == full
    assert port[f"resume_{mode}"]["text"] == full


@pytest.mark.parametrize("mode", CROSS)
def test_bundles_resume_across_the_packages(runs, mode):
    """A JAX bundle resumed by the port, and a port bundle resumed by the
    JAX package, each give the JAX package's uninterrupted text; both
    packages capture the same train state at the cut."""
    _, port, jax = runs
    full = str(jax[f"full_{mode}"]["text"])
    assert port[f"from_jax_{mode}"]["text"] == full
    assert str(jax[f"resume_{mode}"]["text"]) == full
    sp = json.loads(str(port[f"cut_{mode}"]["state"]))
    sj = json.loads(str(jax[f"cut_{mode}"]["state"]))
    assert sp == sj
    keys = sorted(k for k in port[f"cut_{mode}"] if k.startswith("arr:"))
    assert keys == sorted(k for k in jax[f"cut_{mode}"]
                          if k.startswith("arr:"))
    assert "arr:valid_scores/v" in keys
    for k in keys:
        np.testing.assert_array_equal(port[f"cut_{mode}"][k],
                                      jax[f"cut_{mode}"][k], err_msg=k)


def _train(params, rounds, **kw):
    inp = _inputs()
    ds = tlgb.Dataset(inp["X"], label=inp["y"], params=params)
    return tlgb.train(params, ds, rounds, keep_training_booster=True,
                      verbose_eval=False, **kw)


def test_checkpointing_is_invisible_and_resume_needs_a_dir(tmp_path):
    p = dict(INT8, **CPU)
    base = model_text(_train(p, 4))
    pc = dict(p, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_keep=2)
    assert model_text(_train(pc, 4)) == base
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000003",
                                            "ckpt-00000004"]
    with pytest.raises(ValueError, match="tpu_checkpoint_dir"):
        _train(p, 2, resume=True)
    # no bundle yet: resume trains from the start
    empty = dict(p, tpu_checkpoint_dir=str(tmp_path / "empty"))
    assert _train(empty, 3, resume=True).num_trees() == 3


def test_early_stopping_state_rides_the_bundle(tmp_path):
    inp = _inputs()
    p = dict(INT8, **CPU, tpu_checkpoint_dir=str(tmp_path),
             learning_rate=0.5)

    def run(rounds, resume=False):
        ds = tlgb.Dataset(inp["X"], label=inp["y"], params=p)
        vd = ds.create_valid(inp["Xv"], label=inp["yv"])
        return tlgb.train(p, ds, rounds, valid_sets=[vd],
                          early_stopping_rounds=2, verbose_eval=False,
                          resume=resume, keep_training_booster=True)

    full = run(30)
    assert 0 < full.best_iteration < 28   # the stop fired
    import shutil

    shutil.rmtree(tmp_path)
    cut = full.best_iteration - 1
    run(cut)
    resumed = run(30, resume=True)
    assert resumed.best_iteration == full.best_iteration
    assert model_text(resumed) == model_text(full)


def test_resume_after_init_model(tmp_path):
    """A continuation cut and resumed gives the uninterrupted
    continuation; bagging_freq=5 refreshes off the cut."""
    p = dict(INT8, **CPU, bagging_freq=5)
    init = _train(p, 3).model_to_string(num_iteration=-1)

    def cont(params, rounds, **kw):
        return _train(params, rounds,
                      init_model=tlgb.Booster(model_str=init, params=CPU),
                      **kw)

    full = cont(p, 6)
    assert full.num_trees() == 9
    pc = dict(p, tpu_checkpoint_dir=str(tmp_path))
    cont(pc, 3)
    resumed = cont(pc, 6, resume=True)
    assert resumed.num_trees() == 9
    assert model_text(resumed) == model_text(full)


# -- atomic iterations ------------------------------------------------------
def _booster(params):
    inp = _inputs()
    return tlgb.Booster(params=params, train_set=tlgb.Dataset(
        inp["X"], label=inp["y"], params=params))


def test_device_error_rolls_back_and_retrain_is_bitwise():
    p = dict(INT8, **CPU)
    base = model_text(_train(p, 5))
    bst = _booster(p)
    faultline.arm("grow_step", action="raise", at=3)
    errors = 0
    X = _inputs()["X"]
    while bst.current_iteration() < 5:
        try:
            bst.update()
        except faultline.FaultInjected:
            errors += 1
            assert bst.current_iteration() == 2
            assert np.isfinite(bst.predict(X[:16], raw_score=True)).all()
    assert errors == 1
    assert model_text(bst) == base


def test_interrupt_flushes_a_checkpoint_and_resume_is_bitwise(tmp_path):
    p = dict(INT8, **CPU)
    base = model_text(_train(p, 6))
    pc = dict(p, tpu_checkpoint_dir=str(tmp_path),
              tpu_checkpoint_interval=2)
    faultline.arm("grow_step", action="raise",
                  exc=KeyboardInterrupt("simulated preemption"), at=4)
    with pytest.raises(KeyboardInterrupt):
        _train(pc, 6)
    # iterations 0..2 completed; the flush wrote the off-interval 3
    assert CheckpointManager(str(tmp_path)).latest_iteration() == 3
    faultline.reset()
    assert model_text(_train(pc, 6, resume=True)) == base


def test_sigterm_flushes_a_checkpoint_and_the_blackbox(tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers need the main thread")
    pc = dict(INT8, **CPU, tpu_checkpoint_dir=str(tmp_path / "ck"),
              tpu_checkpoint_interval=100,
              tpu_obs_blackbox_dir=str(tmp_path))

    class KillAt:
        order = 0
        before_iteration = True

        def __call__(self, env):
            if env.iteration == 3:
                os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.raises(KeyboardInterrupt):
            _train(pc, 6, callbacks=[KillAt()])
    finally:
        from lightgbm_tpu_torch.obs import flightrecorder

        flightrecorder.configure(dump_dir="")
    assert CheckpointManager(str(tmp_path / "ck")).latest_iteration() == 3
    assert signal.getsignal(signal.SIGTERM) == before  # handler restored
    dump = json.loads((tmp_path / "blackbox-host0.json").read_text())
    assert dump["reason"] == "train_interrupt:KeyboardInterrupt"
    assert dump["metrics"]  # the checkpoint counters landed first


@pytest.mark.parametrize("point", ["grow_step", "h2d_copy",
                                   "checkpoint_write"])
def test_booster_usable_after_interrupt_at_each_point(point, tmp_path):
    p = dict(INT8, **CPU)
    base = model_text(_train(p, 3))
    bst = _booster(p)
    bst.update()
    faultline.arm(point, action="raise", exc=KeyboardInterrupt("simulated"))
    X = _inputs()["X"]
    with pytest.raises(KeyboardInterrupt):
        bst.update()                                  # grow_step
        bst.save_checkpoint(str(tmp_path / point))    # checkpoint_write
        bst.predict(X[:64], raw_score=True)           # h2d_copy
    faultline.reset()
    assert np.isfinite(bst.predict(X[:16], raw_score=True)).all()
    while bst.current_iteration() < 3:
        bst.update()
    assert model_text(bst) == base


def test_dart_normalization_undone_on_rollback():
    """DART scales the dropped trees in place; a rolled-back iteration
    puts their leaf values and weights back."""
    p = dict(MODES["dart_int8"], **CPU)
    base = model_text(_train(p, 5))
    bst = _booster(dict(p, tpu_guard_numerics="raise"))
    faultline.arm("grow_step", action="poison", at=3)
    done = errors = 0
    while done < 5:
        try:
            bst.update()
            done += 1
        except LightGBMError:
            errors += 1
    assert errors == 1
    assert model_text(bst) == base


def test_flush_rewrites_a_torn_same_iteration_bundle(tmp_path):
    bst = _booster(dict(INT8, **CPU))
    bst.update()
    bst.update()
    mgr = CheckpointManager(str(tmp_path))
    bst.save_checkpoint(str(tmp_path))
    with open(os.path.join(mgr.checkpoints()[0][1], "manifest.json"),
              "w") as f:
        f.write("{torn")
    flush_checkpoint(bst, mgr)
    found = mgr.load_latest()
    assert found is not None and found[0] == 2


# -- the numeric guard ------------------------------------------------------
def test_guard_skip_matches_the_jax_package(runs):
    """Poisoned at its third iteration under skip: the same iteration
    dropped, the same retry, the same text as the JAX package's."""
    _, port, jax = runs
    assert int(port["guard"]["skips"]) == int(jax["guard"]["skips"]) == 1
    assert int(port["guard"]["iteration"]) == 5
    assert port["guard"]["text"] == str(jax["guard"]["text"])


def _poisoned(mode, rounds=4, at=2, **extra):
    bst = _booster(dict(INT8, **CPU, tpu_guard_numerics=mode, **extra))
    faultline.arm("grow_step", action="poison", at=at)
    raised = None
    try:
        for _ in range(rounds):
            bst.update()
    except LightGBMError as exc:
        raised = exc
    return bst, raised


@pytest.mark.parametrize("mode", ["off", "warn", "raise", "skip"])
def test_guard_modes(mode, capsys):
    bst, raised = _poisoned(mode, rounds=5)
    finite = np.isfinite(bst._driver.train_scores.numpy()).all()
    X = _inputs()["X"]
    if mode in ("off", "warn"):
        assert raised is None and not finite
        if mode == "warn":
            assert "tpu_guard_numerics=warn" in capsys.readouterr().out
        return
    assert finite
    assert np.isfinite(bst.predict(X[:16], raw_score=True)).all()
    if mode == "raise":
        assert raised is not None and "non-finite" in str(raised)
        assert bst.current_iteration() == 1
    else:
        assert raised is None
        assert bst._driver._guard_skips_total == 1
        assert bst.current_iteration() == 4


def test_guard_streak_cap_and_rebag_off_the_boundary():
    bst = _booster(dict(INT8, **CPU, tpu_guard_numerics="skip"))
    faultline.arm("grow_step", action="poison", at=1, times=50)
    with pytest.raises(LightGBMError, match="consecutive poisoned"):
        for _ in range(20):
            bst.update()
    faultline.reset()
    # off the bagging_freq boundary the retry still draws a fresh mask
    bst, raised = _poisoned("skip", rounds=6, at=3, bagging_freq=5)
    assert raised is None and bst._driver._guard_skips_total == 1
    assert np.isfinite(bst._driver.train_scores.numpy()).all()


def test_guard_skip_without_stochastic_lever_raises_at_once():
    bst, raised = _poisoned("skip", bagging_freq=0, bagging_fraction=1.0,
                            tpu_hist_precision="f32")
    assert raised is not None and "no stochastic lever" in str(raised)
    assert bst._driver._guard_skips_total == 0
    assert np.isfinite(bst.predict(_inputs()["X"][:16],
                                   raw_score=True)).all()


def test_quant_headroom_sentinel(capsys):
    q = quant_headroom_check("int16", 200_000, "warn")
    assert q < 32767
    assert "histogram headroom" in capsys.readouterr().out
    quant_headroom_check("int16", 10_000_000, "warn")
    with pytest.raises(LightGBMError, match="headroom"):
        quant_headroom_check("int16", 100_000_000, "raise")
    capsys.readouterr()
    quant_headroom_check("int16", 1000, "warn")
    assert "headroom" not in capsys.readouterr().out
    assert quant_headroom_check("int8", 20_000_000, "raise") > 31
