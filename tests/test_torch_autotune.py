"""Builds and tuning of lightgbm_tpu_torch: the autotune profile
(utils/autotune.py) against lightgbm_tpu's, the build ledger
(utils/compile_ledger.py) and its cross-check with the memory plan, and
the plan's predict chunk held to a chunk's tensors."""

import json

import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils import autotune, membudget
from lightgbm_tpu_torch.utils.compile_ledger import LEDGER, CompileLedger

from .test_torch_util import binary_data, model_text

CPU = {"device_type": "cpu", "verbosity": -1}
INT8 = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
        "min_data_in_leaf": 5, "tpu_hist_precision": "int8",
        "tpu_quant_refit_leaves": False}


def _train(params, rounds=3, n=1200):
    X, y = binary_data(n=n, f=5, seed=2)
    p = dict(params, **CPU)
    return tlgb.train(p, tlgb.Dataset(X, label=y, params=p), rounds,
                      keep_training_booster=True, verbose_eval=False)


# -- the profile -------------------------------------------------------------
def test_tune_writes_a_profile_of_this_device_and_load_reads_it(tmp_path):
    path = str(tmp_path / "prof.json")
    b = _train(dict(INT8, tpu_autotune="tune", tpu_autotune_profile=path))
    prof = json.loads(open(path).read())
    assert {k: prof[k] for k in ("platform", "device_count",
                                 "device_name")} == {
        "platform": "cpu", "device_count": 1, "device_name": "cpu"}
    assert prof["version"] == autotune.PROFILE_VERSION
    (bucket, entry), = prof["entries"].items()
    assert bucket == autotune.shape_bucket(1200, 5, 31)
    assert set(entry["table"]) == {"pallas2:4096", "pallas2:8192",
                                   "pallas:256", "fused:4096",
                                   "fused:8192"}
    assert b._driver.learner.params.hist_impl == entry["hist_impl"]
    loaded = _train(dict(INT8, tpu_autotune="load",
                         tpu_autotune_profile=path))
    assert loaded._driver.learner._autotune_entry == entry
    assert loaded._driver.learner.params.hist_impl == entry["hist_impl"]
    # a bucket the profile lacks keeps the built-in rule under load
    other = _train(dict(INT8, tpu_autotune="load", tpu_autotune_profile=path),
                   n=5000)
    assert other._driver.learner._autotune_entry is None


def test_a_jax_written_profile_is_stale(tmp_path):
    from lightgbm_tpu.utils import autotune as jautotune

    path = str(tmp_path / "jax.json")
    bucket = autotune.shape_bucket(1200, 5, 31)
    jautotune.save_profile(path, {
        "version": jautotune.PROFILE_VERSION,
        **jautotune.backend_fingerprint(),
        "entries": {bucket: {"hist_impl": "pallas2", "block_rows": 8192,
                             "rows_per_sec": 1.0, "precision": "int8",
                             "table": {}}}})
    for mode in ("load", "tune"):
        with pytest.raises(autotune.AutotuneStaleProfile,
                           match="was recorded on"):
            _train(dict(INT8, tpu_autotune=mode, tpu_autotune_profile=path))
    # and another card's profile
    prof = json.loads(open(path).read())
    prof.update(platform="gpu", device_count=1, device_name="NVIDIA A100")
    autotune.save_profile(path, prof)
    with pytest.raises(autotune.AutotuneStaleProfile, match="platform"):
        _train(dict(INT8, tpu_autotune="load", tpu_autotune_profile=path))
    with pytest.raises(ValueError, match="tpu_autotune"):
        _train(dict(INT8, tpu_autotune="sometimes"))


@pytest.mark.parametrize("winner", ["pallas2:4096", "pallas:256",
                                    "fused:8192"])
def test_a_tuned_int8_run_writes_the_untuned_text(tmp_path, winner):
    path = str(tmp_path / "prof.json")
    impl, block = winner.split(":")
    autotune.save_profile(path, {
        "version": autotune.PROFILE_VERSION,
        **autotune.backend_fingerprint("cpu"),
        "entries": {autotune.shape_bucket(1200, 5, 31): {
            "hist_impl": impl, "block_rows": int(block),
            "rows_per_sec": 1.0, "precision": "int8", "table": {}}}})
    ref = _train(INT8)
    got = _train(dict(INT8, tpu_autotune="load", tpu_autotune_profile=path))
    assert got._driver.learner.params.hist_impl == impl
    assert got._driver.learner.params.block_rows == int(block)
    assert model_text(got) == model_text(ref)


def test_autotune_scratch_is_planned():
    b = _train(dict(INT8, tpu_autotune="load",
                    tpu_autotune_profile="/nonexistent/prof.json"))
    drv = b._driver
    plan = membudget.plan_training(drv.config, drv.learner, 1)
    assert plan.components["autotune_scratch"] == autotune.probe_bytes(
        drv.learner.n_pad, drv.learner.g_pad)
    assert "autotune_scratch" not in membudget.plan_training(
        tlgb.basic.Config(dict(INT8, **CPU)), drv.learner, 1).components


# -- the build ledger ----------------------------------------------------------
def test_ledger_records_each_plan_once():
    ledger = CompileLedger()
    with ledger.launch("hist_batched", "hist_batched_int", (1, 2, 3)):
        pass
    assert ledger.n_programs() == 0       # off: nothing recorded
    ledger.enable()
    for plan in ((1, 2, 3), (1, 2, 3), (1, 2, 4)):
        with ledger.launch("hist_batched", "hist_batched_int", plan, 40):
            pass
    assert ledger.n_programs() == 2 == ledger.n_programs("hist_batched")
    assert ledger.n_programs("leaf_sums") == 0
    ledger.record_build(1.5, True, "abc")
    assert ledger.builds()[0]["built"]
    assert "built in 1.50 s" in ledger.format_report()
    assert [r["argument_bytes"] for r in ledger.cost_table()] == [40, 40]
    with pytest.raises(NotImplementedError, match="analyze"):
        ledger.analyze()
    ledger.reset()
    assert ledger.n_programs() == 0 and ledger.builds()


def test_ledger_cross_check_on_a_real_run():
    LEDGER.enable()
    LEDGER.reset()
    try:
        drv = _train(dict(INT8, tpu_hist_impl="pallas2"))._driver
        plan = membudget.plan_training(drv.config, drv.learner, 1)
        check = membudget.ledger_cross_check(plan, "hist")
        assert check["site"] == "hist_batched" and check["covered"]
        assert check["plan_kernel_scratch"] \
            == plan.components["kernel_scratch"]
        assert membudget.ledger_cross_check(plan, "leaf_group") is None
    finally:
        LEDGER.enable(False)
        LEDGER.reset()
    assert membudget.ledger_cross_check(plan, "hist") is None


# -- the predict chunk ---------------------------------------------------------
@pytest.mark.parametrize("rounds", [2, 6])
def test_predict_scratch_is_a_chunks_tensors(rounds):
    # a Booster keeps num_iterations in its config (lgb.train takes it as
    # its round count), the tree count the plan is made at
    p = dict(INT8, **CPU, num_iterations=rounds, tpu_predict_chunk_rows=2048)
    # more training rows than a chunk: the plan's chunk is at most the
    # rows of the largest set a run predicts
    X, y = binary_data(n=2500, f=5, seed=2)
    b = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))
    for _ in range(rounds):
        b.update()
    drv = b._driver
    assert drv.predict_scratch_bytes is None
    assert "predict_scratch" not in membudget.live_bytes(drv)
    X, _ = binary_data(n=5000, f=5, seed=9)
    b.predict(X)
    live = membudget.live_bytes(drv)
    plan = membudget.plan_training(drv.config, drv.learner, 1)
    assert live["predict_scratch"] == plan.components["predict_scratch"]
    # the walk's planes grow with the trees
    assert plan.components["predict_scratch"] > 2048 * 5 * 33
