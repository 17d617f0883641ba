"""The streamed layout of lightgbm_tpu_torch (ops/stream.py) against
lightgbm_tpu's, after tests/test_stream.py's sections:

1. int8/int16 streamed model texts byte-identical to the JAX package's
   streamed texts (its no-FMA process, job "stream" of
   tests/test_torch_util.py) and to the port's resident sync run; hilo
   trees within the resident float tolerance of the JAX package's;
2. the partial tail block and the single block, bitwise the resident
   grower; `resolve_stream_rows` and `make_host_blocks` the JAX ones;
3. GOSS block sampling: weights and uniforms bitwise the JAX package's,
   its text the JAX text, invariant to tpu_stream_double_buffer;
4. `select_layout` and the plan's stream_slots held to the live slots;
5. the OOM ladder's last rung, stream_layout, as the JAX package takes it;
6. a streamed run resumed mid-way, bitwise;
7. the compile ledger's plans bounded across blocks and rounds.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.models import gbdt as gbdt_mod
from lightgbm_tpu_torch.models.learner import (StreamedTreeLearner,
                                               TreeLearner,
                                               make_tree_learner)
from lightgbm_tpu_torch.ops.stream import (make_host_blocks,
                                           resolve_stream_rows,
                                           stream_supported)
from lightgbm_tpu_torch.utils import faultline, membudget
from lightgbm_tpu_torch.utils.compile_ledger import LEDGER

from .test_torch_util import (assert_trees_match, binary_data, model_text,
                              start_jax_nofma, stream_run)

CPU = {"device_type": "cpu", "verbosity": -1}
# the leaf refit off, as the other bitwise tests of the port hold int8
# and int16 to the JAX package (the refit's sums are the port's own
# order: tests/test_torch_leafsum.py)
P = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
     "min_data_in_leaf": 5, "seed": 7, "tpu_block_rows": 256,
     "tpu_hist_precision": "int16", "tpu_quant_refit_leaves": False}
GOSS = dict(tpu_stream_goss_top=0.34, tpu_stream_goss_other=0.25,
            tpu_stream_block_rows=256)
# the JAX ladder test's data and the rung count that reaches the last one
LADDER_TIMES = 6


def _data(n=1500, f=8, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32).astype(np.float64)
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    return X, y


def _inputs():
    X, y = _data()
    rng = np.random.default_rng(13)
    n_pad = 1536
    g = np.zeros(n_pad, np.float32)
    h = np.zeros(n_pad, np.float32)
    g[:len(y)] = rng.normal(size=len(y))
    h[:len(y)] = np.abs(rng.normal(size=len(y))) + 0.1
    mask = np.zeros(n_pad, np.float32)
    mask[:len(y)] = 1.0
    return {"X": X, "y": y, "goss_g": g, "goss_h": h, "goss_mask": mask,
            "goss_key": np.array([0, 5], np.uint32)}


RUNS = {
    "int8": {"kind": "text", "params": dict(
        P, tpu_hist_precision="int8", tpu_stream_mode="streamed",
        tpu_stream_block_rows=512)},
    "int16": {"kind": "text", "params": dict(
        P, tpu_stream_mode="streamed", tpu_stream_block_rows=512)},
    "int8_tail": {"kind": "text", "params": dict(
        P, tpu_hist_precision="int8", tpu_stream_mode="streamed",
        tpu_stream_block_rows=1024)},
    "goss_int8": {"kind": "text", "params": dict(
        P, tpu_hist_precision="int8", tpu_stream_mode="streamed", **GOSS)},
    "goss_plan": {"kind": "goss_plan", "params": dict(
        P, tpu_stream_mode="streamed", **GOSS)},
    "ladder": {"kind": "ladder", "times": LADDER_TIMES, "params": dict(
        P, tpu_hist_precision="int8")},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port, JAX) results of every shared case."""
    inp = _inputs()
    names = list(RUNS)
    job = start_jax_nofma("stream", inp,
                          {"runs": [RUNS[k] for k in names]},
                          tmp_path_factory.mktemp("stream_job"))
    port = {k: stream_run(tlgb, inp, RUNS[k]) for k in names}
    out = job()
    jax = {k: {key.split("_", 1)[1]: v for key, v in out.items()
               if key.split("_", 1)[0] == str(c)}
           for c, k in enumerate(names)}
    return port, jax


@pytest.fixture(autouse=True)
def _clean_faults():
    faultline.reset()
    yield
    faultline.reset()


@pytest.fixture
def sync_resident(monkeypatch):
    """The resident reference on the sync path, as tests/test_stream.py
    pins it: the streamed layout always takes it."""
    monkeypatch.setattr(gbdt_mod.GBDT, "_make_train_step",
                        lambda self: setattr(self, "_step", None))


def _train(params, X, y, rounds=5, **kw):
    p = dict(params, **CPU)
    return tlgb.train(p, tlgb.Dataset(X, label=y, params=p), rounds,
                      keep_training_booster=True, verbose_eval=False, **kw)


# -- 1. the texts ------------------------------------------------------------
@pytest.mark.parametrize("name", ["int8", "int16", "int8_tail"])
def test_streamed_text_is_the_jax_streamed_text(runs, name):
    port, jax = runs
    assert port[name]["text"] == str(jax[name]["text"])


@pytest.mark.parametrize("precision", ["int8", "int16"])
def test_streamed_equals_resident_sync(sync_resident, precision):
    """With the leaf refit on (the default): the same refit code reads
    the same leaf ids."""
    X, y = _data()
    p = dict(P, tpu_hist_precision=precision, tpu_stream_block_rows=512,
             tpu_quant_refit_leaves=True)
    ref = _train(dict(p, tpu_stream_mode="resident"), X, y)
    got = _train(dict(p, tpu_stream_mode="streamed"), X, y)
    assert isinstance(got._driver.learner, StreamedTreeLearner)
    assert not isinstance(ref._driver.learner, StreamedTreeLearner)
    assert model_text(got) == model_text(ref)


def test_hilo_streamed_trees_match_the_jax_package():
    """Float histograms reassociate at the block seam in both packages:
    the trees agree within the resident float tolerance."""
    import lightgbm_tpu as jlgb

    # NaNs in every column: each split's default direction is decided by
    # missing rows, not by a float tie between two equal directions
    X, y = binary_data(n=1500, f=6, seed=1)
    p = dict(P, tpu_hist_precision="hilo", tpu_stream_mode="streamed",
             tpu_stream_block_rows=512, verbosity=-1)
    want = jlgb.train(p, jlgb.Dataset(X, label=y), 5)
    got = _train(p, X, y)
    assert_trees_match(want._driver.models, got._driver.models)


# -- 2. geometry -------------------------------------------------------------
def _learner_pair(X, y, stream_rows, **extra):
    out = []
    for mode in ("resident", "streamed"):
        cfg = Config(dict(P, **CPU, tpu_stream_mode=mode,
                          tpu_stream_block_rows=stream_rows, **extra))
        td = TrainingData.from_matrix(X, y, cfg)
        out.append(make_tree_learner(cfg, td))
    return out


def _grow_once(learner, grad, hess):
    _, leaf_ids, out = learner.train(torch.as_tensor(grad),
                                     torch.as_tensor(hess))
    return out["records"].numpy(), leaf_ids.numpy()


@pytest.mark.parametrize("stream_rows,blocks", [(1024, 2), (10 ** 9, 1)])
def test_tail_and_single_block_grow_the_resident_tree(stream_rows, blocks):
    X, y = _data(n=1500 if blocks == 2 else 600)
    rng = np.random.default_rng(11)
    grad = rng.normal(size=len(y)).astype(np.float32)
    hess = (np.abs(rng.normal(size=len(y))) + 0.1).astype(np.float32)
    res, stream = _learner_pair(X, y, stream_rows)
    widths = [b.shape[0] for b in stream._host_blocks]
    assert len(widths) == blocks and sum(widths) == stream.n_pad
    if blocks == 2:
        assert widths[-1] < widths[0]
    r1, l1 = _grow_once(res, grad, hess)
    r2, l2 = _grow_once(stream, grad, hess)
    assert np.array_equal(r1, r2) and np.array_equal(l1, l2)
    stats = stream.stream_stats
    assert stats["blocks_streamed"] == blocks
    # every block once a histogram pass: the root's and each round's
    assert stats["h2d_bytes"] == (stats["rounds"] + 1) * sum(
        b.nbytes for b in stream._host_blocks)


@pytest.mark.parametrize("cfg_rows,n_pad,inner,budget", [
    (0, 8192, 512, None), (700, 8192, 512, None), (512, 512, 512, None),
    (10 ** 9, 4096, 1024, None), (0, 1 << 20, 256, 256 << 20)])
def test_resolve_stream_rows_is_the_jax_rule(cfg_rows, n_pad, inner, budget):
    from lightgbm_tpu.ops.stream import resolve_stream_rows as jax_rows

    got = resolve_stream_rows(cfg_rows, n_pad, 64, inner, budget)
    assert got == jax_rows(cfg_rows, n_pad, 64, inner, budget)
    assert inner <= got <= n_pad and got % inner == 0


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_host_blocks_are_the_jax_blocks_row_major(dtype):
    from lightgbm_tpu.ops.stream import make_host_blocks as jax_blocks

    rng = np.random.default_rng(4)
    top = 255 if dtype == np.uint8 else 1000
    n, n_pad = 1200, 1280
    bins = rng.integers(0, top, size=(7, n)).astype(dtype)
    padded = np.zeros((7, n_pad), dtype)
    padded[:, :n] = bins
    want = jax_blocks(padded, 512)
    got = make_host_blocks(torch.as_tensor(bins), 512, n_pad, 32)
    assert [b.shape[0] for b in got] == [w.shape[1] for w in want]
    for g, w in zip(got, want):
        assert g.shape[1] == 32 and g.is_contiguous()
        cols = g[:, :7].numpy().T.astype(np.int64) & 0xFFFF
        assert np.array_equal(cols, w.astype(np.int64))
        assert not g[:, 7:].any()


def test_stream_supported_names_the_jax_blockers():
    res, _ = _learner_pair(*_data(n=600), 512)
    ok = res.params
    assert stream_supported(ok) is None
    assert stream_supported(ok._replace(has_cat=True)) \
        == "categorical features"
    for field, value in (("has_bundles", True), ("has_sparse", True),
                         ("has_cegb", True), ("forced", ((0, 1, 2),)),
                         ("feature_fraction_bynode", 0.5),
                         ("packed_bins", True)):
        assert stream_supported(ok._replace(**{field: value})), field
    X, y = _data(n=600)
    X[:, 2] = np.floor(np.abs(X[:, 2]) * 3)
    p = dict(P, **CPU, tpu_stream_mode="streamed")
    with pytest.raises(NotImplementedError,
                       match="does not support categorical features"):
        tlgb.train(p, tlgb.Dataset(X, label=y, params=p,
                                   categorical_feature=[2]), 1)
    with pytest.raises(NotImplementedError, match="tree_learner=serial"):
        tlgb.train(dict(p, tree_learner="data"),
                   tlgb.Dataset(X, label=y, params=p), 1)


# -- 3. GOSS block sampling --------------------------------------------------
def test_goss_plan_is_the_jax_plan(runs):
    port, jax = runs
    np.testing.assert_array_equal(port["goss_plan"]["u"],
                                  jax["goss_plan"]["u"])
    np.testing.assert_array_equal(port["goss_plan"]["w"],
                                  jax["goss_plan"]["w"])
    w = port["goss_plan"]["w"]
    assert (w == 0).any() and (w > 1).any()


def test_goss_text_is_the_jax_text(runs):
    port, jax = runs
    assert port["goss_int8"]["text"] == str(jax["goss_int8"]["text"])


def test_goss_invariant_to_double_buffer_and_reruns():
    X, y = _data()
    p = dict(P, tpu_hist_precision="int8", tpu_stream_mode="streamed",
             **GOSS)
    a = _train(dict(p, tpu_stream_double_buffer=True), X, y)
    b = _train(dict(p, tpu_stream_double_buffer=False), X, y)
    c = _train(p, X, y)
    assert model_text(a) == model_text(b) == model_text(c)
    stats = a._driver.learner.stream_stats
    assert stats["blocks_skipped"] > 0
    assert stats["blocks_streamed"] + stats["blocks_skipped"] == 6


# -- 4. layout selection and the plan ----------------------------------------
@pytest.mark.parametrize("mode,budget,want", [
    ("auto", 2 * 1500, "streamed"), ("auto", 1 << 32, "resident"),
    ("streamed", None, "streamed"), ("resident", 2 * 1500, "resident")])
def test_select_layout_is_the_jax_rule(mode, budget, want):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
    from lightgbm_tpu.utils import membudget as jmembudget

    X, y = _data()
    p = dict(P, tpu_stream_mode=mode)
    if budget:
        p["tpu_hbm_budget_bytes"] = budget
    cfg = Config(dict(p, **CPU))
    td = TrainingData.from_matrix(X, y, cfg)
    jcfg = JConfig(p)
    assert membudget.select_layout(cfg, td) == want \
        == jmembudget.select_layout(jcfg, JTrainingData.from_matrix(X, y,
                                                                    jcfg))
    learner = make_tree_learner(cfg, td)
    assert isinstance(learner, StreamedTreeLearner) == (want == "streamed")
    assert isinstance(learner, TreeLearner)


def test_plan_swaps_the_matrix_for_the_live_slots():
    X, y = _data()
    b = _train(dict(P, tpu_stream_mode="streamed", tpu_stream_block_rows=512),
               X, y, rounds=1)
    drv = b._driver
    plan = membudget.plan_training(drv.config, drv.learner, 1)
    assert "binned_matrix" not in plan.components
    assert "row_major_bins" not in plan.components
    slots = plan.components["stream_slots"]
    assert slots == 2 * max(blk.nbytes for blk in drv.learner._host_blocks)
    assert slots == drv.learner._stream.slot_bytes() == 2 * 512 * 32
    live = membudget.live_bytes(drv)
    for name, value in live.items():
        assert plan.components[name] == value, name
    # the plan of a ladder rebuild, made before the learner is: the
    # resident learner's closed form gives the same slots
    res = _train(dict(P, tpu_stream_block_rows=512), X, y, rounds=1)._driver
    cfg = Config(dict(P, **CPU, tpu_stream_block_rows=512,
                      tpu_stream_mode="streamed"))
    assert membudget.plan_training(cfg, res.learner, 1).components[
        "stream_slots"] == slots


# -- 5. the ladder ------------------------------------------------------------
def test_ladder_degrades_to_streaming_as_the_jax_package(runs):
    port, jax = runs
    steps = ["shrink_chunk_rows"] * 4 + ["bucket_policy_fine",
                                         "stream_layout"]
    assert port["ladder"]["steps"] == str(jax["ladder"]["steps"])
    import json
    assert json.loads(port["ladder"]["steps"]) == steps
    assert port["ladder"]["learner"] == "StreamedTreeLearner"
    assert str(jax["ladder"]["learner"]) == "StreamedTreeLearner"
    assert port["ladder"]["text"] == str(jax["ladder"]["text"])


def test_ladder_rung_rebuilds_the_learner_streamed():
    """After the last rung the run goes on streamed: the resident bins
    are gone, the learner keeps host blocks and the booster predicts."""
    X, y = _data(n=800, f=6, seed=0)
    p = dict(P, **CPU, tpu_hist_precision="int8")
    b = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))
    b.update()
    faultline.arm("device_alloc", action="oom", times=LADDER_TIMES)
    b.update()
    b.update()
    faultline.reset()
    drv = b._driver
    assert drv._mem_ladder.describe()[-1] == "stream_layout"
    assert str(drv.config.tpu_stream_mode) == "streamed"
    assert isinstance(drv.learner, StreamedTreeLearner)
    assert drv.learner.bins_t is None and drv.learner._host_blocks
    assert drv._step is None and drv._ladder_carry is None
    assert b.current_iteration() == 3
    assert np.isfinite(b.predict(X[:8], raw_score=True)).all()


# -- 6. resume ----------------------------------------------------------------
def test_resume_mid_streamed_run_is_bitwise(tmp_path):
    X, y = _data()
    p = dict(P, tpu_stream_mode="streamed", tpu_stream_block_rows=512)
    base = model_text(_train(p, X, y, rounds=6))
    pc = dict(p, tpu_checkpoint_dir=str(tmp_path),
              tpu_checkpoint_interval=1)
    _train(pc, X, y, rounds=3)
    resumed = _train(pc, X, y, rounds=6, resume=True)
    assert isinstance(resumed._driver.learner, StreamedTreeLearner)
    assert model_text(resumed) == base


# -- 7. the compile ledger ----------------------------------------------------
def test_ledger_plans_bounded_across_blocks_and_rounds():
    """One plan a block width (the full block and the tail) for the
    histogram site, and more iterations add none."""
    X, y = _data(n=1600)
    p = dict(P, tpu_stream_mode="streamed", tpu_stream_block_rows=1024)
    LEDGER.enable()
    LEDGER.reset()
    try:
        b = _train(p, X, y, rounds=3)
        assert b._driver.learner._stream.nbs == 2
        assert LEDGER.n_programs("hist_batched") == 2
        before = LEDGER.n_programs()
        b.update()
        b.update()
        assert LEDGER.n_programs() == before
        report = {r["site"]: r["programs"] for r in LEDGER.report()}
        assert report == {"hist_batched": 2}
        assert "hist_batched" in LEDGER.format_report()
    finally:
        LEDGER.enable(False)
        LEDGER.reset()
