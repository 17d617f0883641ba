"""The distributed learners of lightgbm_tpu_torch across processes, against
lightgbm_tpu: the torch.distributed (gloo) transport under the collective
vocabulary, `machines` and `pre_partition`, distributed binning, metric
sync, `set_network` and the checkpoint group with elastic resume.

One module fixture starts everything once and in parallel:
* the JAX package's in-process grid at tpu_topology_hosts=2 and
  num_machines=4, in one no-FMA process with 8 virtual CPU devices (job
  "train_sharded" of tests/test_torch_util.py);
* two port workers (tests/torch_mp_worker.py, `sys.executable -c`,
  device_type=cpu) that rendezvous over `machines` and run every case of
  the spec in sequence, asserting that JAX never loads;
* the port's in-process runs of the same grid, here.

The contract, as the JAX package proves its own multi-process runs
(tests/test_multihost.py, tests/test_topology.py, tests/test_collective.py):
* int8/int16: both ranks' texts byte-identical, equal to the JAX
  package's in-process grid and to the port's in-process run (hilo: the
  port's run bit for bit, the JAX package's within `assert_trees_match`);
* pre_partition: mappers equal to `find_mappers_multihost` rebuilt from
  its pure functions; the int8 text the port's in-process data run over
  those mappers (an uneven split: the same structure);
* a partitioned validation set: bitwise equal curves and early stop on
  both ranks, within 2e-4 of the whole set's logloss and AUC;
* the checkpoint group is one the JAX manager validates, and resumes in
  one process at another shard count to the uninterrupted text;
* a dropped host makes its peer raise within the deadline.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.io import distributed_binning as tdb
from lightgbm_tpu_torch.io.bin_mapper import BinMapper
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.parallel import collective, mesh, metric_sync
from lightgbm_tpu_torch.parallel import topology
from lightgbm_tpu_torch.parallel.collective import (CollectiveTimeout,
                                                    HostDropped)
from lightgbm_tpu_torch.utils import checkpoint as tckpt
from lightgbm_tpu_torch.utils import faultline

from .test_torch_util import (SHARDED_FLAGS, assert_trees_match,
                              model_text, sharded_run, start_jax_nofma)
from .torch_mp_worker import (BASE, INT8, TIMEOUT_S, grid_cat, grid_data,
                              problem)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3
INT16 = dict(INT8, tpu_hist_precision="int16")
HILO = dict(BASE, objective="binary", tpu_hist_precision="hilo")


def _learner(name, **kw):
    return dict(tree_learner=name, num_machines=4, **kw)


# name -> params of the grid: every learner across the two processes,
# two shards a process
GRID = {}
for _prec, _base in (("int8", INT8), ("int16", INT16)):
    GRID[f"data_{_prec}"] = dict(_base, **_learner("data"))
    GRID[f"data_psum_{_prec}"] = dict(_base, **_learner(
        "data", tpu_hist_agg="psum"))
    GRID[f"voting_{_prec}"] = dict(_base, **_learner("voting"))
    GRID[f"feature_{_prec}"] = dict(_base, **_learner("feature"))
    GRID[f"data_feature_{_prec}"] = dict(_base, **_learner("data_feature"))
GRID["data_hilo"] = dict(HILO, **_learner("data"))
# EFB bundles under data (the one-hot columns of efb_problem), psum and
# scatter (each shard searching the features of its bundle columns)
GRID["data_efb_int8"] = dict(INT8, **_learner("data"))
GRID["data_psum_efb_int8"] = dict(INT8, **_learner("data",
                                                   tpu_hist_agg="psum"))
# the features a sharded learner once refused, together: monotone
# constraints, per-node feature sampling, coupled CEGB and a categorical
# column (tests/torch_mp_worker.py:cat_problem); then deterministic=true,
# last (the JAX learner turns x64 on for its process)
GRID["data_features_int8"] = dict(
    INT8, tpu_partition_impl="select",
    monotone_constraints=[1, 1, -1] + [0] * 7, feature_fraction_bynode=0.5,
    cegb_penalty_feature_coupled=[5.0] * 10, **_learner("data"))
GRID["data_det_f64"] = dict(INT8, tpu_hist_precision="f32",
                            deterministic=True, **_learner("data"))
# pre_partition: rank 0 holds rows [0, cut), rank 1 the rest.  "even"
# splits the rows at a row-shard boundary; "uneven" does not; "efb"
# plans its bundles across the processes (find_bundles_multihost)
PREPART = {"even": 2048, "uneven": 2100, "efb": 2048}
CKPT_ROUNDS = 2


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _in_process(name):
    return dict(GRID[name], tpu_topology_hosts=2)


def _start_workers(tmp, spec):
    """The two ranks, each with its own log; returns (procs, logs)."""
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    procs, logs = [], []
    for rank in range(2):
        log = open(tmp / f"rank{rank}.log", "w")
        env = dict(os.environ, LIGHTGBM_TPU_PROCESS_ID=str(rank))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[2]); "
             "from tests.torch_mp_worker import main; main()",
             str(path), ROOT],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        logs.append(tmp / f"rank{rank}.log")
    return procs, logs


def _wait_workers(procs, logs, timeout):
    """Wait for both ranks; if one runs out of time, kill every peer and
    fail with the last 4,000 characters of each log."""
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            pytest.fail("a worker timed out:\n" + "\n".join(
                f"--- rank {k}:\n{log.read_text()[-4000:]}"
                for k, log in enumerate(logs)))
    for k, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, \
            f"rank {k} failed:\n{log.read_text()[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' results, the port's in-process texts, the JAX
    package's grid)."""
    tmp = tmp_path_factory.mktemp("mp")
    X, yb, yr = problem()
    Xn = problem(nan=True)[0]
    Xe, _, ye = grid_data("efb")
    Xc, _, yc = grid_data("features")
    jax_runs = [{"params": _in_process(n), "rounds": ROUNDS,
                 "data": ("nan" if n.endswith("hilo") else
                          "efb" if "efb" in n else
                          "cat" if "features" in n else "a"),
                 "label": ("bin" if GRID[n]["objective"] == "binary" else
                           "efb" if "efb" in n else
                           "cat" if "features" in n else "reg"),
                 "cat": grid_cat(n)} for n in GRID]
    wait_jax = start_jax_nofma(
        "train_sharded", {"X_a": X, "X_nan": Xn, "X_efb": Xe, "y_bin": yb,
                          "y_reg": yr, "y_efb": ye, "X_cat": Xc,
                          "y_cat": yc},
        {"runs": jax_runs}, tmp, xla_flags=SHARDED_FLAGS)
    spec = {"root": ROOT, "out": str(tmp),
            "machines": f"127.0.0.1:{_free_port()},127.0.0.1:{_free_port()}",
            "rounds": ROUNDS, "grid": GRID, "prepart": PREPART,
            # the uneven split: its rows sit at other padded positions
            # than in one process, so the stochastic rounding's row keys
            # move (nearest rounding has none), and the ranks' mean of
            # their label means is not the whole set's mean
            # (GlobalSyncUpByMean, lightgbm_tpu/models/gbdt.py:490-499)
            "prepart_params": {"uneven": {"tpu_quant_round": "nearest",
                                          "boost_from_average": False}},
            "ckpt_dir": str(tmp / "ckpt"), "ckpt_rounds": CKPT_ROUNDS,
            "cases": ["network", "grid", "prepart", "metric_sync",
                      "checkpoint", "failure"]}
    procs, logs = _start_workers(tmp, spec)
    try:
        port = {}
        for n in GRID:
            Xg, gb, gr = grid_data(n)
            y = gb if GRID[n]["objective"] == "binary" else gr
            port[n] = sharded_run(tlgb, Xg, y, {"params": _in_process(n),
                                                "rounds": ROUNDS,
                                                "cat": grid_cat(n)})
    finally:
        _wait_workers(procs, logs, timeout=600)
    ranks = [json.loads((tmp / f"rank{k}.json").read_text())
             for k in range(2)]
    jax = wait_jax()
    jgrid = {n: {"text": str(jax[f"{i}_text"]), "raw": jax[f"{i}_raw"]}
             for i, n in enumerate(GRID)}
    return {"ranks": ranks, "port": port, "jax": jgrid, "tmp": tmp,
            "spec": spec}


def test_workers_never_load_jax(runs):
    for r in runs["ranks"]:
        assert r["jax_loaded"] is False
        assert set(r["seconds"]) == set(runs["spec"]["cases"])


# -- (a) the grid, across processes -------------------------------------------
@pytest.mark.parametrize("name", [n for n in GRID if n != "data_hilo"])
def test_int_texts_equal_across_ranks_jax_and_in_process(runs, name):
    a, b = (r["grid"][name] for r in runs["ranks"])
    assert a["full"] == b["full"]
    assert a["bundled"] == ("efb" in name)
    assert a["local_shards"] == 2
    assert a["proc_collectives"] > 0 and a["proc_bytes"] > 0
    # the texts without their parameters blocks, which name the machine
    # list and the hosts knob
    assert a["text"] == runs["port"][name]["text"]
    assert a["text"] == runs["jax"][name]["text"]


def test_features_case_grows_every_round(runs):
    """The features once refused, together, still grow a tree of many
    leaves every round (a coupled penalty above the root's best gain
    among its per-node sample would stop training at one leaf)."""
    b = tlgb.Booster(model_str=runs["port"]["data_features_int8"]["text"],
                     params={"device_type": "cpu"})
    assert [t.num_leaves for t in b._driver.models] == [15] * ROUNDS


def test_hilo_across_ranks_and_packages(runs):
    a, b = (r["grid"]["data_hilo"] for r in runs["ranks"])
    assert a["full"] == b["full"]
    # the transport moves every bit and the shards sum in the members'
    # global order: the in-process run's text
    assert a["text"] == runs["port"]["data_hilo"]["text"]
    jt = tlgb.Booster(model_str=runs["jax"]["data_hilo"]["text"],
                      params={"device_type": "cpu"})
    mt = tlgb.Booster(model_str=a["text"], params={"device_type": "cpu"})
    assert_trees_match(jt._driver.models, mt._driver.models)


# -- (b) pre_partition ----------------------------------------------------------
def _jax_mappers(name, cut):
    """find_mappers_multihost on two hosts, rebuilt in one process from
    the JAX package's pure functions: each host's quota sample of its
    rows, concatenated in process order, its features' mappers found on
    that global sample, the payloads merged."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io import distributed_binning as jdb

    X, _, y = grid_data(name)
    cfg = JConfig(dict(INT8))
    quota = max(1, int(cfg.bin_construct_sample_cnt) // 2)
    parts = []
    for h in (X[:cut], X[cut:]):
        if len(h) > quota:
            rng = np.random.default_rng(int(cfg.data_random_seed))
            h = h[np.sort(rng.choice(len(h), quota, replace=False))]
        parts.append(h)
    sample = np.concatenate(parts)
    names = [f"Column_{i}" for i in range(X.shape[1])]
    assignment = jdb.assign_features(X.shape[1], 2)
    payloads = [jdb.local_payload(sample, assignment[k], cfg,
                                  total_rows=len(y), feature_names=names)
                for k in range(2)]
    return [m.to_dict() for m in jdb.merge_mapper_payloads(payloads,
                                                          X.shape[1])]


def _data_run_over(name, mappers, extra=()):
    """The port's in-process data run over the given mappers."""
    X, _, y = grid_data(name)
    p = dict(INT8, device_type="cpu", tree_learner="data", num_machines=4,
             tpu_topology_hosts=2, **dict(extra))
    ref = TrainingData()
    ref.mappers = [BinMapper.from_dict(d) for d in mappers]
    ref.used_feature_idx = [i for i, m in enumerate(ref.mappers)
                            if not m.is_trivial]
    ref.num_total_features = X.shape[1]
    ref.monotone_constraints = ref.feature_penalty = None
    ref.device = torch.device("cpu")
    holder = tlgb.Dataset(X[:2], label=y[:2], params=p)
    holder._inner = ref
    ds = tlgb.Dataset(X, label=y, params=p, reference=holder)
    return model_text(tlgb.train(p, ds, ROUNDS))


def _trees_and_mappers(text):
    """A text without its `tpu_feature_profile:` trailer, the profile of
    the training rows the process holds (each rank's own under
    pre_partition, in both packages)."""
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("tpu_feature_profile:"))


def _structure(text):
    keep = ("split_feature=", "threshold=", "left_child=", "right_child=",
            "leaf_count=", "internal_count=")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("name", list(PREPART))
def test_pre_partition_mappers_and_text(runs, name):
    a, b = (r["prepart"][name] for r in runs["ranks"])
    cut = PREPART[name]
    assert (a["rows"], b["rows"]) == (cut, 4096 - cut)
    assert a["partitioned"] and b["partitioned"]
    assert a["bundled"] == b["bundled"] == (name == "efb")
    assert _trees_and_mappers(a["text"]) == _trees_and_mappers(b["text"])
    assert a["mappers"] == b["mappers"] == _jax_mappers(name, cut)
    extra = runs["spec"]["prepart_params"].get(name, {})
    want = _data_run_over(name, a["mappers"], extra)
    if name != "uneven":
        assert _trees_and_mappers(a["text"]) == _trees_and_mappers(want)
    else:
        assert _structure(a["text"]) == _structure(want)


# -- (c) metric sync -------------------------------------------------------------
def test_partitioned_validation_metrics_agree(runs):
    a, b = (r["metric_sync"] for r in runs["ranks"])
    assert a == b, "ranks diverged on metrics or early stopping"
    assert 1 <= a["best_iter"] <= a["n_iter"] <= 12
    assert a["curve_ll"][-1] == pytest.approx(a["expected_ll"], abs=2e-4)
    assert a["curve_auc"][-1] == pytest.approx(a["expected_auc"], abs=2e-4)


# -- (d) set_network -> train -> free_network -----------------------------------
def test_set_network_trains_and_free_network_forgets(runs):
    a, b = (r["network"] for r in runs["ranks"])
    assert a["text"] == b["text"]
    assert a["freed"] and b["freed"]
    # the data learner at num_machines=4: the grid's data text
    assert a["text"] == runs["port"]["data_int8"]["text"]


def test_log_lines_carry_the_host_prefix_in_a_group(runs):
    # tests/test_telemetry.py:test_host_prefix_on_multiprocess of the JAX
    # package, on a live two-process group
    for k, r in enumerate(runs["ranks"]):
        assert r["network"]["log_line"] == (
            f"[host {k}] [LightGBM] [Warning] who said this\n")


def test_log_lines_have_no_prefix_in_one_process():
    from lightgbm_tpu_torch.utils import log as log_mod

    lines, level = [], log_mod.Log.get_level()
    log_mod.Log.reset_callback(lines.append)
    log_mod.Log.reset_level(log_mod.LOG_WARNING)
    try:
        log_mod.Log.warning("who said this")
    finally:
        log_mod.Log.reset_callback(None)
        log_mod.Log.reset_level(level)
    assert lines == ["[LightGBM] [Warning] who said this\n"]


# -- (e) the checkpoint group -------------------------------------------------------
def test_checkpoint_group_is_the_jax_packages(runs):
    """Two ranks commit a group that the JAX manager validates; resumed
    in one process at another shard count it gives the uninterrupted
    text."""
    from lightgbm_tpu.utils.checkpoint import CheckpointManager as JMgr

    root = runs["spec"]["ckpt_dir"]
    a, b = (r["checkpoint"] for r in runs["ranks"])
    assert a["text"] == b["text"]
    jm = JMgr(root, host_count=2, host_index=0)
    it, manifest = jm.load_latest_group()
    assert it == CKPT_ROUNDS and jm.validate_group(manifest)
    assert manifest["host_count"] == 2
    assert manifest["topology"]["data_shards"] == 4
    assert tckpt.CheckpointManager(root, host_count=2).load_latest_group() \
        == (it, manifest)
    X, _, y = problem()
    p = dict(INT8, device_type="cpu", tree_learner="data", num_machines=2,
             tpu_checkpoint_dir=root)
    resumed = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), ROUNDS,
                         resume=True)
    assert model_text(resumed) == runs["jax"]["data_int8"]["text"]


@pytest.mark.parametrize("p1,p2", [(2, 4), (4, 1)])
def test_elastic_resume_across_shard_counts(runs, tmp_path, p1, p2):
    """tests/test_collective.py::TestElasticResume: a checkpoint at P
    data shards resumes at P' to the uninterrupted text, the JAX
    package's."""
    X, _, y = problem()
    q = dict(INT8, device_type="cpu", tree_learner="data",
             tpu_checkpoint_dir=str(tmp_path))
    tlgb.train(dict(q, num_machines=p1),
               tlgb.Dataset(X, label=y, params=q), ROUNDS - 1)
    resumed = tlgb.train(dict(q, num_machines=p2),
                         tlgb.Dataset(X, label=y, params=q), ROUNDS,
                         resume=True)
    assert model_text(resumed) == runs["jax"]["data_int8"]["text"]


def _fake_barrier(entries):
    return lambda vec: [np.asarray(e, np.int64) for e in entries]


def _bundle(rows, host, hosts, it=3):
    state = {"iteration": it,
             "topology": {"rows": rows, "host_count": hosts,
                          "host_index": host, "partitioned": True}}
    return (f"model-{it}", state,
            {"train_scores": np.full((1, rows), float(host), np.float32)})


def _save_hosts(mgr_cls, root, it, payloads):
    out = []
    for k, (text, state, arrays) in enumerate(payloads):
        m = mgr_cls(str(root), host_index=k, host_count=len(payloads))
        m.save(it, text, state, arrays)
        out.append(m)
    return out


@pytest.mark.parametrize("case", ["commit", "torn_set", "torn_local",
                                  "retention", "partitioned_resume"])
def test_checkpoint_group_with_injected_barrier(tmp_path, case):
    """tests/test_collective.py::TestMultihostCheckpointGroup on the port's
    manager, each outcome held against the JAX manager's on its own
    copy."""
    from lightgbm_tpu.utils import checkpoint as jckpt

    outcomes = []
    for mod in (tckpt, jckpt):
        root = tmp_path / mod.__name__.split(".")[0]
        Mgr = mod.CheckpointManager
        if case == "commit":
            mgrs = _save_hosts(Mgr, root, 3, [_bundle(100, 0, 2),
                                              _bundle(80, 1, 2)])
            crc = [m.manifest_crc(m.host_bundle_path(k, 3))
                   for k, m in enumerate(mgrs)]
            with pytest.raises(ValueError, match="mixed-iteration"):
                mgrs[0].commit_global(3, barrier=_fake_barrier(
                    [[3, crc[0], 100], [2, crc[1], 80]]))
            path = mgrs[0].commit_global(3, barrier=_fake_barrier(
                [[3, crc[0], 100], [3, crc[1], 80]]))
            none = mgrs[1].commit_global(3, barrier=_fake_barrier(
                [[3, crc[1], 80], [3, crc[1], 80]]))
            with open(path) as f:
                manifest = json.load(f)
            outcomes.append((os.path.basename(path), none,
                             manifest["hosts"]))
        elif case == "torn_set":
            mgrs = _save_hosts(Mgr, root, 3, [_bundle(100, 0, 2),
                                              _bundle(80, 1, 2)])
            crc = [m.manifest_crc(m.host_bundle_path(k, 3))
                   for k, m in enumerate(mgrs)]
            mgrs[0].commit_global(3, barrier=_fake_barrier(
                [[3, crc[0], 100], [3, crc[1], 80]]))
            it, manifest = mgrs[0].load_latest_group()
            ok = mgrs[0].validate_group(manifest)
            with open(os.path.join(mgrs[1].host_bundle_path(1, 3),
                                   "arrays.npz"), "r+b") as f:
                f.truncate(8)
            outcomes.append((it, ok, mgrs[0].validate_group(manifest),
                             mgrs[0].load_latest_group()))
        elif case == "torn_local":
            m = Mgr(str(root), host_index=0, host_count=2)
            seen = []

            def barrier(vec):
                seen.append(np.asarray(vec).tolist())
                return [vec, np.asarray([9, 123, 80], np.int64)]

            with pytest.raises(ValueError, match="torn/missing"):
                m.commit_global(9, barrier=barrier)
            outcomes.append((seen, m.group_manifests()))
        elif case == "retention":
            m = Mgr(str(root), keep=2, host_index=0, host_count=1)
            for it in (1, 2, 3, 4):
                m.save(it, f"model-{it}", {"iteration": it},
                       {"train_scores": np.zeros((1, 4), np.float32)})
                crc = m.manifest_crc(m.host_bundle_path(0, it))
                m.commit_global(it, barrier=_fake_barrier([[it, crc, 4]]))
            outcomes.append([it for it, _ in m.group_manifests()])
        else:
            # a partitioned 2-host group written by this package, read
            # back by either manager: the same iteration and manifest
            mgrs = _save_hosts(Mgr, root, 3, [_bundle(60, 0, 2),
                                              _bundle(40, 1, 2)])
            crc = [m.manifest_crc(m.host_bundle_path(k, 3))
                   for k, m in enumerate(mgrs)]
            mgrs[0].commit_global(3, barrier=_fake_barrier(
                [[3, crc[0], 60], [3, crc[1], 40]]),
                topology={"partitioned": True, "host_count": 2})
            other = (jckpt if mod is tckpt else tckpt).CheckpointManager(
                str(root), host_count=2)
            it, manifest = other.load_latest_group()
            outcomes.append((it, manifest["hosts"],
                             other.validate_group(manifest)))
    assert outcomes[0] == outcomes[1]


# -- (f) failure ---------------------------------------------------------------------
def test_a_dropped_host_fails_its_peer_within_the_deadline(runs):
    r0, r1 = (r["failure"] for r in runs["ranks"])
    assert r1["raised"] == "HostDropped"
    assert r0["raised"] in ("HostDropped", "CollectiveTimeout"), r0
    assert r0["seconds"] < TIMEOUT_S


def test_unresolvable_rank_raises_the_jax_error(monkeypatch):
    from lightgbm_tpu.parallel import mesh as jmesh

    monkeypatch.delenv("LIGHTGBM_TPU_HOST_IP", raising=False)
    monkeypatch.delenv("LIGHTGBM_TPU_PROCESS_ID", raising=False)
    machines = "10.0.0.1:12400,10.0.0.2:12400"
    with pytest.raises(ValueError) as want:
        jmesh.init_multihost(machines, 12400, 2)
    with pytest.raises(ValueError) as got:
        mesh.init_multihost(machines, 12400, 2)
    assert str(got.value) == str(want.value)


# -- in-process units against the JAX functions ----------------------------------
@pytest.mark.parametrize("case", ["single_machine", "host_ip", "process_id"])
def test_multihost_mapping_with_a_stubbed_init(monkeypatch, case):
    """tests/test_multihost.py::TestMultihostMapping: the rank from the
    machine list, the rendezvous address, the world size."""
    if case == "single_machine":
        assert mesh.init_multihost("", 0, 1) is False
        assert mesh.init_multihost("127.0.0.1:12400", 12400, 1) is False
        return
    calls = {}

    def fake_init(**kw):
        calls.update(kw)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.delenv("LIGHTGBM_TPU_HOST_IP", raising=False)
    monkeypatch.delenv("LIGHTGBM_TPU_PROCESS_ID", raising=False)
    if case == "host_ip":
        monkeypatch.setenv("LIGHTGBM_TPU_HOST_IP", "10.0.0.2")
    else:
        monkeypatch.setenv("LIGHTGBM_TPU_PROCESS_ID", "2")
    assert mesh.init_multihost(
        "10.0.0.1:12400,10.0.0.2:12400,10.0.0.3:12400", 12400, 3)
    assert calls == {"backend": "gloo",
                     "init_method": "tcp://10.0.0.1:12400",
                     "world_size": 3,
                     "rank": 1 if case == "host_ip" else 2}


@pytest.mark.parametrize("case", ["assignment", "four_machines",
                                  "global_config", "double", "missing",
                                  "single_process"])
def test_distributed_binning_pure_functions(case):
    """tests/test_distributed_binning.py's cases, the port's functions
    held to the JAX package's."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io import distributed_binning as jdb
    from lightgbm_tpu_torch.config import Config

    if case == "assignment":
        for nf, nm in ((28, 4), (7, 3), (5, 8), (1, 1)):
            assert tdb.assign_features(nf, nm) == \
                jdb.assign_features(nf, nm)
        return
    rng = np.random.default_rng(7)
    if case in ("four_machines", "global_config"):
        n, nf, nm = (4000, 9, 4) if case == "four_machines" else (2000, 8, 2)
        X = rng.normal(size=(n, nf))
        params = {"max_bin": 32}
        cat = []
        if case == "global_config":
            X[:, 6] = rng.integers(0, 5, size=n)
            params.update(ignore_column="5", max_bin_by_feature=",".join(
                ["32"] * 7 + ["8"]))
            cat = [6]
        shards = np.array_split(X, nm)
        asg = tdb.assign_features(nf, nm)
        got = [tdb.local_payload(shards[m], asg[m], Config(params),
                                 categorical=cat, total_rows=n)
               for m in range(nm)]
        want = [jdb.local_payload(shards[m], asg[m], JConfig(params),
                                  categorical=cat, total_rows=n)
                for m in range(nm)]
        assert [json.loads(g) for g in got] == [json.loads(w) for w in want]
        assert [m.to_dict() for m in tdb.merge_mapper_payloads(got, nf)] \
            == [m.to_dict() for m in jdb.merge_mapper_payloads(want, nf)]
        return
    X = rng.normal(size=(500, 3))
    if case == "single_process":
        got = tdb.find_mappers_multihost(X, Config({"max_bin": 16}))
        want = jdb.find_mappers_multihost(X, JConfig({"max_bin": 16}))
        assert [m.to_dict() for m in got] == [m.to_dict() for m in want]
        return
    p = tdb.local_payload(X, [0, 1], Config({"max_bin": 16}))
    for fn in (tdb.merge_mapper_payloads, jdb.merge_mapper_payloads):
        with pytest.raises(ValueError,
                           match="two machines" if case == "double"
                           else "missing"):
            fn([p, p] if case == "double" else [p], 2 if case == "double"
               else 3)


@pytest.fixture
def _clean_faults():
    faultline.reset()
    collective.configure(timeout_s=0.0, retries=1, backoff_s=0.0)
    yield
    faultline.reset()
    collective.configure(timeout_s=0.0, retries=1, backoff_s=0.25)


@pytest.mark.parametrize("case", ["identities", "fault_points",
                                  "host_drop", "transport_bits"])
def test_metric_sync_in_one_process(case, _clean_faults):
    """tests/test_metric_sync.py's one-process identities and fault
    points, the port's against the JAX package's; and the byte gather's
    bits for every dtype."""
    from lightgbm_tpu.parallel import metric_sync as jsync
    from lightgbm_tpu.utils import faultline as jfault

    if case == "identities":
        for mod in (metric_sync, jsync):
            assert mod.process_count() == 1
            assert np.array_equal(mod.sync_sums([1.5, 2.0]), [1.5, 2.0])
            (a,) = mod.sync_concat(np.array([3.0, 1.0]))
            assert np.array_equal(a, [3.0, 1.0])
        assert topology.rows_partitioned() is False
        assert mesh.local_row_offset(77) == (0, 77)
    elif case == "fault_points":
        hits = []
        for mod, fl in ((metric_sync, faultline), (jsync, jfault)):
            fl.reset()
            fl.arm("collective_sync", action="raise", times=1)
            assert np.array_equal(mod.sync_sums([3.0]), [3.0])
            hits.append(fl.hits("collective_sync"))
            fl.reset()
        assert hits == [2, 2]
    elif case == "host_drop":
        for mod, fl in ((metric_sync, faultline), (jsync, jfault)):
            fl.reset()
            fl.arm("host_drop", action="raise", times=5)
            with pytest.raises(Exception) as ei:
                mod.sync_concat(np.ones(2))
            assert type(ei.value).__name__ == "HostDropped"
            fl.reset()
        faultline.reset()
        faultline.arm("collective_sync", action="hang")
        with pytest.raises(CollectiveTimeout):
            metric_sync.sync_sums([1.0])
    else:
        # the byte gather is exact for every dtype: a world of two whose
        # peer sends this process's bytes back
        def echo(buf, name):
            return [buf, buf.clone()]

        monkey = pytest.MonkeyPatch()
        monkey.setattr(topology, "_gather_bytes", echo)
        try:
            for dt in (np.float64, np.int64, np.float32, np.int8, np.bool_,
                       np.uint16):
                a = (np.arange(-3, 9).reshape(3, 4) * 1.37).astype(dt)
                g = topology._bitsafe_gather(a)
                assert g.dtype == a.dtype and g.shape == (2, 3, 4)
                assert g.tobytes() == a.tobytes() * 2
        finally:
            monkey.undo()
        assert issubclass(HostDropped, faultline.FaultInjected)
