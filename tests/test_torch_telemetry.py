"""Telemetry of lightgbm_tpu_torch against lightgbm_tpu: the span tracer
and its exporters, the registry under tpu_telemetry=metrics, the phase
timer and the device-memory gauges.

The training cases run one script in both packages
(tests/test_torch_util.py:telemetry_run), the JAX package's in one
process compiled without FMA and with eight virtual devices (job
"telemetry", started before the port's runs).  Integer histograms and
regression, so the model texts are byte-identical too.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import flightrecorder, resources
from lightgbm_tpu_torch.obs.metrics import MetricsRegistry
from lightgbm_tpu_torch.utils import faultline, membudget, timer
from lightgbm_tpu_torch.utils.compile_ledger import CompileLedger

from .test_torch_util import (SHARDED_FLAGS, model_text, start_jax_nofma,
                              telemetry_run)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device_type": "cpu", "verbosity": -1}
INT8 = {"objective": "regression", "num_leaves": 7, "max_bin": 31,
        "min_data_in_leaf": 5, "tpu_hist_precision": "int8",
        "tpu_hist_impl": "xla", "tpu_quant_refit_leaves": False}
SHARDS, SHARDED_ROUNDS = 2, 3
RUNS = [
    {"name": "trace", "kind": "trace", "params": INT8},
    {"name": "events", "kind": "events", "params": INT8, "rounds": 4,
     "poison_at": 2},
    {"name": "metrics", "kind": "metrics", "params": INT8},
    {"name": "sharded", "kind": "trace", "rounds": SHARDED_ROUNDS,
     "valid": False,
     "params": dict(INT8, tree_learner="data", num_machines=SHARDS)},
]
# the spans whose counts a traced run must share with the JAX package's
COUNTED = ("train/round", "train/iteration", "train_dispatch",
           "tree_materialize", "metric_eval", "sketch", "binning")


def _problem(n=800, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    return X, y


@pytest.fixture(autouse=True)
def _telemetry_off():
    """Every test leaves the process-global policy off, the trace
    directory unset and the span buffer empty: the other test modules
    of the process keep the off-mode path."""
    yield
    obs.configure(mode="off", trace_dir="")
    obs.flush()
    obs.reset_events()
    faultline.set_host_index(None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's results, the JAX package's, the run directory)."""
    tmp = tmp_path_factory.mktemp("telemetry")
    X, y = _problem()
    Xv, yv = _problem(n=200, seed=1)
    inp = {"X": X, "y": y, "Xv": Xv, "yv": yv}
    wait_jax = start_jax_nofma("telemetry", inp,
                               {"runs": RUNS, "tmp": str(tmp)}, tmp,
                               xla_flags=SHARDED_FLAGS)
    try:
        port = [telemetry_run(tlgb, inp, run, str(tmp)) for run in RUNS]
    finally:
        jax = wait_jax()
    jax = [{k: str(jax[f"{i}_{k}"]) for k in port[i]}
           for i in range(len(RUNS))]
    return {"port": port, "jax": jax, "tmp": tmp}


def _case(runs, name):
    i = next(i for i, r in enumerate(RUNS) if r["name"] == name)
    return runs["port"][i], runs["jax"][i]


# -- the span vocabulary --------------------------------------------------
def test_span_names_parents_and_counts_equal_the_jax_packages(runs):
    port, jax = (json.loads(r["spans"]) for r in _case(runs, "trace"))
    assert port["parents"] == jax["parents"]
    assert port["counts"] == jax["counts"]
    for name in COUNTED:
        assert port["counts"][name] > 0, name
    assert port["counts"]["train/round"] == 10


def test_iteration_tags_equal_the_jax_packages(runs):
    port, jax = (json.loads(r["spans"]) for r in _case(runs, "trace"))
    assert port["iterations"] == jax["iterations"]
    assert [it for n, it in port["iterations"]
            if n == "train/round"] == list(range(10))


def test_chrome_events_and_jsonl_lines_carry_the_jax_keys(runs):
    port, jax = _case(runs, "trace")
    assert port["chrome"] == jax["chrome"]
    assert port["jsonl"] == jax["jsonl"]
    phases = {json.loads(s)[0] for s in json.loads(port["chrome"])}
    assert phases == {"M", "X"}


def test_trace_covers_the_train_wall_and_loads(runs):
    # tests/test_telemetry.py:210-235 of the JAX package, on the port's
    # trace of the "trace" run
    with open(runs["tmp"] / "trace_port" / "trace-host0.json") as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    rounds = [e for e in spans if e["name"] == "train/round"]
    assert sorted(e["args"]["iteration"] for e in rounds) == list(range(10))
    loop_wall = (max(e["ts"] + e["dur"] for e in rounds)
                 - min(e["ts"] for e in rounds))
    assert sum(e["dur"] for e in rounds) >= 0.95 * loop_wall
    with open(runs["tmp"] / "trace_port" / "events-host0.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert {e["name"] for e in lines} == {e["name"] for e in spans}


def test_lifecycle_event_names_equal_the_jax_packages(runs):
    port, jax = _case(runs, "events")
    assert port["events"] == jax["events"]
    saved, resumed, guard = json.loads(port["events"])
    assert "checkpoint_saved" in saved
    assert "checkpoint_restored" in resumed
    assert "guard_poisoned" in guard


def test_registry_families_and_phase_runs_equal_the_jax_packages(runs):
    port, jax = _case(runs, "metrics")
    assert port["families"] == jax["families"]
    assert port["runs"] == jax["runs"]
    runs_by_phase = json.loads(port["runs"])
    assert runs_by_phase["train_dispatch"] == 10
    assert runs_by_phase["sketch"] == runs_by_phase["binning"] == 2


@pytest.mark.parametrize("name", ["trace", "metrics", "sharded"])
def test_int8_text_with_telemetry_equals_the_jax_packages(runs, name):
    port, jax = _case(runs, name)
    assert port["text"] == jax["text"]


def test_sharded_spans_name_the_shard_factor(runs):
    """The JAX package runs its shards inside one program; the port runs
    a thread a shard, each with a `shard/grow` span under the step and
    an `exchange/<collective>` span a collective under it: SHARDS spans
    a tree where the JAX package records none."""
    port, jax = (json.loads(r["spans"]) for r in _case(runs, "sharded"))
    for name, count in jax["counts"].items():
        assert port["counts"][name] == count, name
        assert port["parents"][name] == jax["parents"][name], name
    extra = set(port["counts"]) - set(jax["counts"])
    assert "shard/grow" in extra
    assert port["counts"]["shard/grow"] == SHARDS * SHARDED_ROUNDS
    assert port["parents"]["shard/grow"] == ["train_dispatch"]
    for name in extra - {"shard/grow"}:
        assert name.startswith("exchange/"), name
        assert port["parents"][name] == ["shard/grow"]
        assert port["counts"][name] % SHARDS == 0


# -- tracing on and off ----------------------------------------------------
def test_model_text_trace_equals_off_bagged_int16(tmp_path):
    # tests/test_telemetry.py:237-257 of the JAX package
    X, y = _problem(n=600)
    q = dict(CPU, objective="binary", num_leaves=15, max_bin=31,
             min_data_in_leaf=5, bagging_fraction=0.8, bagging_freq=1,
             tpu_hist_precision="int16")
    yb = (y > 0).astype(np.float64)

    def train_text():
        ds = tlgb.Dataset(X, label=yb, params=q)
        return model_text(tlgb.train(q, ds, num_boost_round=4,
                                     keep_training_booster=True))

    obs.configure(mode="off", trace_dir="")
    off = train_text()
    obs.configure(mode="trace", trace_dir=str(tmp_path))
    traced = train_text()
    assert obs.events()
    assert off == traced


def test_invalid_mode_raises_the_jax_value_error():
    from lightgbm_tpu import obs as jobs

    with pytest.raises(ValueError) as want:
        jobs.configure(mode="loud")
    with pytest.raises(ValueError) as got:
        obs.configure(mode="loud")
    assert str(got.value) == str(want.value)
    assert obs.mode() == "off"


def test_shard_threads_have_their_own_stacks_and_tids():
    X, y = _problem(n=400)
    p = dict(CPU, **INT8, tree_learner="data", num_machines=SHARDS,
             tpu_telemetry="trace")
    obs.reset_events()
    tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 2)
    spans = [e for e in obs.events() if e["kind"] == "span"]
    main = {e["tid"] for e in spans if e["name"] == "train_dispatch"}
    shard = [e for e in spans if e["name"] == "shard/grow"]
    assert len(shard) == 2 * SHARDS
    assert len({e["tid"] for e in shard}) >= SHARDS
    assert not main & {e["tid"] for e in shard}
    steps = [e for e in spans if e["name"] == "train_dispatch"]
    for s in shard:
        # inside a step of the calling thread, one level below it
        assert any(t["ts"] <= s["ts"] and s["ts"] + s["dur"]
                   <= t["ts"] + t["dur"] for t in steps)
        assert s["tags"]["depth"] == steps[0]["tags"]["depth"] + 1
    for e in spans:
        if e["name"].startswith("exchange/"):
            assert any(s["tid"] == e["tid"] and s["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
                       for s in shard)


# -- exporters --------------------------------------------------------------
def test_two_hosts_streams_merge_with_the_jax_tool(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import trace_merge
    finally:
        sys.path.pop(0)
    obs.configure(mode="trace", trace_dir=str(tmp_path))
    for host in (0, 1):
        faultline.set_host_index(host)
        for i in range(3):
            with obs.span("train/round", iteration=i):
                with obs.span("train/iteration", iteration=i):
                    pass
        obs.event("checkpoint_saved", iteration=2)
    obs.flush()
    trace, counts, skipped = trace_merge.merge(str(tmp_path))
    assert counts == {0: 7, 1: 7}
    assert skipped == 0
    evs = trace["traceEvents"]
    assert {e["pid"] for e in evs if e["ph"] == "X"} == {0, 1}
    assert sum(e["name"] == "train/iteration" for e in evs) == 6
    out = trace_merge.main([str(tmp_path)])
    with open(out) as f:
        assert json.load(f)["traceEvents"]


def test_blackbox_lands_under_the_trace_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_BLACKBOX_DIR", raising=False)
    flightrecorder.configure(dump_dir="")
    X, y = _problem(n=300)
    p = dict(CPU, **INT8, tpu_telemetry="trace",
             tpu_trace_dir=str(tmp_path))
    faultline.reset()
    faultline.arm("grow_step", action="raise", at=3)
    try:
        with pytest.raises(faultline.FaultInjected):
            tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 5)
    finally:
        faultline.reset()
    dump = json.loads((tmp_path / "blackbox-host0.json").read_text())
    assert dump["reason"].startswith("train_interrupt")
    # the traced spans mirrored into the ring
    assert any(e["kind"] == "span" and e["name"] == "train/round"
               for e in dump["entries"])
    # and the trace of the failed run was written
    assert (tmp_path / "trace-host0.json").exists()


def test_timer_trace_writes_a_profile_with_the_spans(tmp_path):
    X, y = _problem(n=300)
    p = dict(CPU, **INT8, tpu_telemetry="trace")
    b = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y, params=p))
    b.update()
    with timer.trace(str(tmp_path)):
        b.update()
    with open(tmp_path / "torch-trace-host0.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train/iteration", "train_dispatch"} <= names


def test_env_arms_the_port_in_a_fresh_process(tmp_path):
    """LIGHTGBM_TPU_TELEMETRY / LIGHTGBM_TPU_TRACE_DIR, the names the JAX
    package reads, arm the port at import; a traced CPU run makes no
    CUDA context and loads no JAX."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "import torch\n"
        "import lightgbm_tpu_torch as lgb\n"
        "from lightgbm_tpu_torch import obs\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(300, 4)); y = X[:, 0]\n"
        "p = {'objective': 'regression', 'num_leaves': 7, 'max_bin': 15,\n"
        "     'verbosity': -1, 'device_type': 'cpu'}\n"
        "lgb.train(p, lgb.Dataset(X, label=y), 2)\n"
        "print(json.dumps({'mode': obs.mode(), 'dir': obs.trace_dir(),\n"
        "  'cuda': torch.cuda.is_initialized(),\n"
        "  'jax': any(m.split('.')[0] in ('jax', 'lightgbm_tpu')\n"
        "             for m in sys.modules)}))\n")
    env = dict(os.environ, LIGHTGBM_TPU_TELEMETRY="trace",
               LIGHTGBM_TPU_TRACE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"mode": "trace", "dir": str(tmp_path), "cuda": False,
                   "jax": False}
    with open(tmp_path / "trace-host0.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"train/round", "train/iteration", "sketch"} <= names


# -- resources on the CPU ---------------------------------------------------
def test_resources_report_none_on_the_cpu_as_the_jax_package_does():
    from lightgbm_tpu.obs import resources as jres

    for fn in ("device_memory_stats", "hbm_bytes_in_use", "peak_hbm_bytes"):
        assert getattr(resources, fn)() is None
        assert getattr(jres, fn)() is None
    assert resources.all_device_memory_stats() == []
    obs.configure(mode="metrics")
    ran = []
    with resources.phase_peak("hist_build"):
        ran.append(1)
    assert ran == [1]
    assert resources.phase_peaks() == {} == jres.phase_peaks()
    out = resources.bench_resource_metrics(ledger=CompileLedger())
    assert out == {"train_peak_hbm_bytes": None,
                   "phase_peak_hbm_bytes": None, "program_costs": None}
    snap = membudget.memory_snapshot()
    assert snap == {"hbm_bytes_in_use": None, "hbm_peak_bytes": None,
                    "hbm_capacity_bytes": None}


def test_phase_peak_is_the_null_context_when_off():
    assert obs.mode() == "off"
    assert resources.phase_peak("predict") is resources.phase_peak("ingest")
    assert obs.span("x") is obs.span("y")


def test_watermark_bookkeeping():
    # tests/test_resources.py:84-98 of the JAX package
    resources.reset_phase_peaks()
    try:
        resources._note_phase_peak("hist_build", 100)
        resources._note_phase_peak("hist_build", 50)   # not a new peak
        resources._note_phase_peak("ingest", 70)
        assert resources.phase_peaks() == {"hist_build": 100, "ingest": 70}
        assert obs.REGISTRY.value("lgbm_device_phase_peak_bytes",
                                  phase="hist_build") == 100
    finally:
        resources.reset_phase_peaks()
    assert resources.phase_peaks() == {}


class _FakeCuda:
    """torch.cuda as the caching allocator reports it, one card a dict
    of memory_stats; `reads` counts the reads."""

    def __init__(self, cards, total=80 << 30):
        self.cards, self.total, self.reads = cards, total, 0

    def device_count(self):
        return len(self.cards)

    def memory_stats(self, d):
        self.reads += 1
        return dict(self.cards[d])

    def get_device_properties(self, d):
        return type("Props", (), {"total_memory": self.total})()


def _stats(current, peak):
    return {"allocated_bytes.all.current": current,
            "allocated_bytes.all.peak": peak,
            "reserved_bytes.all.current": 2 * current,
            "reserved_bytes.all.peak": 2 * peak}


def test_device_stats_map_the_allocator_onto_the_jax_keys(monkeypatch):
    fake = _FakeCuda([_stats(10, 30), _stats(20, 25)], total=1000)
    monkeypatch.setattr(resources, "_cuda", lambda: fake)
    assert resources.device_memory_stats(1) == {
        "bytes_in_use": 20, "peak_bytes_in_use": 25, "bytes_reserved": 40,
        "peak_bytes_reserved": 50, "bytes_limit": 1000}
    assert resources.device_memory_stats()["bytes_in_use"] == 10
    assert resources.hbm_bytes_in_use() == 20
    assert resources.peak_hbm_bytes() == 30
    assert membudget.memory_snapshot() == {
        "hbm_bytes_in_use": 20, "hbm_peak_bytes": 30,
        "hbm_capacity_bytes": 1000}


@pytest.mark.parametrize("after,want", [
    # the process peak grew inside the bracket: the phase owns it
    ([_stats(40, 90), _stats(20, 25)], 90),
    # it did not: the phase is bounded by the live bytes it saw
    ([_stats(40, 30), _stats(20, 25)], 40),
])
def test_phase_peak_reset_and_read_emulation(monkeypatch, after, want):
    fake = _FakeCuda([_stats(10, 30), _stats(20, 25)])
    monkeypatch.setattr(resources, "_cuda", lambda: fake)
    obs.configure(mode="metrics")
    resources.reset_phase_peaks()
    try:
        with resources.phase_peak("hist_build"):
            fake.cards = after
        assert resources.phase_peaks() == {"hist_build": want}
        assert obs.REGISTRY.value("lgbm_device_phase_peak_bytes",
                                  phase="hist_build") == want
    finally:
        resources.reset_phase_peaks()


def test_bench_metrics_carry_the_build_ledger():
    ledger = CompileLedger()
    ledger.record_build(1.5, True, "abc")
    ledger.record("hist_batched", "hist_batched[1, 2]", 0.01, 4096)
    costs = resources.bench_resource_metrics(ledger=ledger)["program_costs"]
    assert costs["builds"][0]["hash"] == "abc"
    assert costs["plans"] == [{"site": "hist_batched",
                               "signature": "hist_batched[1, 2]",
                               "first_call_s": 0.01,
                               "argument_bytes": 4096}]


def test_process_stats_and_their_prometheus_text():
    st = resources.process_runtime_stats()
    assert st["process_rss_bytes"] > 1 << 20
    assert st["process_uptime_s"] > 0
    assert st["process_threads"] >= 1
    assert st["process_open_fds"] >= 3
    assert st["process_gc_collections"] >= 0
    reg = MetricsRegistry()
    resources.publish_process_gauges(reg)
    text = reg.to_prometheus_text()
    for family in ("lgbm_process_resident_memory_bytes",
                   "lgbm_process_uptime_seconds", "lgbm_process_threads",
                   "lgbm_process_open_fds", "lgbm_process_gc_collections"):
        assert f"# TYPE {family} gauge" in text


# -- the phase timer ----------------------------------------------------------
def test_phase_timer_counts_and_summary():
    timer.reset()
    obs.configure(mode="metrics")
    with timer.PHASE("unit_phase"):
        time.sleep(0.002)
    timer.add("unit_phase", 0.5)
    assert timer.counts()["unit_phase"] == 2
    assert timer.summary()["unit_phase"] >= 0.502
    text = obs.REGISTRY.to_prometheus_text()
    assert 'lgbm_phase_seconds_total{phase="unit_phase"}' in text
    timer.reset()
    assert "unit_phase" not in timer.counts()


# -- the off mode's cost -----------------------------------------------------
def test_off_mode_sites_cost_under_1pct_of_an_iteration():
    """The deterministic half of tests/test_telemetry.py:383-421: the
    gated sites an iteration passes cost under 1% of a port iteration
    (min of 5 windows against a container stall)."""
    assert obs.mode() == "off"
    reps = 5000
    per_call = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for i in range(reps):
            with obs.span("train/round", iteration=i):
                with obs.span("train/iteration", iteration=i):
                    with timer.PHASE("train_dispatch"):
                        with resources.phase_peak("hist_build"):
                            pass
            flightrecorder.note("round", "train/round", iteration=i)
        per_call = min(per_call, (time.perf_counter() - t0) / reps)
    X, y = _problem()
    p = dict(CPU, **INT8)
    b = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y))
    b.update()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        b.update()
        walls.append(time.perf_counter() - t0)
    per_iter = min(walls)
    assert per_call < 0.01 * per_iter, (
        f"gated telemetry sites cost {per_call * 1e6:.2f}us an iteration "
        f"against {per_iter * 1e3:.2f}ms iterations")


def test_concurrent_spans_keep_per_thread_stacks():
    obs.configure(mode="trace")
    obs.reset_events()
    barrier = threading.Barrier(4)

    def work(k):
        barrier.wait()
        for i in range(20):
            with obs.span("outer", k=k):
                with obs.span("inner", k=k, i=i):
                    pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    inner = [e for e in obs.events() if e["name"] == "inner"]
    assert len(inner) == 80
    assert all(e["tags"]["parent"] == "outer" and e["tags"]["depth"] == 1
               for e in inner)
