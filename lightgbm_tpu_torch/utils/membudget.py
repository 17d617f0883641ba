"""Device-memory budgeting on the card: OOM classification, the budget,
the preflight plan and the degradation ladder of a training run.

The port of the training half of `lightgbm_tpu/utils/membudget.py`:

* **classification** — `is_oom_error` recognizes exactly three shapes:
  `torch.OutOfMemoryError` (CUDA's caching allocator), a `RuntimeError`
  carrying the allocator's or the CUDA runtime's out-of-memory text,
  and the port's own launch errors (`ops/kernels.py:check`,
  ``"CUDA error 2 (out of memory)"``).  Nothing else classifies: a
  sticky CUDA error such as 700 (illegal address) loses the context,
  and no retry can help, so it propagates as itself.  `oom_guard(site)`
  re-raises a classified error as a `DeviceOutOfMemory` naming the
  site, counted (``lgbm_oom_events_total{site=}``) and noted in the
  flight recorder with the card's memory numbers; it also hosts the
  ``device_alloc`` fault point, whose ``oom`` action raises a
  `torch.OutOfMemoryError` shaped like the allocator's.
* **budget** — `budget_bytes(config)`: ``tpu_hbm_budget_bytes`` when
  set, else the card's capacity (`torch.cuda.mem_get_info`) times
  ``tpu_hbm_budget_frac``; None on the CPU, where no number is
  invented.
* **preflight plan** — `plan_training` itemizes the port's own
  buffers: the learner's [G, n] bins and the kernels' row-major copy,
  the grower's [L + 1, G, B, 3] pool and stat planes, the per-call
  scratch of B1/B2/B4, the score buffers (the one the rollback
  snapshot holds and the iteration's new one), the row masks, the packed forest,
  and the ingest and predict chunks.  `live_bytes` reads the same
  components off the live tensors, which is what the plan is held to.
* **degradation ladder** — `DegradationLadder`, the JAX package's rungs
  in its order: halve ``tpu_ingest_chunk_rows``/
  ``tpu_predict_chunk_rows`` (floor 4096), ``tpu_hist_agg=scatter``
  (only on a multi-machine run, which the port refuses),
  ``fused_unfuse`` (``tpu_hist_impl=fused`` -> ``pallas2``: int8/int16
  leave kernel B2 for B1-int and the torch split search), then
  ``tpu_bucket_policy=fine``.  Each leaves the model's bytes as they
  are.  The JAX package's last rung, ``stream_layout``, trades the
  resident bins for the streamed layout, which the port has not got
  (ROADMAP A8): where it would be taken, the port ends in
  `MemoryLadderExhausted` and says so.

The serving budget and the registry's pressure of the JAX module are
not ported (ROADMAP A12); neither is its compile-ledger cross-check
(A10b).
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, List, Optional, Tuple

from . import faultline

#: the guarded device sites of the port (the JAX package's training
#: sites; its registry and serving sites wait on ROADMAP A12)
OOM_SITES = ("train_step", "ingest_chunk", "predict_chunk",
             "score_replay")

#: chunk shrinking never goes below this many rows
CHUNK_FLOOR = 4096

#: the JAX package's rung vocabulary, in descent order
LADDER_STEPS = ("shrink_chunk_rows", "hist_agg_scatter", "fused_unfuse",
                "bucket_policy_fine", "stream_layout")

#: rungs of the JAX ladder that the port cannot take yet
UNPORTED_STEPS = {"stream_layout": "ROADMAP A8, the streamed layout"}

#: what CUDA's allocator and runtime say when memory runs out: torch's
#: caching allocator ("CUDA out of memory. Tried to allocate ..."), a
#: CUDA runtime check ("CUDA error: out of memory"), and the port's own
#: launch errors (ops/kernels.py:check, "CUDA error 2 (out of memory)")
_OOM_RE = re.compile(r"CUDA out of memory|CUDA error: out of memory|"
                     r"CUDA error 2 \(out of memory\)")


class DeviceOutOfMemory(RuntimeError):
    """A device allocation failure, classified and named.

    Carries the guarded `site` it surfaced at plus any diagnostics the
    site attached; `__cause__` is the raw error."""

    def __init__(self, message: str, site: str = "unknown",
                 info: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.site = str(site)
        self.info = dict(info or {})


class MemoryLadderExhausted(DeviceOutOfMemory):
    """The degradation ladder ran out of rungs the port can take.

    Raised after the failed iteration was rolled back, so the booster
    stays usable; `engine.train` flushes a final checkpoint and the
    flight recorder dumps the blackbox on the way out."""


def is_oom_error(exc: BaseException) -> bool:
    """Is `exc` a device out-of-memory?  Already-classified errors pass;
    `torch.OutOfMemoryError` is one; otherwise only a RuntimeError whose
    text is one of CUDA's out-of-memory shapes.  The plain faultline
    ``raise`` action never classifies."""
    import torch

    if isinstance(exc, DeviceOutOfMemory):
        return True
    if isinstance(exc, faultline.FaultInjected):
        return False
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    return bool(_OOM_RE.search(str(exc)))


def memory_snapshot() -> Dict[str, Optional[int]]:
    """The card's memory numbers for diagnostics (None on the CPU)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {"hbm_bytes_in_use": None, "hbm_peak_bytes": None,
                "hbm_capacity_bytes": None}
    return {"hbm_bytes_in_use": int(torch.cuda.memory_allocated()),
            "hbm_peak_bytes": int(torch.cuda.max_memory_allocated()),
            "hbm_capacity_bytes": device_capacity_bytes("cuda")}


def note_oom(site: str, exc: Optional[BaseException] = None,
             **info) -> None:
    """Record one classified OOM: counter + flight-recorder entry with
    the memory snapshot."""
    from ..obs import REGISTRY, flightrecorder

    REGISTRY.inc("lgbm_oom_events_total", site=str(site),
                 help="classified device out-of-memory errors per "
                      "guarded site")
    snap = {k: v for k, v in memory_snapshot().items() if v is not None}
    flightrecorder.note("oom", "device_oom", site=str(site),
                        error=(str(exc)[:160] if exc is not None else None),
                        **snap, **{k: str(v) for k, v in info.items()})


@contextlib.contextmanager
def oom_guard(site: str, **info):
    """Guard one device site: hosts the ``device_alloc`` fault point and
    re-raises a classified allocation failure as a `DeviceOutOfMemory`
    naming the site.  Other errors pass through untouched."""
    try:
        faultline.fire("device_alloc", site=site, **info)
        yield
    except DeviceOutOfMemory:
        raise  # already classified at an inner site: keep its name
    except Exception as exc:
        if not is_oom_error(exc):
            raise
        note_oom(site, exc, **info)
        raise DeviceOutOfMemory(
            f"device out of memory at {site!r}: {str(exc)[:200]}",
            site=site, info=info) from exc


# ---------------------------------------------------------------------------
# budget
# ---------------------------------------------------------------------------
_capacity_memo: Dict[int, int] = {}


def _config_device(config):
    from ..config import resolve_device

    try:
        return resolve_device(config)
    except RuntimeError:
        return None


def device_capacity_bytes(device) -> Optional[int]:
    """Total memory of the CUDA device `device` (a torch.device or a
    string), from `torch.cuda.mem_get_info`; None for the CPU."""
    import torch

    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _capacity_memo:
        _capacity_memo[index] = int(torch.cuda.mem_get_info(index)[1])
    return _capacity_memo[index]


def budget_bytes(config) -> Optional[int]:
    """The enforced training budget: ``tpu_hbm_budget_bytes`` when set
    (on any device, so the whole surface is testable on the CPU), else
    the card's capacity times ``tpu_hbm_budget_frac``; None when neither
    resolves."""
    explicit = int(config.get("tpu_hbm_budget_bytes", 0) or 0)
    if explicit > 0:
        return explicit
    cap = device_capacity_bytes(_config_device(config))
    if cap is None:
        return None
    frac = float(config.get("tpu_hbm_budget_frac", 0.9) or 0.9)
    return int(cap * max(min(frac, 1.0), 0.01))


def publish_budget_gauge(budget: Optional[int], scope: str) -> None:
    """`lgbm_hbm_budget_bytes{scope=}`; nothing when no budget resolves."""
    if budget is None:
        return
    from ..obs import REGISTRY

    REGISTRY.set_gauge("lgbm_hbm_budget_bytes", int(budget),
                       help="enforced device-memory budget "
                            "(tpu_hbm_budget_*)",
                       scope=str(scope))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
class MemoryPlan:
    """An itemized prediction of device bytes against a budget: `fits`
    is True/False against a resolved budget, None without one."""

    def __init__(self, components: Dict[str, int],
                 budget: Optional[int], scope: str):
        self.components = {k: int(v) for k, v in components.items()}
        self.budget = None if budget is None else int(budget)
        self.scope = str(scope)

    @property
    def total(self) -> int:
        return sum(self.components.values())

    @property
    def headroom(self) -> Optional[int]:
        return None if self.budget is None else self.budget - self.total

    @property
    def fits(self) -> Optional[bool]:
        return None if self.budget is None else self.total <= self.budget

    def format_table(self) -> str:
        width = max([len(k) for k in self.components] + [10])
        lines = [f"{'component':<{width}s} {'bytes':>14s}"]
        for name, b in sorted(self.components.items(),
                              key=lambda kv: -kv[1]):
            lines.append(f"{name:<{width}s} {b:>14,d}")
        lines.append(f"{'TOTAL':<{width}s} {self.total:>14,d}")
        if self.budget is not None:
            lines.append(f"{'budget':<{width}s} {self.budget:>14,d}")
            lines.append(f"{'headroom':<{width}s} {self.headroom:>14,d}")
        return "\n".join(lines)

    def refuse_message(self, what: str) -> str:
        return (f"{what} needs a predicted {self.total:,d} device bytes "
                f"against a {self.budget:,d}-byte {self.scope} HBM "
                f"budget (headroom {self.headroom:,d}); itemized plan:\n"
                f"{self.format_table()}")

    def to_dict(self) -> Dict:
        return {"components": dict(self.components), "total": self.total,
                "budget": self.budget, "headroom": self.headroom,
                "fits": self.fits, "scope": self.scope}


def unique_nbytes(*tensors) -> int:
    """Bytes of the distinct storages behind `tensors` (None skipped):
    views of one buffer count once."""
    seen, total = set(), 0
    for t in tensors:
        if t is None:
            continue
        storage = t.untyped_storage()
        if storage.data_ptr() in seen:
            continue
        seen.add(storage.data_ptr())
        total += int(storage.nbytes())
    return total


def packed_forest_bytes(num_trees: int, num_leaves: int,
                        cat_words: int = 1) -> int:
    """Device bytes of `ops/predict.py:device_tables` over `pack_trees`'s
    tables: one int64 buffer of the seven node columns of width L - 1,
    the init-node column, the bitset pool's words and the [T, L] leaf
    values' bits, and the leaf values' f32 copy."""
    T = max(int(num_trees), 0)
    L = max(int(num_leaves), 2)
    words = T * (7 * (L - 1) + 1 + L) + max(int(cat_words), 1)
    return 8 * words + 4 * T * L


def forest_live_bytes(tables) -> Tuple[int, int]:
    """(device bytes, the same from packed_forest_bytes at the tables'
    own shape) of a forest's device tables."""
    T, L = (int(d) for d in tables["leaf_value"].shape)
    return (unique_nbytes(*tables.values()),
            packed_forest_bytes(T, L, int(tables["cat_words"].shape[0])))


def _draws_row_mask(config) -> bool:
    """Whether the train step draws a row mask of its own (bagging or
    GOSS) beside the learner's ones mask."""
    freq = int(config.get("bagging_freq", 0))
    balanced = (float(config.get("pos_bagging_fraction", 1.0)) < 1.0
                or float(config.get("neg_bagging_fraction", 1.0)) < 1.0)
    bagged = freq > 0 and (float(config.get("bagging_fraction", 1.0)) < 1.0
                           or balanced)
    goss = "goss" in (str(config.get("boosting", "gbdt")),
                      str(config.get("data_sample_strategy", "bagging")))
    return bagged or goss


def _pool_shape(learner) -> Tuple[int, int, int]:
    """(L + 1, G, B) of the grower's pool (ops/grower.py:grow): the
    bins' columns, or with sparse storage the merged features."""
    params = learner.params
    G = (int(learner.meta["hist_perm"].shape[0]) if params.has_sparse
         else int(learner.bins_t.shape[0]))
    return int(params.num_leaves) + 1, G, int(params.num_bins)


def _pool_itemsize(precision: str) -> int:
    from ..ops.histogram import INT_PRECISIONS

    if precision in INT_PRECISIONS:
        return 4
    return 8 if precision == "f64" else 4


def _stats_planes(precision: str) -> Tuple[int, int]:
    """(rows, bytes an entry) of `histogram.pack_stats`'s output."""
    from ..ops.histogram import _dot_spec

    stat_dtype, _ = _dot_spec(precision)
    import torch

    rows = 5 if precision == "hilo" else 3
    return rows, torch.empty(0, dtype=stat_dtype).element_size()


def kernel_scratch_bytes(learner) -> int:
    """The int32 scratch of the widest B1/B2/B4 call of this learner on
    the card (`histogram.call_plan` at the split batch's K slots); 0 on
    the CPU, where the twins run and allocate no scratch."""
    if learner.device.type != "cuda" or learner.params.precision == "f64":
        return 0
    from ..ops import histogram

    params = learner.params
    rows, _ = _stats_planes(params.precision)
    K = max(1, min(int(params.split_batch), int(params.num_leaves) - 1))
    floats = params.precision not in histogram.INT_PRECISIONS
    pblock = learner.packed_block
    out = 0
    calls = [(False, params.hist_impl == "pallas")]
    if params.hist_impl == "fused" and not floats:
        calls.append((True, False))
    for scan, flat in calls:
        plan = histogram.call_plan(learner.bins_t, rows, learner.n_pad, K,
                                   params.num_bins, floats, scan, pblock,
                                   flat)
        out = max(out, 4 * plan.scratch_words)
    return out


def plan_training(config, learner, num_class: int,
                  num_valid_rows: int = 0) -> MemoryPlan:
    """The itemized device bytes of one training run before iteration 0,
    from the live learner's tensors where they exist (the bins, their
    row-major copy) and the closed forms of the buffers each iteration
    makes (`live_bytes` reads those off a trained iteration)."""
    from ..io.bin_mapper import BinType
    from ..ops.histogram import row_major_cached

    k = max(int(num_class), 1)
    n, n_pad = int(learner.n), int(learner.n_pad)
    precision = str(learner.params.precision)
    comps: Dict[str, int] = {}
    comps["binned_matrix"] = int(learner.bins_t.nbytes)
    rows = row_major_cached(learner.bins_t, learner.packed_block)
    comps["row_major_bins"] = 0 if rows is None else int(rows.nbytes)
    L1, G, B = _pool_shape(learner)
    comps["histogram_pool"] = L1 * G * B * 3 * _pool_itemsize(precision)
    planes, item = _stats_planes(precision)
    comps["stats_planes"] = planes * n_pad * item
    comps["kernel_scratch"] = kernel_scratch_bytes(learner)
    # the train scores the rollback snapshot holds and the new buffer an
    # iteration writes, and the same two of each validation set's
    comps["score_buffers"] = 2 * k * n * 4 + 2 * k * int(num_valid_rows) * 4
    # the learner's ones mask, the step's [n_pad] f32 gradient and
    # hessian, its int32 leaf ids, and its row mask where it draws one
    comps["row_state"] = (4 + _draws_row_mask(config)) * n_pad * 4
    comps["packed_forest"] = packed_forest_bytes(
        int(config.get("num_iterations", 100)) * k,
        int(config.get("num_leaves", 31)))
    F = max(len(learner.td.used_feature_idx), 1)
    # a binning chunk (ops/binning.py:bin_chunks_t): the f64 values, the
    # int64 keys, searchsorted positions and bins ([F, rows] each), two
    # more int64 planes with categorical features, and the output's cast
    ingest_rows = min(max(int(config.get("tpu_ingest_chunk_rows", 65536)),
                          256), max(n, 1))
    has_cat = any(learner.td.mappers[c].bin_type == BinType.CATEGORICAL
                  for c in learner.td.used_feature_idx)
    out_item = int(learner.td.bins_t.element_size())
    comps["ingest_scratch"] = ingest_rows * F * (32 + 16 * has_cat
                                                 + out_item)
    # a predict chunk: the binning chunk's scratch and the [k, rows] f32
    # scores (a closed form: the tree walk's [T, rows] planes are not in
    # it, PERF.md)
    predict_chunk = int(config.get("tpu_predict_chunk_rows", 65536))
    comps["predict_scratch"] = predict_chunk * (F * 33 + k * 4)
    return MemoryPlan(comps, budget_bytes(config), "training")


def live_bytes(driver) -> Dict[str, int]:
    """The plan's components read off the live tensors of a driver that
    has trained at least one iteration: the bins and their row-major
    copy, the last tree's pool, stat planes and row state
    (`learner.last_buffers`), the largest kernel scratch since
    `histogram.reset_call_bytes`, the score buffers the last iteration
    held (its snapshot's and its own), the training data's largest
    binning chunk where the bins were made on the device in chunks.
    The forest's device tables have their own check at their own tree
    count (`forest_live_bytes`); predict_scratch is not read (PERF.md)."""
    from ..ops.histogram import PEAK_CALL_BYTES, row_major_cached

    learner = driver.learner
    out = {"binned_matrix": int(learner.bins_t.nbytes)}
    rows = row_major_cached(learner.bins_t, learner.packed_block)
    out["row_major_bins"] = 0 if rows is None else int(rows.nbytes)
    out.update(learner.last_buffers)
    out["kernel_scratch"] = int(PEAK_CALL_BYTES["kernel_scratch"])
    out["score_buffers"] = int(driver.last_score_bytes)
    ingest = getattr(learner.td, "ingest_scratch_bytes", None)
    if ingest is not None:
        out["ingest_scratch"] = int(ingest)
    return out
# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
def stream_config_blockers(config) -> List[str]:
    """Config-visible reasons the streamed layout cannot serve this run
    (the JAX package's list, shared by `select_layout` and the ladder's
    last rung)."""
    reasons = []
    strategy = str(config.get("tree_learner", "serial"))
    if strategy not in ("serial", "serial_tree_learner"):
        reasons.append(f"tree_learner={strategy}")
    if float(config.get("tpu_sparse_threshold", 0.0) or 0.0) > 0.0:
        reasons.append("sparse COO storage (tpu_sparse_threshold)")
    if str(config.get("forcedsplits_filename", "") or ""):
        reasons.append("forced splits")
    if float(config.get("feature_fraction_bynode", 1.0) or 1.0) < 1.0:
        reasons.append("feature_fraction_bynode")
    coupled = [float(v) for v in
               config.get("cegb_penalty_feature_coupled", []) or []]
    lazy = [float(v) for v in
            config.get("cegb_penalty_feature_lazy", []) or []]
    if (any(v != 0.0 for v in coupled) or any(v != 0.0 for v in lazy)
            or float(config.get("cegb_penalty_split", 0.0) or 0.0) != 0.0):
        reasons.append("CEGB penalties")
    if str(config.get("categorical_feature", "") or ""):
        reasons.append("categorical features")
    return reasons


def select_layout(config, train_data=None) -> str:
    """``tpu_stream_mode`` resolved to "resident" or "streamed" by the
    JAX package's rule: auto keeps the resident layout unless the run is
    streamable and the binned matrix would take more than half the
    budget."""
    mode = str(config.get("tpu_stream_mode", "auto") or "auto").lower()
    if mode in ("streamed", "resident"):
        return mode
    if mode != "auto":
        raise ValueError("tpu_stream_mode must be auto|resident|streamed,"
                         f" got {mode!r}")
    if stream_config_blockers(config):
        return "resident"
    budget = budget_bytes(config)
    if budget is None or train_data is None:
        return "resident"
    arrays = train_data.feature_arrays()
    if arrays["is_categorical"].any():
        return "resident"
    n = int(train_data.num_data)
    F = int(train_data.num_features)
    item = 1 if int(arrays["num_bin"].max()) <= 256 else 4
    return "streamed" if n * F * item > budget // 2 else "resident"


def check_layout(config, train_data) -> None:
    """Refuse by name, before the learner lays out its bins, a run that
    `select_layout` would stream: the port has no streamed layout yet
    (ROADMAP A8), and the resident one would not fit."""
    if str(config.get("tpu_stream_mode", "auto")).lower() != "auto":
        return
    if select_layout(config, train_data) == "streamed":
        raise NotImplementedError(
            "tpu_stream_mode=auto selecting streamed (the binned matrix "
            "would take more than half the device budget of "
            f"{budget_bytes(config):,d} bytes) is not ported to "
            "lightgbm_tpu_torch yet (ROADMAP A8); pass "
            "tpu_stream_mode=resident to try the resident layout")


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------
class DegradationLadder:
    """The deterministic, logged descent a classified OOM retries down,
    the JAX package's rungs in its order.  `next_step(config)` returns
    ``(step_name, param_overrides)`` or None when exhausted; a rung the
    port cannot take (`UNPORTED_STEPS`) is returned but not recorded as
    taken, and the caller ends the descent on it."""

    def __init__(self):
        self.steps_taken: List[Tuple[str, Dict[str, Any]]] = []

    def next_step(self, config) -> Optional[Tuple[str, Dict[str, Any]]]:
        step = self._propose(config)
        if step is not None and step[0] not in UNPORTED_STEPS:
            self.steps_taken.append(step)
        return step

    def _propose(self, config) -> Optional[Tuple[str, Dict[str, Any]]]:
        ingest = int(config.get("tpu_ingest_chunk_rows", 65536))
        predict = int(config.get("tpu_predict_chunk_rows", 65536))
        overrides: Dict[str, Any] = {}
        if ingest > CHUNK_FLOOR:
            overrides["tpu_ingest_chunk_rows"] = max(ingest // 2,
                                                     CHUNK_FLOOR)
        if predict > CHUNK_FLOOR:
            overrides["tpu_predict_chunk_rows"] = max(predict // 2,
                                                      CHUNK_FLOOR)
        if overrides:
            return "shrink_chunk_rows", overrides
        learner_kind = str(config.get("tree_learner", "serial"))
        sharded = (learner_kind in ("data", "data_parallel", "voting",
                                    "voting_parallel", "data_feature",
                                    "feature_data",
                                    "data_feature_parallel")
                   and int(config.get("num_machines", 1)) > 1)
        if sharded and str(config.get("tpu_hist_agg", "auto")) == "psum":
            return "hist_agg_scatter", {"tpu_hist_agg": "scatter"}
        if str(config.get("tpu_hist_impl", "auto")) == "fused":
            # only an explicit fused pin descends here: B2 becomes B1
            # (B1-int) plus the torch split search, the same model bytes
            return "fused_unfuse", {"tpu_hist_impl": "pallas2"}
        if str(config.get("tpu_bucket_policy", "wide")) == "wide":
            return "bucket_policy_fine", {"tpu_bucket_policy": "fine"}
        if (str(config.get("tpu_stream_mode", "auto")) == "auto"
                and not stream_config_blockers(config)):
            return "stream_layout", {"tpu_stream_mode": "streamed"}
        return None

    def describe(self) -> List[str]:
        return [name for name, _ in self.steps_taken]


def note_ladder_step(site: str, step: str, overrides: Dict[str, Any],
                     recovery: bool = True) -> None:
    """One ladder descent: counters + a flight-recorder transition.
    recovery=False (preflight degrade) counts only the step."""
    from ..obs import REGISTRY, flightrecorder

    if recovery:
        REGISTRY.inc("lgbm_oom_recoveries_total", site=str(site),
                     help="OOM recoveries: rollbacks that descended "
                          "the degradation ladder and retried")
    REGISTRY.inc("lgbm_oom_ladder_steps_total", step=str(step),
                 help="degradation-ladder steps taken, by step name")
    flightrecorder.note("oom", "ladder_step", site=str(site), step=step,
                        **{k: str(v) for k, v in overrides.items()})
