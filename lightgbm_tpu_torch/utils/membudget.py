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
  buffers: the learner's [G, n] bins and the kernels' row-major copy
  (on the streamed layout the two device slots of its largest block in
  their place), the grower's [L + 1, G, B, 3] pool and stat planes,
  the per-call scratch of B1/B2/B4, the score buffers (the one the
  rollback snapshot holds and the iteration's new one), the row masks,
  the packed forest, the ingest chunk, and a predict chunk with the
  tree walk's [T, rows] planes at the model's tree count.
  `live_bytes` reads the same components off the live tensors, which
  is what the plan is held to; `ledger_cross_check` holds the plan to
  the largest kernel scratch the compile ledger recorded.
* **layout** — `select_layout`: ``tpu_stream_mode`` resolved to the
  resident or the streamed layout (`ops/stream.py`) by the JAX rule.
* **degradation ladder** — `DegradationLadder`, the JAX package's rungs
  in its order: halve ``tpu_ingest_chunk_rows``/
  ``tpu_predict_chunk_rows`` (floor 4096), ``tpu_hist_agg=scatter``
  (only on a multi-machine run, which the port refuses),
  ``fused_unfuse`` (``tpu_hist_impl=fused`` -> ``pallas2``: int8/int16
  leave kernel B2 for B1-int and the torch split search),
  ``tpu_bucket_policy=fine``, and last ``stream_layout``: a run left on
  ``tpu_stream_mode=auto`` and streamable rebuilds its learner on the
  streamed layout, the resident tensors dropped first.  Each rung but
  the last leaves the model's bytes as they are; the last too for
  int8/int16 (int32 block sums are associative).

The serving budget and the registry's pressure of the JAX module are
not ported (ROADMAP A12).
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
    """The cards' memory numbers for diagnostics, read through
    `obs.resources` (membudget.py:148-156 of the JAX package): the
    caching allocator's allocated bytes, current and peak, the most of
    any card, and the smallest card's memory; all None on the CPU or
    before CUDA is initialized."""
    from ..obs import resources

    limits = [s["bytes_limit"] for s in resources.all_device_memory_stats()
              if s is not None]
    return {"hbm_bytes_in_use": resources.hbm_bytes_in_use(),
            "hbm_peak_bytes": resources.peak_hbm_bytes(),
            "hbm_capacity_bytes": min(limits) if limits else None}


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
    bins' columns, or with sparse storage the merged features; on a
    sharded learner one shard's: its feature slice, and of that its 1/P
    column slice under scatter aggregation."""
    params = learner.params
    G = (int(learner.meta["hist_perm"].shape[0]) if params.has_sparse
         else int(learner.g_pad))
    t = getattr(learner, "topology", None)
    if t is not None:
        from ..parallel.strategies import pool_partition_spec

        for axis in pool_partition_spec(learner.strategy,
                                        learner.hist_agg == "scatter"):
            G //= t.shape[axis]
    return int(params.num_leaves) + 1, G, int(params.num_bins)


def _shards(learner) -> int:
    """Shards of the learner's grid this process runs (1: serial)."""
    t = getattr(learner, "topology", None)
    return 1 if t is None else t.local_size


def _hist_operands(learner) -> list:
    """The distinct tensors the histogram kernels read: the serial bins,
    or each shard's (its feature slice under a feature axis)."""
    if getattr(learner, "topology", None) is None:
        return [learner.bins_t]
    ops = {}
    for h, b in zip(learner.shard_hist_bins, learner.shard_bins):
        x = h if h is not None else b
        ops[(x.data_ptr(), str(x.device))] = x
    return list(ops.values())


def device_bins_bytes(learner) -> Tuple[int, int]:
    """(binned matrix, row-major copies) bytes on the device: the serial
    learner's matrix, or a sharded learner's distinct shard tensors (the
    shards that share a card share a replicated matrix)."""
    from ..ops.histogram import row_major_cached

    rows = [row_major_cached(x, learner.packed_block)
            for x in _hist_operands(learner)]
    rows = sum(int(r.nbytes) for r in rows if r is not None)
    if getattr(learner, "topology", None) is None:
        return int(learner.bins_t.nbytes), rows
    return unique_nbytes(*learner.shard_bins, *[
        h for h in learner.shard_hist_bins if h is not None]), rows


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
    the card (`histogram.call_plan` at the split batch's K slots, over
    all rows, or over a stream block's on the streamed layout); 0 on the
    CPU, where the twins run and allocate no scratch."""
    if learner.device.type != "cuda" or learner.params.precision == "f64":
        return 0
    import torch

    from ..ops import histogram

    params = learner.params
    rows, _ = _stats_planes(params.precision)
    K = max(1, min(int(params.split_batch), int(params.num_leaves) - 1))
    floats = params.precision not in histogram.INT_PRECISIONS
    pblock = learner.packed_block
    out = 0
    calls = [(False, params.hist_impl == "pallas")]
    if learner.stream_layout:
        # the plan of a block's call: its operand's dtype, its rows
        n, features = learner._stream_R, learner.g_pad
        operand = torch.empty((0, features), device=learner.device,
                              dtype=learner._host_blocks[0].dtype)
    elif getattr(learner, "topology", None) is not None:
        # every shard launches at once, each with its own scratch: the
        # widest call of a shard's operand, times the shards
        operand = _hist_operands(learner)[0]
        n = learner.n_pad // learner.d_shards
        plan = histogram.call_plan(operand, rows, n, K, params.num_bins,
                                   floats, False, pblock, calls[0][1])
        return 4 * plan.scratch_words * _shards(learner)
    else:
        n, features, operand = learner.n_pad, None, learner.bins_t
        if params.hist_impl == "fused" and not floats:
            calls.append((True, False))
    for scan, flat in calls:
        plan = histogram.call_plan(operand, rows, n, K, params.num_bins,
                                   floats, scan, pblock, flat, features)
        out = max(out, 4 * plan.scratch_words)
    return out


def stream_slot_bytes(config, learner) -> int:
    """Device bytes of the streamed layout's two slots: read off the live
    slots once they exist, else two of the learner's largest host block,
    else (the ladder's last rung, planned before the learner is rebuilt)
    two blocks of the rows `resolve_stream_rows` would give, in the
    row-major bytes of the resident learner's columns."""
    import torch

    from ..ops.stream import resolve_stream_rows

    stream = getattr(learner, "_stream", None)
    if stream is not None and stream.slot_bytes():
        return stream.slot_bytes()
    blocks = getattr(learner, "_host_blocks", None)
    if blocks:
        return 2 * max(int(b.nbytes) for b in blocks)
    n_pad, g_pad = int(learner.n_pad), int(learner.g_pad)
    wide = learner.bins_t.dtype == torch.int32
    rows = resolve_stream_rows(
        int(config.get("tpu_stream_block_rows", 0) or 0), n_pad,
        g_pad * (4 if wide else 1),
        min(int(learner.params.block_rows), n_pad), budget_bytes(config))
    return 2 * rows * g_pad * (2 if wide else 1)


def predict_chunk_bytes(config, num_features: int, num_class: int,
                        num_trees: int, bins_item: int = 1,
                        has_cat: bool = False,
                        rows: Optional[int] = None) -> int:
    """Device bytes of one predict chunk (`GBDT.predict`, read off its
    tensors as `predict_scratch_bytes`) of `rows` rows (default a full
    `tpu_predict_chunk_rows` chunk): the binning chunk's tensors (as
    ingest_scratch), the forest walk's (`ops/predict.py:
    forest_walk_bytes`: one group of trees' planes at any tree count),
    and the [k, rows] f32 scores."""
    from ..ops.predict import forest_walk_bytes

    if rows is None:
        rows = int(config.get("tpu_predict_chunk_rows", 65536))
    F = max(int(num_features), 1)
    binning = rows * F * (32 + 16 * has_cat + int(bins_item))
    return (binning + forest_walk_bytes(num_trees, num_class, rows,
                                        bins_item, has_cat)
            + rows * max(int(num_class), 1) * 4)


def plan_training(config, learner, num_class: int,
                  num_valid_rows: int = 0) -> MemoryPlan:
    """The itemized device bytes of one training run before iteration 0,
    from the live learner's tensors where they exist (the bins, their
    row-major copy) and the closed forms of the buffers each iteration
    makes (`live_bytes` reads those off a trained iteration)."""
    from ..io.bin_mapper import BinType

    k = max(int(num_class), 1)
    n, n_pad = int(learner.n), int(learner.n_pad)
    precision = str(learner.params.precision)
    comps: Dict[str, int] = {}
    if (learner.stream_layout
            or str(config.get("tpu_stream_mode", "auto")) == "streamed"):
        # the matrix and its row-major copy stay in host memory: two
        # slots of the largest block take their place (also where the
        # ladder's last rung plans before rebuilding the learner)
        comps["stream_slots"] = stream_slot_bytes(config, learner)
    else:
        comps["binned_matrix"], comps["row_major_bins"] = \
            device_bins_bytes(learner)
    L1, G, B = _pool_shape(learner)
    shards = _shards(learner)
    fs = int(getattr(learner, "f_shards", 1))
    comps["histogram_pool"] = (L1 * G * B * 3 * _pool_itemsize(precision)
                               * shards)
    planes, item = _stats_planes(precision)
    # each shard's planes over its rows: this process's rows a feature
    # shard (every row in one process)
    t = getattr(learner, "topology", None)
    local_rows = n_pad // (1 if t is None else t.processes)
    comps["stats_planes"] = planes * local_rows * item * fs
    comps["kernel_scratch"] = kernel_scratch_bytes(learner)
    # the train scores the rollback snapshot holds and the new buffer an
    # iteration writes, and the same two of each validation set's
    comps["score_buffers"] = 2 * k * n * 4 + 2 * k * int(num_valid_rows) * 4
    # the learner's ones mask, the step's [n_pad] f32 gradient and
    # hessian, its int32 leaf ids, and its row mask where it draws one;
    # sharded, each shard's leaf ids besides (shard 0's are the tree's
    # where the rows are not sharded)
    width = int(getattr(learner, "row_width", n_pad))
    comps["row_state"] = (4 + _draws_row_mask(config)) * width * 4
    if shards > 1:
        rows_sharded = learner.strategy != "feature"
        comps["row_state"] += (fs - (not rows_sharded)) * local_rows * 4
    comps["packed_forest"] = packed_forest_bytes(
        int(config.get("num_iterations", 100)) * k,
        int(config.get("num_leaves", 31)))
    F = max(len(learner.td.used_feature_idx), 1)
    if str(config.get("tpu_autotune", "off")) != "off":
        # the autotune probe's synthetic operands (utils/autotune.py:
        # tune_entry): bins, stats and one histogram, its rows capped
        from .autotune import probe_bytes

        comps["autotune_scratch"] = probe_bytes(n_pad, learner.g_pad)
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
    # a predict chunk at the model's tree count, of the rows of the
    # largest set the run predicts (the training set or a validation
    # set), at most a chunk
    chunk = int(config.get("tpu_predict_chunk_rows", 65536))
    comps["predict_scratch"] = predict_chunk_bytes(
        config, F, k, int(config.get("num_iterations", 100)) * k, out_item,
        has_cat, rows=min(chunk, max(n, int(num_valid_rows), 1)))
    return MemoryPlan(comps, budget_bytes(config), "training")


def live_bytes(driver) -> Dict[str, int]:
    """The plan's components read off the live tensors of a driver that
    has trained at least one iteration: the bins and their row-major
    copy (the two slots on the streamed layout), the last tree's pool,
    stat planes and row state (`learner.last_buffers`), the largest
    kernel scratch since `histogram.reset_call_bytes`, the score buffers
    the last iteration held (its snapshot's and its own), the training
    data's largest binning chunk where the bins were made on the device
    in chunks, and the last predict chunk's tensors
    (`GBDT.predict_scratch_bytes`, where a predict ran).  The forest's
    device tables have their own check at their own tree count
    (`forest_live_bytes`)."""
    from ..ops.histogram import PEAK_CALL_BYTES

    learner = driver.learner
    if learner.stream_layout:
        out = {"stream_slots": learner._stream.slot_bytes()}
    else:
        out = dict(zip(("binned_matrix", "row_major_bins"),
                       device_bins_bytes(learner)))
    out.update(learner.last_buffers)
    # the shards of a sharded learner launch at once, each with its own
    out["kernel_scratch"] = (int(PEAK_CALL_BYTES["kernel_scratch"])
                             * _shards(learner))
    out["score_buffers"] = int(driver.last_score_bytes)
    ingest = getattr(learner.td, "ingest_scratch_bytes", None)
    if ingest is not None:
        out["ingest_scratch"] = int(ingest)
    predict = getattr(driver, "predict_scratch_bytes", None)
    if predict is not None:
        out["predict_scratch"] = int(predict)
    return out


def ledger_cross_check(plan: MemoryPlan, site: str = "hist"
                       ) -> Optional[Dict]:
    """The plan held to the compile ledger's other side (the JAX
    package's `ledger_cross_check`, which holds it to XLA's argument
    bytes): the largest scratch of a recorded launch plan whose site
    contains `site` against the plan's kernel_scratch (on the CPU the
    twins' records hold no scratch).  None when no plan was recorded
    (the ledger off)."""
    from .compile_ledger import LEDGER

    rows = [r for r in LEDGER.cost_table(memory=True)
            if site in r["site"] and r.get("argument_bytes") is not None]
    if not rows:
        return None
    biggest = max(rows, key=lambda r: r["argument_bytes"])
    planned = int(plan.components.get("kernel_scratch", 0))
    return {"site": biggest["site"],
            "signature": biggest["signature"],
            "ledger_argument_bytes": int(biggest["argument_bytes"]),
            "plan_kernel_scratch": planned,
            "plan_total": plan.total,
            "covered": planned >= int(biggest["argument_bytes"])}
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


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------
class DegradationLadder:
    """The deterministic, logged descent a classified OOM retries down,
    the JAX package's rungs in its order.  `next_step(config)` returns
    ``(step_name, param_overrides)`` or None when exhausted."""

    def __init__(self):
        self.steps_taken: List[Tuple[str, Dict[str, Any]]] = []

    def next_step(self, config) -> Optional[Tuple[str, Dict[str, Any]]]:
        step = self._propose(config)
        if step is not None:
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
        # the last rung: the binned matrix leaves the card for host blocks
        # (ops/stream.py); only under auto (a resident pin, or a run
        # already streamed, has nothing left to give) and where the run
        # streams
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
