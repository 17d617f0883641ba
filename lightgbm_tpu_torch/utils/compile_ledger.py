"""A ledger of the kernel builds and launch plans this process makes.

The port of `lightgbm_tpu/utils/compile_ledger.py`.  The JAX package
compiles XLA programs at run time and records each distinct one; the
port compiles no program at run time, so its ledger keeps two kinds of
record instead:

* **builds** — the kernel library's build with `nvcc` or its load from
  the disk cache (`ops/kernels.py:library`): seconds, built or loaded,
  and the library's hash.  Recorded whether or not the ledger is on
  (once a process).
* **programs** — each distinct launch plan of each kernel site, with the
  host seconds of its first launch.  The sites are `hist_batched` (B1),
  `hist_flat` (B4), `fused_hist_scan` (B2), `partition_rows` (B3),
  `leaf_group` and `leaf_sums`; a plan is the kernel's instance (its
  launch counter's name) and its geometry: `HistPlan`'s fields
  (`ops/histogram.py`) for the grouped kernels, the slot count and the
  load width for B3, the grouping's plan for `leaf_group`, the leaf
  count for the sums.  A plan depends on the rows of the call, so a
  streamed run adds one plan a site for its full blocks and one for its
  tail, and more iterations add none.

The API keeps the JAX names where they carry over: `LEDGER`, `enable`,
`reset`, `record`, `n_programs(site)`, `programs`, `report`,
`format_report`, `cost_table(memory=True)` (each plan's scratch bytes,
`scratch_words * 4`, as ``argument_bytes``).  `analyze`, XLA's cost
analysis of a compiled program, has no counterpart here and raises by
name.

Off (the default), `launch` costs one attribute test a call.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

#: the kernel sites of the port, one per kernel family
SITES = ("hist_batched", "hist_flat", "fused_hist_scan", "partition_rows",
         "leaf_group", "leaf_sums")


class CompileLedger:
    """Thread-safe registry of the kernel library's builds and the
    distinct launch plans of each kernel site."""

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = False
        self._programs: List[Dict] = []
        self._seen = set()
        self._builds: List[Dict] = []

    # -- control -------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, on: bool = True) -> None:
        self._enabled = bool(on)

    def reset(self) -> None:
        """Forget the plans (the builds stay: a process builds once)."""
        with self._lock:
            self._programs = []
            self._seen = set()

    # -- recording ------------------------------------------------------
    def record(self, site: str, signature: str, wall_s: float,
               scratch_bytes: int = 0) -> None:
        with self._lock:
            self._programs.append({"site": site, "signature": signature,
                                   "first_call_s": float(wall_s),
                                   "scratch_bytes": int(scratch_bytes),
                                   "t": time.time()})

    def record_build(self, seconds: float, built: bool,
                     digest: str) -> None:
        with self._lock:
            self._builds.append({"seconds": float(seconds),
                                 "built": bool(built), "hash": str(digest),
                                 "t": time.time()})

    @contextlib.contextmanager
    def launch(self, site: str, instance: str, plan, scratch_bytes: int = 0):
        """Around one kernel launch: a plan not seen since `reset` is
        recorded with the host seconds of the launch call."""
        if not self._enabled:
            yield
            return
        key = (site, instance, tuple(int(v) for v in plan))
        with self._lock:
            new = key not in self._seen
            self._seen.add(key)
        t0 = time.perf_counter()
        yield
        if new:
            self.record(site, f"{instance}{list(key[2])}",
                        time.perf_counter() - t0, scratch_bytes)

    # -- reading --------------------------------------------------------
    def n_programs(self, site: Optional[str] = None) -> int:
        """Plans recorded while enabled (optionally of one site)."""
        with self._lock:
            if site is None:
                return len(self._programs)
            return sum(1 for p in self._programs if p["site"] == site)

    def programs(self) -> List[Dict]:
        with self._lock:
            return [dict(p) for p in self._programs]

    def builds(self) -> List[Dict]:
        with self._lock:
            return [dict(b) for b in self._builds]

    def analyze(self, memory: Optional[bool] = None) -> List[Dict]:
        raise NotImplementedError(
            "CompileLedger.analyze (XLA's cost and memory analysis of a "
            "compiled program) has no counterpart in lightgbm_tpu_torch: "
            "its kernels are built ahead of time; cost_table gives each "
            "launch plan's scratch bytes")

    def cost_table(self, memory: Optional[bool] = True) -> List[Dict]:
        """One row a plan: site, signature, first-call seconds and, with
        memory, its int32 scratch (``argument_bytes``, the bytes the
        launch allocates beside its operands)."""
        rows = []
        for p in self.programs():
            row = {"site": p["site"], "signature": p["signature"][:160],
                   "first_call_s": round(p["first_call_s"], 6)}
            if memory:
                row["argument_bytes"] = p["scratch_bytes"]
            rows.append(row)
        return rows

    def report(self) -> List[Dict]:
        """Per-site rollup sorted by total first-call wall, descending."""
        agg: Dict[str, Dict] = {}
        for p in self.programs():
            a = agg.setdefault(p["site"], {"site": p["site"], "programs": 0,
                                           "first_call_s": 0.0,
                                           "signatures": []})
            a["programs"] += 1
            a["first_call_s"] += p["first_call_s"]
            a["signatures"].append(p["signature"])
        return sorted(agg.values(), key=lambda a: -a["first_call_s"])

    def format_report(self) -> str:
        lines = []
        for b in self.builds():
            lines.append(f"kernel library {b['hash']} "
                         f"{'built' if b['built'] else 'loaded'} in "
                         f"{b['seconds']:.2f} s")
        lines.append(f"{'site':<28s} {'programs':>8s} {'first-call s':>12s}")
        total_n = total_s = 0
        for a in self.report():
            lines.append(f"{a['site']:<28s} {a['programs']:>8d} "
                         f"{a['first_call_s']:>12.4f}")
            total_n += a["programs"]
            total_s += a["first_call_s"]
        lines.append(f"{'TOTAL (n_programs)':<28s} {total_n:>8d} "
                     f"{total_s:>12.4f}")
        return "\n".join(lines)


LEDGER = CompileLedger()


def launch(site: str, instance: str, plan, scratch_bytes: int = 0):
    """`LEDGER.launch`: the context manager each kernel wrapper puts
    around its launch."""
    return LEDGER.launch(site, instance, plan, scratch_bytes)
