"""Persisted autotuning of the histogram kernel: measured winners replace
the "auto" rule.

The port of `lightgbm_tpu/utils/autotune.py`, with its profile format,
`profile_path`, `shape_bucket`, `load`/`tune` modes and
`AutotuneStaleProfile`:

* a profile file (JSON) maps (platform, device count, device name, shape
  bucket) to the winning ``tpu_hist_impl`` and ``tpu_block_rows``, with
  the table of every candidate's rows/s;
* ``tpu_autotune=load`` takes the winner where the profile has the
  bucket; a profile recorded elsewhere raises `AutotuneStaleProfile`;
* ``tpu_autotune=tune`` measures a missing bucket first (`tune_entry`),
  saves it, then loads.

The fingerprint is ``{platform, device_count, device_name}``: "gpu" and
`torch.cuda.get_device_name(0)` on the card, "cpu" and "cpu" on the CPU.
A profile without a device name, or with another one, is stale: every
profile the JAX package wrote (its platform "tpu" or "cpu", no device
name) is refused here.

`tune_entry` times the port's candidates on synthetic operands by CUDA
events on the card (by the host clock on the CPU, where every candidate
runs the same plain twin): ``pallas2`` (kernel B1), ``pallas`` (B4) and,
for int8/int16, ``fused`` (B2 with its split scan), at the JAX
package's row blocks.  Each candidate gives the same int8/int16 model
bytes (int32 histograms), so a tuned run's text is the untuned one's.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from .log import Log

PROFILE_VERSION = 1
# rows of synthetic operands a candidate is timed on, at most
_TUNE_ROWS_CAP = 131072
_TUNE_REPS = 3
# K slots of a timed call (the split batch at 255 leaves)
_TUNE_SLOTS = 25


class AutotuneStaleProfile(RuntimeError):
    """The profile was recorded on another platform, device count or
    card (or by the JAX package).  Raised, never ignored: measured
    winners of other hardware look authoritative and are not.  Delete
    or re-tune the file."""


def profile_path(config) -> str:
    """The profile's path: tpu_autotune_profile, else
    autotune_profile.json in tpu_compile_cache_dir, else a dotfile in
    the working directory."""
    explicit = str(config.get("tpu_autotune_profile", "") or "")
    if explicit:
        return explicit
    cache_dir = str(config.get("tpu_compile_cache_dir", "") or "")
    if cache_dir:
        return os.path.join(cache_dir, "autotune_profile.json")
    return os.path.join(os.getcwd(), ".lgbtpu_autotune.json")


def backend_fingerprint(device=None) -> Dict[str, object]:
    """{platform, device_count, device_name} of the device a run
    trains on (the card unless `device` is the CPU)."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return {"platform": "cpu", "device_count": 1, "device_name": "cpu"}
    return {"platform": "gpu", "device_count": torch.cuda.device_count(),
            "device_name": torch.cuda.get_device_name(0)}


def shape_bucket(n_rows: int, num_features: int, num_bins: int) -> str:
    """Power-of-two (rows, features) and the exact bin count."""
    def up2(x):
        return 1 << max(int(x) - 1, 1).bit_length()

    return f"r{up2(n_rows)}_f{up2(num_features)}_b{int(num_bins)}"


def load_profile(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            prof = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as exc:
        Log.warning(f"autotune profile {path!r} unreadable ({exc}); "
                    "ignoring it")
        return None
    if not isinstance(prof, dict) or "entries" not in prof:
        Log.warning(f"autotune profile {path!r} malformed; ignoring it")
        return None
    return prof


def save_profile(path: str, profile: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    # an atomic replace: a reader never sees half a file
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(profile, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def check_fingerprint(profile: dict, path: str, device=None) -> None:
    """Raise AutotuneStaleProfile unless the profile's schema version,
    platform, device count and device name are this run's."""
    fp = backend_fingerprint(device)
    if int(profile.get("version", -1)) != PROFILE_VERSION:
        raise AutotuneStaleProfile(
            f"autotune profile {path!r} has schema version "
            f"{profile.get('version')!r}, this build expects "
            f"{PROFILE_VERSION}; re-tune it (tpu_autotune=tune) or "
            "delete it")
    for key in ("platform", "device_count", "device_name"):
        got, now = profile.get(key), fp[key]
        if got != now:
            raise AutotuneStaleProfile(
                f"autotune profile {path!r} was recorded on {key}={got!r} "
                f"but this run is on {key}={now!r}: measured winners of "
                "other hardware are refused; re-tune here "
                "(tpu_autotune=tune) or point tpu_autotune_profile "
                "elsewhere")


def probe_bytes(n_pad: int, columns: int) -> int:
    """Device bytes of `tune_entry`'s operands (utils/membudget.py's
    autotune_scratch): at most _TUNE_ROWS_CAP rows of [columns] uint8
    bins, their row-major copy, five bf16 stat planes, the leaf ids and
    a kernel's 5 words a row of scratch, and the histograms."""
    rows = min(max(int(n_pad), 1), _TUNE_ROWS_CAP)
    fr = -(-int(columns) // 32) * 32
    out = _TUNE_SLOTS * fr * 256 * 5 * 4
    return rows * (int(columns) + fr + 10 + 4 + 20) + out


def _candidates(precision: str):
    from ..ops.histogram import INT_PRECISIONS

    out = [("pallas2", 4096), ("pallas2", 8192), ("pallas", 256)]
    if precision in INT_PRECISIONS:
        out += [("fused", 4096), ("fused", 8192)]
    return out


def tune_entry(n_rows: int, num_features: int, num_bins: int,
               precision: str, device=None) -> dict:
    """Time each candidate on synthetic operands of this bucket (a
    bucket-keyed generator): K = 25 slots over random leaf ids, one call
    of the candidate's kernel a rep, on the card by CUDA events.  The
    profile entry: the winner's impl and block, its rows/s and the
    table."""
    import torch

    from ..ops.fused import CTX_WIDTH, fused_hist_scan
    from ..ops.histogram import build_histogram_batched_t, pack_stats

    dev = torch.device(device if device is not None else "cuda")
    cuda = dev.type == "cuda"
    n = min(int(n_rows), _TUNE_ROWS_CAP)
    F = -(-int(num_features) // 32) * 32
    rng = np.random.default_rng(num_features * 1_000_003 + num_bins)
    K = _TUNE_SLOTS
    dtype = np.uint8 if num_bins <= 256 else np.int32
    bins = torch.as_tensor(rng.integers(0, num_bins, size=(F, n))
                           .astype(dtype), device=dev)
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
    h = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    if precision in ("int8", "int16"):
        q = 127 if precision == "int8" else 32767
        g, h = (torch.clamp((v * 16).round(), -q, q) for v in (g, h))
    stats = pack_stats(g, h, ones, precision).contiguous()
    leaf = torch.as_tensor(rng.integers(0, K, size=n).astype(np.int32),
                           device=dev)
    slots = torch.arange(K, dtype=torch.int32, device=dev)
    zi = torch.zeros((F, 8), dtype=torch.int32, device=dev)
    zi[:, 0] = num_bins
    zf = torch.ones((F, 8), dtype=torch.float32, device=dev)
    parent = torch.zeros((K, F, num_bins, 3), dtype=torch.int32, device=dev)
    ctx = torch.zeros((2 * K + 1, CTX_WIDTH), dtype=torch.float32,
                      device=dev)
    ctx[2 * K, :3] = 1.0
    split_kw = dict(l1=0.0, l2=0.0, max_delta_step=0.0,
                    min_data_in_leaf=20.0, min_sum_hessian=1e-3,
                    min_gain_to_split=0.0)

    def call(impl):
        if impl == "fused":
            return fused_hist_scan(bins, stats, leaf, slots, parent, ctx,
                                   zi, zf, num_bins, precision,
                                   split_kw=split_kw)
        return build_histogram_batched_t(bins, stats, leaf, slots, num_bins,
                                         precision, impl)

    table = {}
    for impl, block in _candidates(precision):
        try:
            call(impl)                               # the first launch
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(_TUNE_REPS):
                    call(impl)
                end.record()
                end.synchronize()
                secs = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(_TUNE_REPS):
                    call(impl)
                secs = time.perf_counter() - t0
            table[f"{impl}:{block}"] = n * _TUNE_REPS / max(secs, 1e-9)
        except (RuntimeError, ValueError) as exc:
            Log.warning(f"autotune candidate {impl}:{block} failed: "
                        f"{type(exc).__name__}: {exc}")
    if not table:
        raise RuntimeError(
            f"autotune measured no viable candidate for {n_rows}x"
            f"{num_features} rows/features at {num_bins} bins")
    best = max(table, key=table.get)
    impl, block = best.split(":")
    return {"hist_impl": impl, "block_rows": int(block),
            "rows_per_sec": table[best], "precision": precision,
            "table": table}


def resolve_autotune(config, n_rows: int, num_features: int, num_bins: int,
                     precision: str, device=None) -> Optional[dict]:
    """The learner's entry point: this bucket's profile entry, or None
    (off, or nothing measured).  load refuses a stale profile; tune
    measures and saves a missing entry first."""
    mode = str(config.get("tpu_autotune", "off"))
    if mode == "off":
        return None
    if mode not in ("load", "tune"):
        raise ValueError(f"tpu_autotune={mode!r}; expected off, load, "
                         "or tune")
    path = profile_path(config)
    prof = load_profile(path)
    if prof is not None:
        check_fingerprint(prof, path, device)
    bucket = shape_bucket(n_rows, num_features, num_bins)
    entry = (prof or {}).get("entries", {}).get(bucket)
    if entry is not None and str(entry.get("precision")) != precision:
        entry = None  # measured at another stats precision: re-tune
    if entry is None:
        if mode == "load":
            Log.info(f"autotune: no profile entry for bucket {bucket} at "
                     f"{path!r}; auto keeps the built-in rule")
            return None
        try:
            entry = tune_entry(n_rows, num_features, num_bins, precision,
                               device)
        except RuntimeError as exc:
            Log.warning(f"autotune: {exc}; auto keeps the built-in rule")
            return None
        prof = prof or {"version": PROFILE_VERSION,
                        **backend_fingerprint(device), "entries": {}}
        prof["entries"][bucket] = entry
        save_profile(path, prof)
        Log.info(f"autotune: measured bucket {bucket} -> "
                 f"{entry['hist_impl']}:{entry['block_rows']} "
                 f"({entry['rows_per_sec']:.0f} rows/s), saved to {path!r}")
    return entry
