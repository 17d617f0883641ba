"""Atomic iteration-granular training checkpoints, on one host.

The port of the single-host half of `lightgbm_tpu/utils/checkpoint.py`,
in its bundle format byte for byte in structure, so a bundle written by
either package resumes in the other.  A checkpoint is one directory
(``ckpt-<iteration>``) holding the full restart bundle:

* ``model.txt``   — the model string with its ``tpu_bin_mappers:`` and
  ``pandas_categorical:`` trailers (the bytes ``save_model`` writes),
  so trees rebind into bin space exactly on restore;
* ``state.json``  — the driver's non-array training state
  (`models/gbdt.py:capture_train_state`: the iteration counter, the
  threefry key words, the numpy bit-generator states, the
  boost-from-average flags, early stopping's state, the params
  snapshot and fingerprint), written with ``sort_keys``;
* ``arrays.npz``  — the f32 score buffers (``train_scores``,
  ``valid_scores/<name>``) and the cached bagging mask (``bag_mask``).
  Restoring the scores byte for byte is what makes a resumed run give
  the bit-identical model of an uninterrupted one: replaying the trees
  would round the f32 sums in another order;
* ``manifest.json`` — ``format`` 1, the iteration, and the CRC32 and
  byte count of each file.

Write protocol (torn-write safe on POSIX): every file lands in a hidden
temp directory first, each file is flushed and fsync'd, the manifest is
written last, the temp directory is renamed into place, and the parent
directory is fsync'd.  `load_latest` walks newest-first and skips, with
a warning, anything whose manifest is missing, unparseable, or whose
CRCs do not match.  Retention keeps the newest `keep` valid bundles and
prunes oldest-first, so an interrupt mid-prune leaves extra old bundles,
never fewer recent ones.

Left out (ROADMAP A9): the multi-host group commit (``host-<k>/``
bundles and ``global-<iteration>.json`` manifests) and the elastic
re-slicing of a group's buffers.  A manager in a `torch.distributed`
group of more than one process, and a resume from a directory that
holds a group's manifests, raise `NotImplementedError` by name.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import faultline
from .log import Log

MANIFEST = "manifest.json"
_PREFIX = "ckpt-"
_TMP_PREFIX = ".tmp-ckpt-"
_HOST_PREFIX = "host-"
_GLOBAL_PREFIX = "global-"
FORMAT_VERSION = 1

# Topology / operational params whose change does NOT break the bitwise
# resume contract, excluded from the fingerprint (the JAX package's
# set, unchanged, so the two packages' fingerprints agree).  The device
# is not among them: a card <-> CPU resume names device_type.
ELASTIC_PARAMS = frozenset({
    "tree_learner", "num_machines", "machines", "machine_list_filename",
    "local_listen_port", "time_out", "pre_partition", "num_threads",
    "tpu_feature_shards", "tpu_topology_hosts", "tpu_hist_agg",
    "tpu_donate_buffers",
    "tpu_compile_cache_dir", "tpu_collective_timeout_s",
    "tpu_collective_retries", "tpu_resume_elastic", "tpu_resume_strict",
    "tpu_checkpoint_dir", "tpu_checkpoint_interval",
    "tpu_checkpoint_keep", "verbosity",
})

# params whose change is a TOPOLOGY move — what tpu_resume_elastic=false
# refuses
_TOPOLOGY_KEYS = frozenset({
    "tree_learner", "num_machines", "machines", "machine_list_filename",
    "pre_partition", "tpu_feature_shards", "tpu_hist_agg",
})


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # non-POSIX / exotic fs: rename is still atomic
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, data: bytes) -> None:
    """Write + fsync one payload file, honoring the `checkpoint_write`
    fault point: ``truncate`` writes half the bytes (a torn write the
    manifest CRC catches), ``raise`` aborts mid-bundle."""
    action = faultline.fire("checkpoint_write", path=os.path.basename(path))
    if action == "truncate":
        data = data[:len(data) // 2]
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _refuse_group(what: str) -> None:
    raise NotImplementedError(
        f"{what} (the multi-host checkpoint group) is not ported to "
        "lightgbm_tpu_torch yet (ROADMAP A9)")


class CheckpointManager:
    """Atomic write + validated read + keep-last-N retention over one
    checkpoint directory (the JAX package's flat single-host layout)."""

    def __init__(self, directory: str, keep: int = 3, host_count: int = 1):
        if not directory:
            raise ValueError("checkpoint directory must be non-empty")
        if int(host_count) > 1:
            _refuse_group(f"a checkpoint manager for {host_count} hosts")
        self.directory = str(directory)
        self.keep = max(int(keep), 1)
        os.makedirs(self.directory, exist_ok=True)

    # -- naming --------------------------------------------------------
    @staticmethod
    def _name(iteration: int) -> str:
        return f"{_PREFIX}{int(iteration):08d}"

    @staticmethod
    def _iteration_of(name: str) -> Optional[int]:
        if not name.startswith(_PREFIX):
            return None
        try:
            return int(name[len(_PREFIX):])
        except ValueError:
            return None

    def checkpoints(self) -> List[Tuple[int, str]]:
        """(iteration, path) of every checkpoint-named dir, newest first
        (validity NOT checked here)."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            it = self._iteration_of(name)
            if it is not None:
                out.append((it, os.path.join(self.directory, name)))
        out.sort(reverse=True)
        return out

    def latest_iteration(self) -> Optional[int]:
        cks = self.checkpoints()
        return cks[0][0] if cks else None

    # -- write ---------------------------------------------------------
    def save(self, iteration: int, model_text: str, state: Dict,
             arrays: Dict[str, np.ndarray]) -> str:
        """Write one atomic checkpoint bundle; returns its path.
        Re-saving an iteration that already has a VALID checkpoint is a
        no-op (the flush-on-exit path may race a just-written interval
        checkpoint)."""
        from .. import obs

        final = os.path.join(self.directory, self._name(iteration))
        if os.path.isdir(final) and self.validate(final):
            return final
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{int(iteration):08d}-{os.getpid()}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            payloads: Dict[str, bytes] = {
                "model.txt": model_text.encode("utf-8"),
                "state.json": json.dumps(state, sort_keys=True).encode(),
            }
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            payloads["arrays.npz"] = buf.getvalue()
            manifest = {"format": FORMAT_VERSION,
                        "iteration": int(iteration), "files": {}}
            for name, data in payloads.items():
                # the manifest records the INTENDED bytes: a torn write
                # then fails CRC validation like a crash mid-write would
                manifest["files"][name] = {"crc32": zlib.crc32(data),
                                           "bytes": len(data)}
                _write_file(os.path.join(tmp, name), data)
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            if os.path.isdir(final):  # stale invalid leftover
                shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._retain()
        obs.REGISTRY.inc("lgbm_checkpoint_writes_total",
                         help="atomic checkpoint bundles committed")
        obs.REGISTRY.observe("lgbm_checkpoint_seconds",
                             time.perf_counter() - t0, op="save")
        obs.event("checkpoint_saved", iteration=int(iteration))
        return final

    def _retain(self) -> None:
        """Keep the newest `keep` checkpoints; drop older ones (oldest
        first) and any stale temp directories."""
        for it, path in reversed(self.checkpoints()[self.keep:]):
            shutil.rmtree(path, ignore_errors=True)
        try:
            for name in os.listdir(self.directory):
                if name.startswith(_TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        except OSError:
            pass

    # -- read ----------------------------------------------------------
    def validate(self, path: str) -> bool:
        """Manifest present, parseable, and every listed file's CRC32 +
        size match."""
        try:
            with open(os.path.join(path, MANIFEST)) as f:
                manifest = json.load(f)
            files = manifest["files"]
            for name, meta in files.items():
                with open(os.path.join(path, name), "rb") as f:
                    data = f.read()
                if len(data) != int(meta["bytes"]) \
                        or zlib.crc32(data) != int(meta["crc32"]):
                    return False
            return {"model.txt", "state.json", "arrays.npz"} <= set(files)
        except (OSError, ValueError, KeyError, TypeError):
            return False

    @staticmethod
    def _read_bundle(path: str) -> Tuple[str, Dict, Dict]:
        """(model_text, state, arrays) of one validated bundle dir."""
        with open(os.path.join(path, "model.txt"), encoding="utf-8") as f:
            model_text = f.read()
        with open(os.path.join(path, "state.json")) as f:
            state = json.load(f)
        with np.load(os.path.join(path, "arrays.npz"),
                     allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        return model_text, state, arrays

    def load_latest(self) -> Optional[Tuple[int, str, Dict, Dict, str]]:
        """Newest VALID checkpoint as (iteration, model_text, state,
        arrays, path); torn/corrupt checkpoints are skipped with a
        warning.  None when no valid checkpoint exists."""
        for it, path in self.checkpoints():
            if not self.validate(path):
                Log.warning(f"skipping corrupt/torn checkpoint {path} "
                            "(manifest missing or CRC mismatch)")
                continue
            try:
                model_text, state, arrays = self._read_bundle(path)
            except (OSError, ValueError, KeyError) as exc:
                Log.warning(f"skipping unreadable checkpoint {path}: {exc}")
                continue
            return it, model_text, state, arrays, path
        return None


# ---------------------------------------------------------------------------
# Booster-level bundle assembly
# ---------------------------------------------------------------------------
def make_manager(directory: str, keep: int = 3) -> CheckpointManager:
    """The manager of this process: refused in a `torch.distributed`
    group of more than one process (its group commit is ROADMAP A9)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        _refuse_group(f"checkpointing in a group of "
                      f"{dist.get_world_size()} processes")
    return CheckpointManager(directory, keep=keep)


def _params_snapshot(params: Dict) -> Dict[str, str]:
    """Canonical-keyed stringified params — stored in the bundle so a
    mismatch at resume can NAME the differing keys."""
    from ..config import canonical_name

    out: Dict[str, str] = {}
    for k, v in (params or {}).items():
        canon = canonical_name(str(k)) or str(k)
        out[canon] = str(v)
    return out


def _params_fingerprint(params: Dict) -> int:
    """Stable fingerprint of the training params a bitwise resume
    depends on (`ELASTIC_PARAMS` excluded)."""
    snap = {k: v for k, v in _params_snapshot(params).items()
            if k not in ELASTIC_PARAMS}
    return zlib.crc32(json.dumps(snap, sort_keys=True).encode())


def params_diff(stored: Dict[str, str], live: Dict[str, str]
                ) -> Tuple[List[Tuple[str, str, str]],
                           List[Tuple[str, str, str]]]:
    """Key-level diff of two params snapshots as (elastic_changes,
    material_changes), each a list of (key, stored_value, live_value)
    with "<unset>" marking absence."""
    elastic: List[Tuple[str, str, str]] = []
    material: List[Tuple[str, str, str]] = []
    for k in sorted(set(stored) | set(live)):
        a = stored.get(k, "<unset>")
        b = live.get(k, "<unset>")
        if a == b:
            continue
        (elastic if k in ELASTIC_PARAMS else material).append((k, a, b))
    return elastic, material


def _fmt_diff(changes: Sequence[Tuple[str, str, str]]) -> str:
    return ", ".join(f"{k}: {a} -> {b}" for k, a, b in changes)


def _resume_flags(booster) -> Tuple[bool, bool]:
    """(tpu_resume_elastic, tpu_resume_strict) from the driver's
    Config; the registry defaults without one."""
    cfg = getattr(booster._driver, "config", None)
    if cfg is None:
        return True, False
    return bool(cfg.tpu_resume_elastic), bool(cfg.tpu_resume_strict)


def _callback_states(callbacks) -> Dict:
    out = {}
    for cb in callbacks or []:
        key = getattr(cb, "state_key", None)
        snap = getattr(cb, "snapshot_state", None)
        if key and callable(snap):
            out[str(key)] = snap()
    return out


def save_checkpoint(booster, manager: CheckpointManager,
                    callbacks=None) -> str:
    """Write one atomic checkpoint of a live training booster."""
    state, arrays = booster._driver.capture_train_state()
    state["best_iteration"] = int(booster.best_iteration)
    state["params_fingerprint"] = _params_fingerprint(booster.params)
    state["params_snapshot"] = _params_snapshot(booster.params)
    cb_states = _callback_states(callbacks)
    if cb_states:
        state["callbacks"] = cb_states
    model_text = booster.model_to_string(num_iteration=-1)
    return manager.save(state["iteration"], model_text, state, arrays)


def _load_flat(booster, manager: CheckpointManager
               ) -> Optional[Tuple[int, str, Dict, Dict, str]]:
    """The newest valid flat bundle, held to the live row count; a
    directory holding a multi-host group's manifests or host bundles is
    refused by name."""
    try:
        names = os.listdir(manager.directory)
    except OSError:
        names = []
    if any(n.startswith(_HOST_PREFIX) or (n.startswith(_GLOBAL_PREFIX)
                                          and n.endswith(".json"))
           for n in names):
        _refuse_group(f"resuming the checkpoint group in "
                      f"{manager.directory}")
    found = manager.load_latest()
    if found is None:
        return None
    it, model_text, state, arrays, path = found
    total = int(booster._driver.train_data.num_data)
    topo = state.get("topology") or {}
    if int(topo.get("host_count", 1)) > 1:
        _refuse_group(f"resuming {path}, written by "
                      f"{topo.get('host_count')} hosts,")
    stored_rows = int(topo.get("rows", total))
    if stored_rows != total:
        raise ValueError(
            f"checkpoint {path} was taken over {stored_rows} rows "
            f"but the live dataset holds {total}; resume needs the "
            "same training data")
    return it, model_text, state, arrays, path


def restore_checkpoint(booster, manager: CheckpointManager,
                       callbacks=None) -> Optional[Dict]:
    """Restore a booster from the newest valid checkpoint; returns the
    restored state dict (with "iteration") or None when no valid
    checkpoint exists.  The booster must have been constructed with the
    same training data.  A material params mismatch names the differing
    keys: a warning by default, an error under `tpu_resume_strict`."""
    allow_elastic, strict = _resume_flags(booster)
    t_restore = time.perf_counter()
    found = _load_flat(booster, manager)
    if found is None:
        return None
    it, model_text, state, arrays, path = found
    stored_snap = state.get("params_snapshot")
    if stored_snap is not None:
        elastic, material = params_diff(stored_snap,
                                        _params_snapshot(booster.params))
        topo_moves = [c for c in elastic if c[0] in _TOPOLOGY_KEYS]
        if topo_moves and not allow_elastic:
            raise ValueError(
                f"resume topology changed ({_fmt_diff(topo_moves)}) but "
                "tpu_resume_elastic=false refuses re-sharding")
        if material:
            msg = (f"resuming from {path} with different training params "
                   f"({_fmt_diff(material)}); the resumed model will NOT "
                   "be bit-identical to an uninterrupted run")
            if strict:
                raise ValueError(msg + " (tpu_resume_strict=true)")
            Log.warning(msg)
        elif topo_moves:
            Log.info("elastic resume: topology params changed "
                     f"({_fmt_diff(topo_moves)})")
    booster._driver.restore_train_state(model_text, state, arrays)
    booster.best_iteration = int(state.get("best_iteration", -1))
    for cb in callbacks or []:
        key = getattr(cb, "state_key", None)
        restore = getattr(cb, "restore_state", None)
        saved = (state.get("callbacks") or {}).get(str(key)) if key else None
        if saved is not None and callable(restore):
            restore(saved)
    Log.info(f"resumed training from checkpoint {path} "
             f"(iteration {state['iteration']})")
    from .. import obs

    obs.REGISTRY.inc("lgbm_checkpoint_restores_total",
                     help="successful checkpoint restores")
    obs.REGISTRY.observe("lgbm_checkpoint_seconds",
                         time.perf_counter() - t_restore, op="restore")
    obs.event("checkpoint_restored", iteration=int(state["iteration"]))
    return state


def flush_checkpoint(booster, manager: CheckpointManager,
                     callbacks=None) -> Optional[str]:
    """Best-effort final checkpoint (interrupt/exit path): skips when a
    VALID newest checkpoint already covers the current iteration (a torn
    same-iteration bundle must not suppress the flush); never lets a
    checkpoint failure mask the original exception."""
    try:
        cks = manager.checkpoints()
        if cks and cks[0][0] == booster.current_iteration() \
                and manager.validate(cks[0][1]):
            return None
        return save_checkpoint(booster, manager, callbacks=callbacks)
    except BaseException as exc:  # noqa: BLE001 - must not mask the cause
        Log.warning(f"final checkpoint flush failed: "
                    f"{type(exc).__name__}: {exc}")
        return None
