"""Atomic iteration-granular training checkpoints, on one host or a host
group.

The port of `lightgbm_tpu/utils/checkpoint.py`, in its bundle and group
formats, so a bundle or a group written by either package resumes in the
other.  A checkpoint is one directory (``ckpt-<iteration>``) holding the
full restart bundle:

* ``model.txt``   — the model string with its ``tpu_bin_mappers:`` and
  ``pandas_categorical:`` trailers (the bytes ``save_model`` writes),
  so trees rebind into bin space exactly on restore;
* ``state.json``  — the driver's non-array training state
  (`models/gbdt.py:capture_train_state`: the iteration counter, the
  threefry key words, the numpy bit-generator states, the
  boost-from-average flags, early stopping's state, the params
  snapshot and fingerprint, the topology), written with ``sort_keys``;
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

The host group: in a `torch.distributed` group of several processes
every process writes its own bundle into ``host-<k>/ckpt-<iteration>``
under the shared root, then all barrier on an all-gather of their
(iteration, manifest CRC, local rows) triples (`checkpoint_barrier`),
and process 0 alone commits ``global-<iteration>.json`` at the root
(host count, per-host CRCs and rows, the shard topology, the params
fingerprint).  Resume walks the group manifests newest-first and skips
torn or mixed-iteration sets; without a committed group the hosts agree
on their newest common valid bundle.  Elastic resume: the score buffers
are (or reassemble, in process order, to) global f32 row buffers, and
every random stream keys on global state, so a checkpoint taken at P
shards or hosts resumes at P' (1 included), re-sliced for the live
partition (`parallel.mesh.local_row_offset`).
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


class CheckpointManager:
    """Atomic write + validated read + keep-last-N retention over one
    checkpoint directory.

    ``host_count > 1`` switches to the multihost layout: this host's
    bundles live under ``<root>/host-<host_index>/`` and group commits
    (`commit_global`) land ``global-<iteration>.json`` manifests at the
    root.  Single-host managers keep the flat single-host layout byte-for-byte.
    """

    def __init__(self, directory: str, keep: int = 3,
                 host_index: int = 0, host_count: int = 1):
        if not directory:
            raise ValueError("checkpoint directory must be non-empty")
        self.root = str(directory)
        self.host_index = int(host_index)
        self.host_count = max(int(host_count), 1)
        self.directory = (self.root if self.host_count == 1
                          else self.host_dir(self.host_index))
        self.keep = max(int(keep), 1)
        os.makedirs(self.directory, exist_ok=True)

    def host_dir(self, host: int) -> str:
        return os.path.join(self.root, f"{_HOST_PREFIX}{int(host):05d}")

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
            import io as _io

            with obs.span("checkpoint/save", iteration=int(iteration)):
                payloads: Dict[str, bytes] = {
                    "model.txt": model_text.encode("utf-8"),
                    "state.json": json.dumps(state, sort_keys=True).encode(),
                }
                buf = _io.BytesIO()
                np.savez(buf, **arrays)
                payloads["arrays.npz"] = buf.getvalue()
                manifest = {"format": FORMAT_VERSION,
                            "iteration": int(iteration), "files": {}}
                for name, data in payloads.items():
                    # the manifest records the INTENDED bytes: an
                    # injected (or real) torn write then fails CRC
                    # validation exactly like a crash mid-write would
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
        # rare, durable, worth counting unconditionally: write wall +
        # bundle count beside the train metrics
        obs.REGISTRY.inc("lgbm_checkpoint_writes_total",
                         help="atomic checkpoint bundles committed")
        obs.REGISTRY.observe("lgbm_checkpoint_seconds",
                             time.perf_counter() - t0, op="save")
        obs.event("checkpoint_saved", iteration=int(iteration))
        return final

    def _retain(self) -> None:
        """Keep the newest `keep` checkpoints; drop older ones and any
        stale temp directories.  Deletions run OLDEST-first: a SIGTERM
        (or any interrupt) landing mid-prune then leaves extra OLD
        bundles behind — recoverable clutter — and can never have
        touched the newest valid bundle, which is excluded from the
        deletion list by construction."""
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

    # -- multihost group commit + read ---------------------------------
    def manifest_crc(self, path: str) -> Optional[int]:
        """CRC32 of a bundle's manifest bytes — the durable identity a
        host proves at the commit barrier (the manifest itself CRCs
        every payload file, so this one word covers the bundle)."""
        try:
            with open(os.path.join(path, MANIFEST), "rb") as f:
                return zlib.crc32(f.read())
        except OSError:
            return None

    def _default_barrier(self, vec: np.ndarray) -> List[np.ndarray]:
        """All-hosts-durable barrier: allgather each host's commit
        triple, under the collective watchdog."""
        if self.host_count == 1:
            return [vec]
        from ..parallel.topology import host_allgather

        out = host_allgather(np.asarray(vec), name="checkpoint_barrier")
        return [np.asarray(row) for row in np.asarray(out)]

    def commit_global(self, iteration: int, topology: Optional[Dict] = None,
                      rows: int = 0, params_fingerprint: int = 0,
                      barrier=None) -> Optional[str]:
        """Barrier on every host's durable local bundle, then commit the
        group manifest (rank 0 only; returns its path there, None on
        other ranks).  Refuses — without writing — when any host reports
        a torn bundle or a different iteration (a mixed/torn set must
        never look committed).  A host with a torn LOCAL bundle still
        ENTERS the barrier, contributing a sentinel — raising before the
        allgather would strand every healthy peer inside it, the exact
        hang this layer exists to eliminate; the sentinel makes the
        whole group refuse symmetrically instead.  `barrier` is
        injectable for single-process tests simulating a host group."""
        local = os.path.join(self.directory, self._name(iteration))
        crc = self.manifest_crc(local)
        torn = crc is None or not self.validate(local)
        vec = np.asarray([-1 if torn else int(iteration),
                          int(crc or 0), int(rows)], np.int64)
        entries = [np.asarray(e).reshape(-1)
                   for e in (barrier or self._default_barrier)(vec)]
        if len(entries) != self.host_count:
            raise ValueError(
                f"checkpoint barrier returned {len(entries)} entries for "
                f"{self.host_count} hosts")
        iters = sorted({int(e[0]) for e in entries})
        if -1 in iters:
            bad = [k for k, e in enumerate(entries) if int(e[0]) == -1]
            raise ValueError(
                f"host(s) {bad} reported a torn/missing local bundle at "
                f"iteration {iteration}; refusing the global commit")
        if iters != [int(iteration)]:
            raise ValueError(
                "mixed-iteration checkpoint set across hosts "
                f"(iterations {iters}); refusing the global commit")
        if self.host_index != 0:
            return None
        manifest = {
            "format": FORMAT_VERSION,
            "iteration": int(iteration),
            "host_count": int(self.host_count),
            "hosts": [{"index": k, "crc": int(e[1]), "rows": int(e[2])}
                      for k, e in enumerate(entries)],
            "params_fingerprint": int(params_fingerprint),
            "topology": dict(topology or {}),
        }
        name = f"{_GLOBAL_PREFIX}{int(iteration):08d}.json"
        tmp = os.path.join(self.root, f".tmp-{name}-{os.getpid()}")
        _write_file(tmp, json.dumps(manifest, sort_keys=True).encode())
        os.replace(tmp, os.path.join(self.root, name))
        _fsync_dir(self.root)
        self._retain_global()
        from .. import obs

        obs.REGISTRY.inc("lgbm_checkpoint_commits_total",
                         help="group manifests committed (rank 0)")
        obs.event("checkpoint_group_committed", iteration=int(iteration),
                  host_count=int(self.host_count))
        return os.path.join(self.root, name)

    def group_manifests(self) -> List[Tuple[int, str]]:
        """(iteration, path) of every global manifest, newest first."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            if not (name.startswith(_GLOBAL_PREFIX)
                    and name.endswith(".json")):
                continue
            try:
                it = int(name[len(_GLOBAL_PREFIX):-len(".json")])
            except ValueError:
                continue
            out.append((it, os.path.join(self.root, name)))
        out.sort(reverse=True)
        return out

    def _retain_global(self) -> None:
        for it, path in reversed(self.group_manifests()[self.keep:]):
            try:
                os.unlink(path)
            except OSError:
                pass
        # stale manifest temps from a commit interrupted between write
        # and rename — harmless debris, but unbounded across preemptions
        try:
            for name in os.listdir(self.root):
                if name.startswith(f".tmp-{_GLOBAL_PREFIX}"):
                    os.unlink(os.path.join(self.root, name))
        except OSError:
            pass

    def host_bundle_path(self, host: int, iteration: int,
                         host_count: Optional[int] = None) -> str:
        """Bundle dir of `host` at `iteration` under the STORED layout
        (flat when the checkpoint was single-host)."""
        hc = self.host_count if host_count is None else int(host_count)
        base = self.root if hc == 1 else self.host_dir(host)
        return os.path.join(base, self._name(iteration))

    def validate_group(self, manifest: Dict) -> bool:
        """Every host bundle the manifest lists is present, CRC-matched,
        and at the manifest's iteration — the torn/mixed-set gate.  The
        WHOLE walk is exception-guarded: a malformed manifest (hosts not
        a list, entries missing keys) must read as invalid and be
        skipped with a warning upstream, never crash the resume."""
        try:
            it = int(manifest["iteration"])
            hc = int(manifest["host_count"])
            hosts = manifest["hosts"]
            if len(hosts) != hc:
                return False
            for entry in hosts:
                path = self.host_bundle_path(int(entry["index"]), it,
                                             host_count=hc)
                if self.manifest_crc(path) != int(entry["crc"]):
                    return False
                if not self.validate(path):
                    return False
        except (KeyError, TypeError, ValueError, AttributeError):
            return False
        return True

    def load_latest_group(self) -> Optional[Tuple[int, Dict]]:
        """Newest fully-valid committed group as (iteration, manifest);
        torn/partial/mixed groups are skipped with a warning."""
        for it, path in self.group_manifests():
            try:
                with open(path) as f:
                    manifest = json.load(f)
            except (OSError, ValueError) as exc:
                Log.warning(f"skipping unreadable group manifest {path}: "
                            f"{exc}")
                continue
            if not self.validate_group(manifest):
                Log.warning(
                    f"skipping torn/partial checkpoint group {path}: a "
                    "host bundle is missing, corrupt, or at a different "
                    "iteration")
                continue
            return it, manifest
        return None


# ---------------------------------------------------------------------------
# Booster-level bundle assembly
# ---------------------------------------------------------------------------
def make_manager(directory: str, keep: int = 3) -> CheckpointManager:
    """CheckpointManager bound to this process's position in the live
    host group (flat single-host layout when the group is 1)."""
    from ..parallel.topology import process_count, process_index

    return CheckpointManager(directory, keep=keep,
                             host_index=int(process_index()),
                             host_count=int(process_count()))


def _params_snapshot(params: Dict) -> Dict[str, str]:
    """Canonical-keyed stringified params — stored in the bundle so a
    mismatch at resume can NAME the differing keys, not just a
    fingerprint inequality."""
    from ..config import canonical_name

    out: Dict[str, str] = {}
    for k, v in (params or {}).items():
        canon = canonical_name(str(k)) or str(k)
        out[canon] = str(v)
    return out


def _params_fingerprint(params: Dict) -> int:
    """Stable fingerprint of the training params a bitwise resume
    depends on.  Topology/operational keys (`ELASTIC_PARAMS`) are
    excluded: resharding P -> P' must not read as a params change."""
    snap = {k: v for k, v in _params_snapshot(params).items()
            if k not in ELASTIC_PARAMS}
    return zlib.crc32(json.dumps(snap, sort_keys=True).encode())


def _params_fingerprint_legacy(params: Dict) -> int:
    """The older fingerprint (all params, raw keys), which bundles written
    before the params snapshot carry."""
    try:
        text = json.dumps({str(k): str(v) for k, v in params.items()},
                          sort_keys=True)
    except (TypeError, ValueError):
        text = str(sorted(str(k) for k in params))
    return zlib.crc32(text.encode())


def params_diff(stored: Dict[str, str], live: Dict[str, str]
                ) -> Tuple[List[Tuple[str, str, str]],
                           List[Tuple[str, str, str]]]:
    """Key-level diff of two params snapshots as (elastic_changes,
    material_changes), each a list of (key, stored_value, live_value)
    with "<unset>" marking absence.  Elastic changes are topology moves
    the bitwise-resume contract absorbs; material changes break it."""
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
    already-validated Config — no re-parsing of the raw params dict.
    Registry defaults apply for drivers without a training config
    (they cannot restore anyway; restore_train_state raises)."""
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
                    callbacks=None, barrier=None) -> str:
    """Write one atomic checkpoint of a live training booster.  In a
    multihost group the local bundle is followed by the all-hosts-
    durable barrier and rank 0's global-manifest commit."""
    state, arrays = booster._driver.capture_train_state()
    state["best_iteration"] = int(booster.best_iteration)
    state["params_fingerprint"] = _params_fingerprint(booster.params)
    state["params_snapshot"] = _params_snapshot(booster.params)
    cb_states = _callback_states(callbacks)
    if cb_states:
        state["callbacks"] = cb_states
    model_text = booster.model_to_string(num_iteration=-1)
    path = manager.save(state["iteration"], model_text, state, arrays)
    if manager.host_count > 1:
        topo = dict(state.get("topology") or {})
        manager.commit_global(
            state["iteration"], topology=topo,
            rows=int(topo.get("rows", 0)),
            params_fingerprint=state["params_fingerprint"],
            barrier=barrier)
    return path


# params whose change is a TOPOLOGY move — the set `tpu_resume_elastic=
# false` refuses (the broader ELASTIC_PARAMS also holds operational
# knobs like verbosity that no mode should refuse)
_TOPOLOGY_KEYS = frozenset({
    "tree_learner", "num_machines", "machines", "machine_list_filename",
    "pre_partition", "tpu_feature_shards", "tpu_hist_agg",
})


def _live_partition(booster) -> Tuple[bool, int, int, int]:
    """(partitioned, local_rows, global_offset, global_rows) of the
    live training context.  Replicated/single-process ingest holds the
    full global rows locally, so offset 0 and total == local."""
    drv = booster._driver
    local_n = int(drv.train_data.num_data)
    partitioned = bool(getattr(drv.learner, "_partitioned", False))
    if partitioned:
        from ..parallel.mesh import local_row_offset

        offset, total = local_row_offset(local_n)
    else:
        offset, total = 0, local_n
    return partitioned, local_n, offset, total


def _slice_rows(arrays: Dict, offset: int, local_n: int) -> Dict:
    """Re-shard GLOBAL row buffers to this process's live slice.  Valid-
    set score buffers are left as-is: `restore_train_state` replays any
    whose length no longer matches its live valid set."""
    out = dict(arrays)
    a = out.get("train_scores")
    if a is not None and a.shape[1] != local_n:
        out["train_scores"] = np.ascontiguousarray(
            a[:, offset:offset + local_n])
    m = out.get("bag_mask")
    if m is not None and m.shape[0] != local_n:
        out["bag_mask"] = np.ascontiguousarray(m[offset:offset + local_n])
    return out


def _uncommitted_group_agreement(manager: CheckpointManager
                                 ) -> Tuple[int, bool]:
    """(min-common locally-valid iteration, mixed) across the host
    group, agreed over barriers of each host's local bundle state.
    `manager.directory` already IS this host's bundle dir, so the local
    walk uses the manager directly.

    Two symmetric rounds: (1) gather each host's NEWEST valid
    iteration and take the min; (2) gather whether every host holds a
    VALID bundle at exactly that min — host k's newest being N does not
    imply its older bundle at min(N') is intact, and discovering that
    asymmetrically (one rank raising while peers load and train) would
    desync the group.  Both rounds' inputs/outputs are identical on all
    ranks, so every host raises or proceeds together.  `mixed` marks
    the impossible-to-agree case: some host holds bundles while another
    holds none (its state is locally unrecoverable)."""
    newest = -1
    for cand_it, cand_path in manager.checkpoints():
        if manager.validate(cand_path):
            newest = cand_it
            break
    entries = [int(np.asarray(e).reshape(-1)[0])
               for e in manager._default_barrier(
                   np.asarray([newest, 0, 0], np.int64))]
    lo, hi = min(entries), max(entries)
    if lo < 0:
        return -1, hi >= 0
    mine_ok = int(manager.validate(
        os.path.join(manager.directory, manager._name(lo))))
    oks = [int(np.asarray(e).reshape(-1)[0])
           for e in manager._default_barrier(
               np.asarray([mine_ok, 0, 0], np.int64))]
    if not all(oks):
        bad = [k for k, ok in enumerate(oks) if not ok]
        raise ValueError(
            f"uncommitted multihost resume agreed on iteration {lo} but "
            f"host(s) {bad} hold no valid bundle there; the group "
            "cannot resume consistently — clear the checkpoint dir to "
            "start fresh everywhere")
    return lo, False


def _peek_bundle_state(manager: CheckpointManager, iteration: int
                       ) -> Dict:
    """This host's bundle state.json at `iteration`, {} when unreadable
    — a cheap metadata peek (no model/array IO)."""
    return _read_json(os.path.join(manager.directory,
                                   CheckpointManager._name(iteration),
                                   "state.json"))


def _uncommitted_group_resume(manager: CheckpointManager, target: int
                              ) -> Tuple[int, str, Dict, Dict, str]:
    """Load this host's bundle at the group-agreed min-common
    iteration (a set whose global manifest never committed — e.g. the
    final flush's barrier died with a peer).  Validity at `target` was
    already barriered by the agreement; a failure here is a race since
    that check and still raises (every peer hit the same agreement)."""
    path = os.path.join(manager.directory, manager._name(target))
    if not manager.validate(path):
        raise ValueError(
            f"uncommitted multihost resume agreed on iteration {target} "
            f"but this host's bundle {path} is missing or torn; the "
            "group cannot resume consistently")
    Log.warning(
        "no committed checkpoint group at or above this iteration; "
        f"resuming from the group's min-common local iteration {target}")
    model_text, state, arrays = manager._read_bundle(path)
    return target, model_text, state, arrays, path


def _load_for_topology(booster, manager: CheckpointManager,
                       allow_elastic: bool
                       ) -> Optional[Tuple[int, str, Dict, Dict, str]]:
    """Newest restorable checkpoint resolved against the LIVE topology.

    * A committed group at the live host count: each host reads its own
      bundle (local slices already match the live partition).
    * A committed group at a DIFFERENT host count (elastic): reassemble
      the global row buffers from every host bundle in process order,
      then re-slice for the live partition.
    * No group manifests: the flat single-host layout loads directly —
      also the device-shard elastic path, since flat arrays are already
      global — re-sliced when the live ingest is partitioned.
    * Multihost manager but no committed group (e.g. the final flush's
      barrier timed out on a dead peer): the hosts AGREE on the
      min-common locally-valid iteration over a barrier — per-host
      "newest local bundle" choices would restore different iterations
      and desync every subsequent collective.
    """
    # ---- pick the NEWEST durable source, not the first that exists:
    # a committed group, an uncommitted-but-agreed per-host set, and a
    # flat root checkpoint can all coexist (e.g. a pod run committed at
    # iteration 6, was elastically resumed single-host to iteration 9,
    # and died again) — resuming the committed group unconditionally
    # would silently discard the newer durable progress.  A committed
    # group takes equal-iteration ties (it is the coordinated record).
    group = manager.load_latest_group()
    group_it = group[0] if group is not None else -1
    flat_mgr = (manager if manager.host_count == 1
                else CheckpointManager(manager.root, keep=manager.keep))
    flat_it = next((cit for cit, cpath in flat_mgr.checkpoints()
                    if flat_mgr.validate(cpath)), -1)
    agreed_it, mixed = -1, False
    if manager.host_count > 1:
        # the agreement barrier runs UNCONDITIONALLY on every multihost
        # resume: whether its result is used depends only on shared
        # root state, so every rank still enters the same collectives
        # in the same order
        agreed_it, mixed = _uncommitted_group_agreement(manager)
    if agreed_it >= 0:
        # an uncommitted set is only usable at its ORIGINAL host count:
        # without a committed manifest there is no coordinated record
        # of the old partition to re-shard from, so a topology change
        # falls back to the newest committed/flat source instead of
        # handing each live host a stale slice (every bundle records
        # the same host_count, so this local peek is group-consistent)
        stored_hc = int((_peek_bundle_state(manager, agreed_it)
                         .get("topology") or {})
                        .get("host_count", manager.host_count))
        if stored_hc != manager.host_count:
            msg = (
                f"newest uncommitted checkpoint set (iteration "
                f"{agreed_it}) was written by {stored_hc} host(s) but "
                f"the live group has {manager.host_count}; it cannot be "
                "re-sharded without a committed manifest — restart with "
                f"{stored_hc} hosts to recover iteration {agreed_it}")
            if group_it < 0 and flat_it < 0:
                # nothing to fall back to: refuse rather than silently
                # train from scratch over recoverable state
                raise ValueError(msg)
            Log.warning(msg + "; falling back to an older "
                        "committed/flat checkpoint")
            agreed_it = -1

    if group_it < 0 and agreed_it < 0 and flat_it < 0:
        if mixed:
            raise ValueError(
                "uncommitted multihost checkpoint set: some host has no "
                "valid local bundle and no committed group or flat "
                "checkpoint exists; the group cannot resume "
                "consistently — clear the checkpoint dir to start "
                "fresh everywhere")
        return None

    if agreed_it > group_it and agreed_it >= flat_it:
        return _uncommitted_group_resume(manager, agreed_it)

    if flat_it > group_it and flat_it > agreed_it:
        if manager.host_count > 1 and not allow_elastic:
            raise ValueError(
                "checkpoint was written single-host but the live group "
                f"has {manager.host_count} hosts; set tpu_resume_elastic"
                "=true to re-shard on load")
        flat = flat_mgr.load_latest()
        if flat is None:  # raced away since the peek; nothing newer
            return None
        it, model_text, state, arrays, path = flat
        partitioned, local_n, offset, total = _live_partition(booster)
        stored_rows = int((state.get("topology") or {}).get("rows",
                                                            total))
        if stored_rows != total:
            raise ValueError(
                f"checkpoint {path} was taken over {stored_rows} rows "
                f"but the live dataset holds {total}; resume needs the "
                "same training data")
        return it, model_text, state, _slice_rows(arrays, offset,
                                                  local_n), path

    it, manifest = group
    stored_hc = int(manifest["host_count"])
    if stored_hc == manager.host_count:
        path = manager.host_bundle_path(manager.host_index, it)
        try:
            model_text, state, arrays = manager._read_bundle(path)
        except (OSError, ValueError, KeyError) as exc:
            # returning None would train THIS rank from scratch while
            # its peers resume at iteration `it` — a guaranteed
            # collective desync; fail loud instead
            raise ValueError(
                f"committed checkpoint bundle {path} is unreadable "
                f"({exc}); refusing to restart this rank from zero "
                f"while its peers resume iteration {it}") from exc
        return it, model_text, state, arrays, path
    if not allow_elastic:
        raise ValueError(
            f"checkpoint group was written by {stored_hc} hosts but the "
            f"live group has {manager.host_count}; set "
            "tpu_resume_elastic=true to re-shard on load")
    # ---- elastic host-count change: reassemble global row buffers ----
    hosts = sorted(manifest["hosts"], key=lambda e: int(e["index"]))
    bundles = []
    for entry in hosts:
        path = manager.host_bundle_path(int(entry["index"]), it,
                                        host_count=stored_hc)
        bundles.append(manager._read_bundle(path))
    model_text, state, _ = bundles[0]
    stored_partitioned = bool(
        (state.get("topology") or {}).get("partitioned", stored_hc > 1))
    if stored_partitioned:
        arrays: Dict = {}
        arrays["train_scores"] = np.concatenate(
            [b[2]["train_scores"] for b in bundles], axis=1)
        masks = [b[2].get("bag_mask") for b in bundles]
        if all(m is not None for m in masks):
            arrays["bag_mask"] = np.concatenate(masks, axis=0)
        # per-host valid slices of the OLD partition cannot be
        # reassembled against the new valid sets: replay handles them
    else:
        # replicated ingest: every host already holds the global arrays
        arrays = dict(bundles[0][2])
    partitioned, local_n, offset, total = _live_partition(booster)
    stored_total = int(sum(int(e.get("rows", 0)) for e in hosts)) \
        or arrays["train_scores"].shape[1]
    if arrays["train_scores"].shape[1] != total:
        raise ValueError(
            f"checkpoint group covers {stored_total} global rows but the "
            f"live dataset holds {total}; elastic resume needs the same "
            "training data in the same global row order")
    Log.info(f"elastic resume: re-sharding checkpoint group at iteration "
             f"{it} from {stored_hc} host(s) to {manager.host_count}")
    return it, model_text, state, _slice_rows(arrays, offset,
                                              local_n), \
        manager.host_bundle_path(0, it, host_count=stored_hc)


def restore_checkpoint(booster, manager: CheckpointManager,
                       callbacks=None) -> Optional[Dict]:
    """Restore a booster from the newest valid checkpoint; returns the
    restored state dict (with "iteration") or None when no valid
    checkpoint exists.  The booster must have been constructed with the
    same training DATA as the checkpointed run; the shard/host topology
    may differ (elastic resume — global buffers are re-sliced for the
    live mesh and the bitwise contract holds for quantized precisions).
    A MATERIAL params mismatch names the differing keys: a warning by
    default, an error under `tpu_resume_strict`."""
    allow_elastic, strict = _resume_flags(booster)
    t_restore = time.perf_counter()
    found = _load_for_topology(booster, manager, allow_elastic)
    if found is None:
        return None
    it, model_text, state, arrays, path = found
    stored_snap = state.get("params_snapshot")
    if stored_snap is not None:
        elastic, material = params_diff(stored_snap,
                                        _params_snapshot(booster.params))
        topo_moves = [c for c in elastic if c[0] in _TOPOLOGY_KEYS]
        # the topology refusal must run regardless of what ELSE changed:
        # a co-occurring material diff must not smuggle a refused
        # re-shard past tpu_resume_elastic=false
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
                     f"({_fmt_diff(topo_moves)}); scores are global "
                     "buffers, so the bitwise contract holds for "
                     "quantized precisions")
    elif state.get("params_fingerprint") not in (
            None, _params_fingerprint_legacy(booster.params)):
        Log.warning(
            f"resuming from {path} with different training params; the "
            "resumed model will NOT be bit-identical to an uninterrupted "
            "run")
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
                     callbacks=None, barrier=None) -> Optional[str]:
    """Best-effort final checkpoint (interrupt/exit path): skips when a
    VALID newest checkpoint already covers the current iteration (a torn
    same-iteration bundle must not suppress the flush); never lets a
    checkpoint failure mask the original exception.  In a multihost
    group, a locally-covered iteration whose GLOBAL manifest never
    committed (e.g. the barrier died with a peer) retries the commit —
    and when even that fails, the durable LOCAL bundle still supports
    the per-host fallback resume.  Whether the group committed is
    decided on process 0's view, gathered over the barrier: it writes
    the manifest, so a peer that looks at the root right after the
    commit's barrier may not see it yet, and a peer retrying the commit
    alone would enter a collective its group never enters."""
    try:
        cks = manager.checkpoints()
        if cks and cks[0][0] == booster.current_iteration() \
                and manager.validate(cks[0][1]):
            if manager.host_count > 1:
                committed = any(it == cks[0][0] and
                                manager.validate_group(_read_json(p))
                                for it, p in manager.group_manifests())
                views = (barrier or manager._default_barrier)(
                    np.asarray([int(committed), 0, 0], np.int64))
                committed = bool(int(np.asarray(views[0]).reshape(-1)[0]))
                if not committed:
                    topo = booster._driver.topology_snapshot()
                    manager.commit_global(
                        cks[0][0], topology=topo,
                        rows=int(topo.get("rows", 0)),
                        params_fingerprint=_params_fingerprint(
                            booster.params),
                        barrier=barrier)
            return None
        return save_checkpoint(booster, manager, callbacks=callbacks,
                               barrier=barrier)
    except BaseException as exc:  # noqa: BLE001 - must not mask the cause
        Log.warning(f"final checkpoint flush failed: "
                    f"{type(exc).__name__}: {exc}")
        return None


def _read_json(path: str) -> Dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}
