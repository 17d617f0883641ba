"""Build, load and count the hand-written CUDA kernels.

The sources live in `lightgbm_tpu_torch/csrc/*.cu`, each with a plain C
interface.  At first use, `library()` compiles every source with its own
`nvcc` process (all started together), links the objects into one shared
library under `build/torch_kernels/` at the repository root, and loads it
with `ctypes`.  The library's file name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads the
library already built.  Nothing here runs at import time: the CPU tests
import every module on a machine without `nvcc`.

`launches` holds one plain integer per kernel.  Each wrapper adds one to
its entry where it launches its kernel, and nowhere else, so a run can
show that its main path went through the kernels.  The sources may share
headers (`csrc/*.cuh`), which the library's hash covers too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: no a*b+c contracts into one rounding, so the kernels' f32
# arithmetic rounds op by op as their PyTorch twins do (kernel B2's split
# records are held bitwise equal to its twin's)
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "--fmad=false", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

# B1 float, B1 integer variant, B1 on packed 4-bit bins and on wide
# (int32) bins (float and integer), B2 and B3 on uint8 and on wide bins,
# B4 in B1's six variants, and the leaf refit's grouping and sums
launches: Dict[str, int] = {"hist_batched": 0, "hist_batched_int": 0,
                            "hist_batched_packed": 0,
                            "hist_batched_packed_int": 0,
                            "hist_batched_wide": 0,
                            "hist_batched_wide_int": 0,
                            "fused_hist_scan": 0,
                            "fused_hist_scan_wide": 0,
                            "partition_rows": 0, "partition_rows_wide": 0,
                            "hist_flat": 0, "hist_flat_int": 0,
                            "hist_flat_packed": 0,
                            "hist_flat_packed_int": 0,
                            "hist_flat_wide": 0, "hist_flat_wide_int": 0,
                            "leaf_group": 0, "leaf_sums": 0}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "lightgbm_tpu_torch need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _build(target: Path) -> str:
    """Compile each source in parallel, link one shared library."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp_"))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(logs))
        so_tmp = tmp / target.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so_tmp),
                *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed\n{res.stdout}\n"
                               + "\n".join(logs))
        os.replace(so_tmp, target)
        return "\n".join(logs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    target = BUILD_DIR / f"liblgbt_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not target.exists():
        build_log = _build(target)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.lgbt_device_limits.argtypes = [ip]
    lib.lgbt_device_limits.restype = i32
    lib.lgbt_hist_batched.argtypes = [vp, i32, i32, vp, i32, vp, vp, vp, vp,
                                      i32, i64, i32, i32, i32, ip, i32, i32,
                                      vp]
    lib.lgbt_hist_batched.restype = i32
    lib.lgbt_hist_clusters.argtypes = [i32, i32, i32, i32, i32, ip]
    lib.lgbt_hist_clusters.restype = i32
    lib.lgbt_fused_clusters.argtypes = [i32, i32, i32, ip]
    lib.lgbt_fused_clusters.restype = i32
    lib.lgbt_fused_hist_scan.argtypes = [vp, i32, i32, vp, i32, *[vp] * 9,
                                         i32, i64, i32, i32, ip,
                                         *[f32] * 6, vp]
    lib.lgbt_fused_hist_scan.restype = i32
    lib.lgbt_partition_rows.argtypes = [vp, i32, i64, *[vp] * 11, i32,
                                        i32, vp]
    lib.lgbt_partition_rows.restype = i32
    lib.lgbt_leaf_group_plan.argtypes = [i64, i32, ip]
    lib.lgbt_leaf_group_plan.restype = i32
    lib.lgbt_leaf_group.argtypes = [vp, vp, i64, i32, vp, vp, vp, ip, vp]
    lib.lgbt_leaf_group.restype = i32
    lib.lgbt_leaf_sums.argtypes = [vp, vp, vp, i32, vp]
    lib.lgbt_leaf_sums.restype = i32
    lib.lgbt_error_string.argtypes = [i32]
    lib.lgbt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().lgbt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
