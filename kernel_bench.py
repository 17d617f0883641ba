#!/usr/bin/env python3
"""Time the histogram kernels of lightgbm_tpu_torch on one CUDA card, at
the shapes of the Higgs-1M paths, so that two checkouts of the package
can be compared in one machine.

    python3 kernel_bench.py [--root DIR] [--label NAME] [--sass]

Imports lightgbm_tpu_torch from DIR (default: the directory of this
script), builds its kernels and prints one JSON line per measurement,
each taken with chip_smoke.py's own functions (from this script's
directory, whatever DIR is):
  path     the hilo and the int8 paths, 10 iterations and then 2 more
           under torch.profiler (chip_smoke.profile): each kernel's
           device time per call on the path, the device's busy time and
           idle share, the host's torch ops per iteration and host syncs
           per tree;
  kernel   B1 and B1-int at chip_smoke.py's phase-4 random and root
           operands, B2 at its phase-4 operands: each against its plain
           twin, with its device time per call (chip_smoke.device_ms)
           and its CUDA-event time;
  sass     (--sass) the atomic instructions of each kernel of the built
           library, counted from `cuobjdump -sass`.
To compare two checkouts, run it for each in turn in one call (parent,
change, change, parent), e.g. with the parent unpacked by
`git archive HEAD lightgbm_tpu_torch | tar -x -C build/parent`.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402


def kernels_of(names):
    """The port kernel of each device launch, for either version of the
    package: chip_smoke.port_kernels, and the launches of the version
    before B1 and B2 were redesigned by the call they belong to.  There a
    call began with a slot launch, then a histogram and a reduce launch;
    B2's call added a scan launch."""
    out = cs.port_kernels(names)
    for i, name in enumerate(names):
        if "hist_slot_kernel" not in name:
            continue
        call = names[i:i + 4]
        if len(call) == 4 and "fused_scan_kernel" in call[3]:
            out[i:i + 4] = ["fused_hist_scan"] * 4
        elif len(call) >= 3:
            out[i:i + 3] = ["hist_batched" if "<float" in call[1]
                            else "hist_batched_int"] * 3
    return out


def sass_census(lib_path):
    """{kernel name: {atomic opcode: count}} of a shared library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump: {out.stderr.strip()[:400]}")
    census = {}
    name = None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            census[name] = collections.Counter()
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9_.]+)", line)
        if m and name is not None:
            census[name][m.group(1)] += 1
    return {k: dict(v) for k, v in census.items()}


def kernel_rows(learners, kernels_of):
    """B1 and B1-int at phase 4's random and root operands, then B2 at
    its phase-4 operands, drawn in phase 4's order: each against its
    plain twin (float: counts equal and the largest difference; int and
    B2: bitwise), timed as phase 4 times it."""
    import torch
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops import histogram as H

    gen = torch.Generator(device="cuda").manual_seed(7)
    for precision in ("hilo", "int8"):
        learner = learners[precision]
        for operands in ("random", "root"):
            stats = (cs._hilo_stats(learner, gen)[0] if precision == "hilo"
                     else cs._int8_stats(learner, gen))
            leaf, slots = cs._slots_of(learner, gen, operands)
            args = (learner.bins_t, stats, leaf, slots, learner.num_bins)
            got = H.hist_batched_kernel(*args)
            ref = H.hist_batched_plain(*args)
            if precision == "hilo":
                got, ref = (H._unpack_hist(x.permute(3, 2, 0, 1), "hilo")
                            for x in (got, ref))
                equal = torch.equal(got[..., 2], ref[..., 2])
            else:
                equal = torch.equal(got, ref)
            yield {"name": "hist_batched" if precision == "hilo"
                   else "hist_batched_int", "operands": operands,
                   "equal": equal,
                   "max_abs_err": float((got - ref).abs().max().item()),
                   "ms": cs.device_ms(lambda: H.hist_batched_kernel(*args),
                                      20, kernels_of),
                   "event_ms": cs.cuda_ms(
                       lambda: H.hist_batched_kernel(*args), 20)}
    args, kw = cs._fused_operands(learners["int8"], gen)
    got = fused.fused_hist_scan_kernel(*args, split_kw=kw)
    ref = fused.fused_hist_scan_plain(*args, split_kw=kw)
    yield {"name": "fused_hist_scan", "operands": "random",
           "equal": torch.equal(got[0], ref[0]) and torch.equal(
               got[1].contiguous().view(torch.int32),
               ref[1].contiguous().view(torch.int32)),
           "ms": cs.device_ms(lambda: fused.fused_hist_scan_kernel(
               *args, split_kw=kw), 20, kernels_of),
           "event_ms": cs.cuda_ms(lambda: fused.fused_hist_scan_kernel(
               *args, split_kw=kw), 20)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    label = args.label or os.path.relpath(root, HERE)
    import torch

    def emit(kind, **row):
        print(json.dumps({"label": label, "kind": kind, **row}), flush=True)

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a "
                "card")
    sys.path.insert(0, root)
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import kernels

    if not os.path.abspath(lgb.__file__).startswith(root + os.sep):
        cs.fail(f"imported {lgb.__file__}, not the package under {root}")
    emit("device", smi=cs.smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda)
    kernels.library()
    emit("build", seconds=kernels.build_seconds)
    if args.sass:
        for name in os.listdir(kernels.BUILD_DIR):
            if name.startswith("liblgbt_kernels_") and name.endswith(".so"):
                emit("sass", library=name, census=sass_census(
                    str(kernels.BUILD_DIR / name)))
    X, y = cs.make_data(cs.N_TRAIN, cs.N_FEAT)
    ds = lgb.Dataset(X, label=y, params=dict(cs.PARAMS)).construct()
    learners = {}
    for name, params, _, _ in cs.PATHS[:2]:
        booster = lgb.train(dict(params), ds, num_boost_round=cs.ITERS)
        booster.num_trees()
        emit("path", path=name, **cs.profile(booster,
                                             kernels_of=kernels_of))
        learners[name] = booster._driver.learner
    for row in kernel_rows(learners, kernels_of):
        emit("kernel", **row)


if __name__ == "__main__":
    main()
