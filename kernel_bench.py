#!/usr/bin/env python3
"""Time the kernels of lightgbm_tpu_torch on one CUDA card, at the shapes
of the Higgs-1M paths, so that two checkouts of the package can be
compared in one machine.

    python3 kernel_bench.py [--root DIR] [--label NAME] [--sass]
                            [--rows all|leaf]

Imports lightgbm_tpu_torch from DIR (default: the directory of this
script), builds its kernels and prints one JSON line per measurement,
each taken with chip_smoke.py's own functions (from this script's
directory, whatever DIR is):
  path     the hilo, int8, flat, wide, wide_int8 and wide_flat paths,
           10 iterations and then 2 more under torch.profiler
           (chip_smoke.profile): each kernel's device time per call on
           the path, the device's busy time and idle share, the host's
           torch ops per iteration and host syncs per tree;
  kernel   B1 and B4 in all twelve instances (uint8, packed and wide,
           float and int) at chip_smoke.py's phase-4 random and root
           operands, B2 and B2-wide at random and root operands, B3 and
           B3-wide: each against its plain twin, with its device time
           per call (chip_smoke.device_ms) and its CUDA-event time, and
           for the wide instances the cluster plan (blocks a cluster,
           walks of each entry); and the leaf refit's sums at
           chip_smoke.py's uniform and skewed phase-4 operands (bitwise
           against index_add_ on the CPU): the whole call's device time,
           its sums kernel's and its grouping kernel's, beside the floor
           of the largest leaf's chain;
  leaf     the int8, multiclass_int8, efb_int8 and mono_int8 paths, 10
           iterations (their iterations a second, from the host's
           clock) and then 2 more under torch.profiler: each leaf
           refit kernel's device time per call on the path, beside the
           mean floor of the profiled trees (each tree's largest leaf);
  sass     (--sass) the atomic instructions of each kernel of the built
           library, counted from `cuobjdump -sass`.
`--rows leaf` takes the leaf refit's rows alone (its kernel rows and
leaf paths).  To compare two checkouts, run it for each in turn in one
call (parent, change, change, parent), e.g. with the parent unpacked by
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
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402


def kernels_of(names):
    """The port kernel of each device launch, for either version of the
    package: chip_smoke.port_kernels, and B4's one launch a call before
    it became the grouped body (`hist_flat_kernel`).  Every kernel here
    makes one launch a call in both versions."""
    return ["hist_flat" if "hist_flat_kernel" in name else label
            for name, label in zip(names, cs.port_kernels(names))]


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


# the paths profiled (10 iterations, then 2 under torch.profiler); the
# others train one iteration for their learner's operands
PROFILED = ("hilo", "int8", "flat", "wide", "wide_int8", "wide_flat")
# (row name, path whose learner gives the operands, B4 or B1): every
# instance of B1 and B4, uint8, packed and wide, float and int
HIST_ROWS = [
    ("hist_batched", "hilo", False), ("hist_batched_int", "int8", False),
    ("hist_flat", "flat", True), ("hist_flat_int", "flat_int8", True),
    ("hist_batched_packed", "packed", False),
    ("hist_batched_packed_int", "packed_int8", False),
    ("hist_flat_packed", "packed_flat", True),
    ("hist_flat_packed_int", "packed_flat_int8", True),
    ("hist_batched_wide", "wide", False),
    ("hist_batched_wide_int", "wide_int8", False),
    ("hist_flat_wide", "wide_flat", True),
    ("hist_flat_wide_int", "wide_flat_int8", True)]


def wide_plan(learner, S, floats, scan=False, flat=False):
    """chip_smoke's plan fields (cluster, walks, ...) where the package
    under test has the cluster plan, else {}."""
    from lightgbm_tpu_torch.ops import histogram as H

    if not hasattr(H, "call_plan"):
        return {}
    return cs._wide_plan(learner, S, floats, scan=scan, flat=flat)


def kernel_rows(learners, kernels_of):
    """B1 and B4 in every instance at phase 4's random and root
    operands, B2 (uint8 and wide) at random and root operands and B3:
    each against its plain twin (float: counts equal and the largest
    difference; int, B2 and B3: bitwise), timed as phase 4 times it."""
    import torch
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops import histogram as H

    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, path, flat in HIST_ROWS:
        learner = learners[path]
        wrapper = H.hist_flat_kernel if flat else H.hist_batched_kernel
        floats = not name.endswith("_int")
        pb = learner.packed_block
        for operands in ("random", "root"):
            stats = (cs._hilo_stats(learner, gen)[0] if floats
                     else cs._int8_stats(learner, gen))
            leaf, slots = cs._slots_of(learner, gen, operands)
            args = (learner.bins_t, stats, leaf, slots, learner.num_bins)
            got = wrapper(*args, packed_block=pb)
            ref = H.hist_batched_plain(*args, pb)
            if floats:
                got, ref = (H._unpack_hist(x.permute(3, 2, 0, 1), "hilo")
                            for x in (got, ref))
                equal = torch.equal(got[..., 2], ref[..., 2])
            else:
                equal = torch.equal(got, ref)
            yield {"name": name, "operands": operands, "equal": equal,
                   "max_abs_err": float((got - ref).abs().max().item()),
                   **wide_plan(learner, stats.shape[0], floats, flat=flat),
                   "ms": cs.device_ms(
                       lambda: wrapper(*args, packed_block=pb), 20,
                       kernels_of),
                   "event_ms": cs.cuda_ms(
                       lambda: wrapper(*args, packed_block=pb), 20)}
    for path in ("hilo", "wide"):
        row = cs.check_partition(learners[path], gen)  # fails unless bitwise
        yield {"name": row["name"], "operands": "random", "equal": True,
               "ms": row["ms"], "event_ms": row["event_ms"]}
    for name, path in (("fused_hist_scan", "int8"),
                       ("fused_hist_scan_wide", "wide_int8")):
        for operands in ("random", "root"):
            args, kw = cs._fused_operands(learners[path], gen,
                                          root=operands == "root")
            got = fused.fused_hist_scan_kernel(*args, split_kw=kw)
            ref = fused.fused_hist_scan_plain(*args, split_kw=kw)

            def call():
                return fused.fused_hist_scan_kernel(*args, split_kw=kw)

            yield {"name": name, "operands": operands,
                   "equal": torch.equal(got[0], ref[0]) and torch.equal(
                       got[1].contiguous().view(torch.int32),
                       ref[1].contiguous().view(torch.int32)),
                   **wide_plan(learners[path], 3, False, scan=True),
                   "ms": cs.device_ms(call, 20, kernels_of),
                   "event_ms": cs.cuda_ms(call, 20)}


def leaf_rows(learner):
    """The leaf refit's sums at chip_smoke's uniform and skewed phase-4
    operands (the same draws for every package: a generator of its own),
    bitwise against index_add_ on the CPU: the whole call's device time
    (ms), its sums kernel's (kernel_ms) and its grouping kernel's
    (group_ms; None for a package without one), and CUDA events around
    20 calls (event_ms, which reads the host's time where a call is
    shorter than its wrapper), beside the floor."""
    import torch
    from lightgbm_tpu_torch.ops import leafsum

    def only(part):
        return lambda names: [part if part in name else None
                              for name in names]

    gen = torch.Generator(device="cuda").manual_seed(7)
    mhz = cs.sm_clock_mhz()
    for operands in ("uniform", "skewed"):
        leaf, vals, L = cs._leaf_operands(learner, gen, operands)

        def call():
            return leafsum.leaf_sums_kernel(leaf, vals, L)

        equal = torch.equal(call().cpu(), leafsum.leaf_sums_plain(
            leaf.cpu(), vals.cpu(), L))
        ids = leaf.long()
        out = torch.zeros(L, device=leaf.device)
        longest = int(torch.bincount(ids, minlength=L).max().item())
        floor, chain = cs.leaf_sums_floor(leaf.numel(), L, longest, mhz)
        kernel_ms = cs.device_ms(call, 20, only("leaf_sums_kernel"))
        if hasattr(leafsum, "leaf_group_kernel"):
            # the call is the two kernels' launches
            group_ms = cs.device_ms(call, 20, only("leaf_group_kernel"))
            ms = group_ms + kernel_ms
        else:
            # the sort, gather and searchsorted around the kernel: the
            # device time seen over the calls
            group_ms = None
            ms = cs.device_ms(call, 20, kernels_of=lambda names: [
                "all"] * len(names), launches=None)
        yield {"name": "leaf_sums", "operands": operands, "equal": equal,
               "largest_leaf_rows": longest, "floor_ms": floor,
               "chain_ms": chain, "ms": ms, "kernel_ms": kernel_ms,
               "group_ms": group_ms, "event_ms": cs.cuda_ms(call, 20),
               "library_ms": cs.cuda_ms(
                   lambda: (out.index_add_(0, ids, vals[0]),
                            out.index_add_(0, ids, vals[1])), 5)}


def leaf_paths(lgb, int8_ds, X, y, w, kernels_of):
    """The paths whose trees refit their leaves, with the largest
    leaves: (name, booster, iterations a second of its training, its
    profile) of int8 on int8_ds, multiclass_int8 (its
    rows relabelled at the latent's quintiles), mono_int8 (its own
    Dataset, the constraints being a Dataset parameter) and efb_int8
    (the sparse table), each trained chip_smoke.ITERS iterations."""
    import torch

    n = cs.N_TRAIN
    runs = [("int8", int8_ds, dict(cs.PARAMS, tpu_hist_precision="int8"))]
    mc = int8_ds.subset(np.arange(n))
    latent = cs.make_latent(n + cs.N_HOLD, cs.N_FEAT)
    mc.set_field("label", cs.quintiles(latent)[:n])
    runs.append(("multiclass_int8", mc, cs.MULTICLASS_PARAMS))
    mono = dict(cs.MONO_PARAMS, monotone_constraints=cs.mono_constraints(w))
    runs.append(("mono_int8", None, mono))
    efb = dict(cs.EFB_PARAMS, tpu_hist_precision="int8")
    runs.append(("efb_int8", None, efb))
    for name, ds, params in runs:
        if name == "mono_int8":
            ds = lgb.Dataset(X[:n], label=y[:n],
                             params=dict(params)).construct()
        if name == "efb_int8":
            Xe, ye, _ = cs.efb_data(n + cs.N_HOLD)
            ds = lgb.Dataset(Xe[:n], label=ye[:n],
                             params=dict(params)).construct()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster = lgb.train(dict(params), ds, num_boost_round=cs.ITERS,
                            keep_training_booster=True)
        booster.num_trees()
        torch.cuda.synchronize()
        iters_per_s = cs.ITERS / (time.perf_counter() - t0)
        yield (name, booster, iters_per_s,
               cs.profile(booster, kernels_of=kernels_of))
        del booster, ds


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rows", choices=("all", "leaf"), default="all")
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
    X, y, w = cs.make_data(cs.N_TRAIN + cs.N_HOLD, cs.N_FEAT, with_w=True)
    datasets = {}
    learners = {}
    paths = cs.PATHS[:12] if args.rows == "all" else cs.PATHS[1:2]
    for name, params, _, _ in paths:
        if params["max_bin"] not in datasets:
            datasets[params["max_bin"]] = lgb.Dataset(
                X[:cs.N_TRAIN], label=y[:cs.N_TRAIN],
                params=dict(params)).construct()
        profiled = name in PROFILED and args.rows == "all"
        booster = lgb.train(dict(params), datasets[params["max_bin"]],
                            num_boost_round=cs.ITERS if profiled else 1,
                            keep_training_booster=True)
        booster.num_trees()
        if profiled:
            emit("path", path=name, **cs.profile(booster,
                                                 kernels_of=kernels_of))
        learners[name] = booster._driver.learner
    mhz = cs.sm_clock_mhz()
    for name, booster, ips, prof in leaf_paths(lgb, datasets[255], X, y,
                                               w, kernels_of):
        learner = booster._driver.learner
        # the floors of the profiled trees, a call each: the mean is what
        # the mean time a call on the path compares with
        trees = booster._driver.models[
            -prof["iters"] * booster.num_model_per_iteration():]
        longest = [int(t.leaf_count[:t.num_leaves].max()) for t in trees]
        floors = [cs.leaf_sums_floor(learner.n_pad,
                                     learner.params.num_leaves + 1, rows,
                                     mhz) for rows in longest]
        emit("leaf_path", path=name, iters_per_s=ips,
             largest_leaf_rows=longest,
             floor_ms=sum(f for f, _ in floors) / len(floors),
             chain_ms=sum(c for _, c in floors) / len(floors),
             leaf_kernels={k: v for k, v in prof["kernels"].items()
                           if k.startswith("leaf_")},
             **{k: v for k, v in prof.items() if k != "kernels"})
    del datasets
    if args.rows == "all":
        for row in kernel_rows(learners, kernels_of):
            emit("kernel", **row)
    for row in leaf_rows(learners["int8"]):
        emit("kernel", **row)


if __name__ == "__main__":
    main()
