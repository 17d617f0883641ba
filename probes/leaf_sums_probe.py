#!/usr/bin/env python3
"""Time variants of the leaf refit's two kernels (lightgbm_tpu_torch/
csrc/leafsum.cu) on one CUDA card, at chip_smoke.py's phase-4 operands,
and print one JSON line per measurement.

    python3 probes/leaf_sums_probe.py

Each variant is the source with some of its constants replaced (the
sums' chunk of float4s and the float4s its adds read ahead; the
grouping's rows a block), built with the package's nvcc flags into
build/probes/.  For each variant and each operand set (uniform leaf ids
over 255 leaves of 1,007,616 rows; the same with 570,000 rows in one
leaf) it checks the sums bitwise against index_add_ on the CPU and
prints each kernel's device time per call (chip_smoke.device_ms) and,
for the sums, the cycles an add of the largest leaf's chain at the
card's highest SM clock.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "probes")

# (tag, {constant: value}); the source's own values first
VARIANTS = [
    ("source", {}),
    ("stages2", {"kStages": 2}),
    ("stages3", {"kStages": 3}),
    ("stages8", {"kStages": 8}),
    ("chunk512_stages2", {"kChunkVecs": 512, "kStages": 2}),
    ("chunk128", {"kChunkVecs": 128}),
    ("prefetch4", {"kPrefetch": 4}),
]


def variant_source(text, subs):
    for name, value in subs.items():
        text, n = re.subn(rf"(constexpr int {name} = )\d+", rf"\g<1>{value}",
                          text)
        if n != 1:
            raise SystemExit(f"constant {name} not found once in leafsum.cu")
    return text


def build(tag, subs, nvcc, flags):
    src = os.path.join(OUT, f"leafsum_{tag}.cu")
    with open(os.path.join(ROOT, "lightgbm_tpu_torch", "csrc",
                           "leafsum.cu")) as f:
        text = variant_source(f.read(), subs)
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"libleafsum_{tag}.so")
    return lib, subprocess.Popen(
        [nvcc, *flags, "-shared", "-o", lib, src], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def bind(path):
    lib = ctypes.CDLL(path)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.lgbt_leaf_group_plan.argtypes = [i64, i32, ip]
    lib.lgbt_leaf_group.argtypes = [vp, vp, i64, i32, vp, vp, vp, ip, vp]
    lib.lgbt_leaf_sums.argtypes = [vp, vp, vp, i32, vp]
    return lib


def main():
    import torch

    import chip_smoke as cs
    from lightgbm_tpu_torch.ops import kernels, leafsum

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: the probe needs a card")
    os.makedirs(OUT, exist_ok=True)
    nvcc = kernels._nvcc()
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    builds = [(tag, *build(tag, subs, nvcc, flags))
              for tag, subs in VARIANTS]
    print(json.dumps({"device": cs.smi_line(), "sm_mhz": cs.sm_clock_mhz()}),
          flush=True)
    mhz = cs.sm_clock_mhz()
    dev = torch.device("cuda", 0)
    learner = types.SimpleNamespace(
        bins_t=torch.zeros(1, device=dev), n_pad=1_007_616,
        params=types.SimpleNamespace(num_leaves=255))
    stream = torch.cuda.current_stream().cuda_stream
    for tag, path, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"variant": tag, "build_error": log[-2000:]}),
                  flush=True)
            continue
        lib = bind(path)
        gen = torch.Generator(device="cuda").manual_seed(7)
        for operands in ("uniform", "skewed"):
            leaf, vals, L = cs._leaf_operands(learner, gen, operands)
            n = leaf.numel()
            plan = (ctypes.c_int * 5)()
            kernels.check(lib.lgbt_leaf_group_plan(n, L, plan), "plan")
            grouped = torch.empty((n + (n & 1), 2), device=dev)
            offsets = torch.empty(L + 1, dtype=torch.int32, device=dev)
            scratch = torch.empty(plan[4], dtype=torch.int32, device=dev)
            out = torch.empty((2, L), device=dev)

            def group():
                kernels.check(lib.lgbt_leaf_group(
                    leaf.data_ptr(), vals.data_ptr(), n, L,
                    grouped.data_ptr(), offsets.data_ptr(),
                    scratch.data_ptr(), plan, stream), "leaf_group")

            def sums():
                kernels.check(lib.lgbt_leaf_sums(
                    grouped.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                    L, stream), "leaf_sums")

            group()
            sums()
            equal = torch.equal(out.cpu(), leafsum.leaf_sums_plain(
                leaf.cpu(), vals.cpu(), L))
            longest = int(torch.bincount(leaf.long(), minlength=L).max())

            def named(part):
                return lambda names: [part if part in k else None
                                      for k in names]

            group_ms = cs.device_ms(group, 20, named("leaf_group_kernel"))
            sums_ms = cs.device_ms(sums, 20, named("leaf_sums_kernel"))
            print(json.dumps({
                "variant": tag, "operands": operands, "equal": equal,
                "plan": list(plan), "largest_leaf_rows": longest,
                "group_ms": group_ms, "sums_ms": sums_ms,
                "sums_cycles_per_row": sums_ms * mhz * 1e3 / longest}),
                flush=True)


if __name__ == "__main__":
    main()
