#!/usr/bin/env python3
"""Time the add step of the wide histogram's two cluster designs
(probes/cluster_adds.cu) on one CUDA card, at the geometry the wide
plans take on it, and print one JSON line per measurement.

    python3 probes/cluster_adds.py

Builds the probe with nvcc into build/probes/ and runs, for the f32 sums
of the hilo stats (S = 5) and the int32 sums of the int8 stats (S = 3),
the local add of one tile (the tiled read's add step, once a tile
walk), design (a) remote adds (also issued one destination block at a
time) and design (b) queues, each over 2^20
entries of 32 uniform random bins (the root call's adds at 1M rows).
The geometry (cluster C, threads, bin_tile) is the one `hist_plan`
printed for B = 1024 on an NVIDIA H100 80GB HBM3 (PERF.md section 6).
"""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(ROOT, "build", "probes")
# (acc, C, threads, bin_tile, S): the wide plans at B = 1024
CASES = [("f32", 5, 1024, 208, 5), ("i32", 3, 1024, 344, 3)]


def main():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        sys.exit("nvcc not found: the probe needs the CUDA toolkit")
    os.makedirs(OUT, exist_ok=True)
    exe = os.path.join(OUT, "cluster_adds")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-o", exe,
                    os.path.join(HERE, "cluster_adds.cu")], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    keys = ("design", "acc", "C", "threads", "bin_tile", "S", "clusters",
            "rows_per_warp", "ms", "entries")
    for acc, C, threads, bt, S in CASES:
        for design, c in (("local", 1), ("remote", C), ("queue", C),
                          ("grouped", C)):
            res = subprocess.run([exe, design, acc, str(c), str(threads),
                                  str(bt), str(S)], capture_output=True,
                                 text=True, timeout=600)
            line = res.stdout.strip().splitlines()[-1] if res.stdout else ""
            parts = line.split()
            if res.returncode != 0 or len(parts) != len(keys):
                print(json.dumps({"design": design, "acc": acc, "C": c,
                                  "error": line or res.stderr.strip()}))
                continue
            row = dict(zip(keys, parts))
            for k in keys[2:]:
                row[k] = float(row[k]) if k == "ms" else int(row[k])
            print(json.dumps({**row, "device": smi}), flush=True)


if __name__ == "__main__":
    main()
