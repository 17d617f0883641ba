#!/usr/bin/env python3
"""`chip_smoke.py`'s sharded-learner parts alone, on the card: the
quickest loop for the sharded paths.

    python3 probes/sharded_paths.py [--profile]

On the Higgs-1M shape (`chip_smoke.py`'s generator, seed 42): the
serial hilo and int8 paths (10 iterations each, for the AUC each
sharded path is held to), the five sharded paths of `SHARDED_PATHS`
(`chip_smoke.sharded_path`, one "main path" line each), phase 4's rows
on shard 1's operands (`check_shards`, one "kernel" line each) and phase
5's sharded checks (`cross_check_sharded`), then the seconds of the
whole.  With --profile, before phase 4, two more iterations of each
sharded path (and of the serial int8 path) under torch.profiler
(`chip_smoke.profile`: device busy ms and idle share an iteration, host
torch ops, each kernel's device ms a call).  Every check is
`chip_smoke.py`'s own: a failure exits 1.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this probe needs a "
                "card")
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    print(cs.smi_line(), flush=True)
    kernels.library()
    print(f"kernels built in {kernels.build_seconds:.2f} s", flush=True)
    X, y = cs.make_data(cs.N_TRAIN + cs.N_HOLD, cs.N_FEAT)
    ds = lgb.Dataset(X[:cs.N_TRAIN], label=y[:cs.N_TRAIN],
                     params=dict(cs.PARAMS)).construct()
    reports, boosters = {}, {}
    for name, params, iters, must in cs.PATHS[:2]:
        reports[name], boosters[name] = cs.main_path(
            lgb, kernels, ds, X, y, params, iters, must)
        print(f"main path {name} " + json.dumps(
            {k: reports[name][k] for k in ("iters_per_s", "holdout_auc")}),
            flush=True)
    for name, params, must, serial in cs.SHARDED_PATHS:
        t1 = time.perf_counter()
        reports[name], boosters[name] = cs.sharded_path(
            lgb, kernels, ds, X, y, params, must, boosters[serial])
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        print(f"path_s {name} {time.perf_counter() - t1:.1f}", flush=True)
    if "--profile" in sys.argv[1:]:
        for name in ["int8"] + [p[0] for p in cs.SHARDED_PATHS]:
            print(f"profile {name} " + json.dumps(cs.profile(
                boosters[name])), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for row, path in cs.check_shards(boosters, gen):
        row["launches"] = reports[path]["launches"][row["name"]]
        print("kernel " + json.dumps(row), flush=True)
    t1 = time.perf_counter()
    print("cross-check " + json.dumps(cs.cross_check_sharded(
        lgb, X, y, cs.PATHS[1][1])), flush=True)
    print(f"cross_s {time.perf_counter() - t1:.1f} total "
          f"{time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
