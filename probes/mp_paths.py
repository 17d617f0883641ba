#!/usr/bin/env python3
"""`chip_smoke.py`'s two-process parts alone, on the card: the quickest
loop for the distributed learners across processes.

    python3 probes/mp_paths.py

On the Higgs-1M shape (`chip_smoke.py`'s generator, seed 42): the serial
int8 path and the in-process data_int8 path (`chip_smoke.main_path`,
`chip_smoke.sharded_path`, 5 iterations, one "main path" line each) for
the iterations a second the two-process paths are read beside, then
`chip_smoke.mp_paths`: two worker processes on the first card,
mp_data_int8 (every rank holding every row) and mp_prepart_int8
(pre_partition, each rank its half, the held-out rows a partitioned
validation set), with their checks and phase 5's two-process check;
then the seconds of the whole.  Every check is `chip_smoke.py`'s own: a
failure exits 1.
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
    name, params, _, must = cs.PATHS[1]
    reports[name], boosters[name] = cs.main_path(
        lgb, kernels, ds, X, y, params, cs.ITERS_SHARDED, must)
    print(f"main path {name} " + json.dumps(
        {k: reports[name][k] for k in ("iters_per_s", "holdout_auc")}),
        flush=True)
    name, params, must, serial = cs.SHARDED_PATHS[0]
    reports[name], _ = cs.sharded_path(lgb, kernels, ds, X, y, params,
                                       must, boosters[serial])
    print(f"main path {name} " + json.dumps(
        {k: reports[name][k] for k in ("iters_per_s", "holdout_auc",
                                       "host_syncs_per_tree",
                                       "last_tree")}), flush=True)
    cross = {}
    t1 = time.perf_counter()
    cs.mp_paths(lgb, ds, X, y, reports, cross)
    print(f"path_s mp_paths+check {time.perf_counter() - t1:.1f}",
          flush=True)
    print("cross-check " + json.dumps(cross), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
