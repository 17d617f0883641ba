#!/usr/bin/env python3
"""`chip_smoke.py`'s telemetry phase alone, on the card: the quickest
loop for the span tracer, the phase timer and the device-memory gauges.

    python3 probes/telemetry_paths.py

On the Higgs-1M shape (`chip_smoke.py`'s generator, seed 42):
`chip_smoke.telemetry_paths` — trace_int8 (20 iterations with the
held-out rows as a validation set, traced, beside the same run with
telemetry off, and the torch.profiler mirror of two more iterations),
metrics_hilo (10 iterations under tpu_telemetry=metrics), trace_data_int8
(the data learner, 2 shards, 3 iterations, traced) and the overhead runs
(int8, 10 iterations each, off, metrics, trace, trace, metrics, off);
then the seconds of the whole.  Every check is `chip_smoke.py`'s own: a
failure exits 1.
"""

import os
import shutil
import sys
import tempfile
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
    tmp = tempfile.mkdtemp()
    try:
        cs.telemetry_paths(lgb, kernels, X, y, {}, tmp)
    finally:
        shutil.rmtree(tmp, True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
