#!/usr/bin/env python3
"""Where a streamed tree's time goes on the card, and a predict chunk's
peak against the memory plan.

    python3 probes/stream_probe.py

On the Higgs-1M shape (`chip_smoke.py`'s generator, seed 42), one JSON
line each:
  * profile: int8 streamed in blocks of 131,072 rows (stream_int8's
    parameters) and int8 resident on the sync step, each trained 3
    iterations and then profiled over 2 more (`chip_smoke.profile`):
    device busy, idle share, host torch ops an iteration, each kernel's
    device ms a call;
  * block_step: the host seconds of one block step's parts on the
    streamed learner's own first block, each over REPS calls ended by a
    synchronize: a copy into a slot with its events (`_stream_blocks`
    with nothing to consume), the partition (`_partition_block`, 25
    splits) and B1-int (`build_histogram_rows`, 25 slots), and the copy's
    and B1-int's device ms by CUDA events;
  * predict_chunk: the allocator's peak over one 65,536-row predict
    chunk at 2 and 50 trees against the plan's predict_scratch.
"""

import json
import os
import sys
import time

import numpy as np

REPS = 200


def _host_s(fn, reps=REPS):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("stream_probe.py needs a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.utils import membudget

    print(cs.smi_line(), flush=True)
    kernels.library()
    X, y = cs.make_data(cs.N_TRAIN + cs.N_HOLD, cs.N_FEAT)
    ds = lgb.Dataset(X[:cs.N_TRAIN], label=y[:cs.N_TRAIN],
                     params=dict(cs.PARAMS)).construct()
    int8 = dict(cs.PARAMS, tpu_hist_precision="int8")
    out = {}
    with cs._sync_step(lgb):
        b = lgb.train(dict(int8), ds, 3, keep_training_booster=True)
        out["resident_sync_int8"] = cs.profile(b)
    del b
    b = lgb.train(dict(cs.STREAM_PARAMS), ds, 3, keep_training_booster=True)
    out["stream_int8"] = cs.profile(b)
    print("profile " + json.dumps(out), flush=True)

    # one block step's parts on the streamed learner's first block
    learner = b._driver.learner
    sg = learner._stream
    blocks = learner._host_blocks
    R, G, B = sg.R, learner.g_pad, learner.num_bins
    gen = torch.Generator(device="cuda").manual_seed(3)
    leaf = torch.randint(0, 50, (R,), generator=gen, device="cuda",
                         dtype=torch.int32)
    K = 25
    sel = torch.arange(0, 2 * K, 2, dtype=torch.int32, device="cuda")
    plan = sg._split_plan(
        sel, torch.randint(0, cs.N_FEAT, (K,), generator=gen, device="cuda",
                           dtype=torch.int32),
        torch.randint(0, B, (K,), generator=gen, device="cuda",
                      dtype=torch.int32),
        torch.zeros(K, dtype=torch.bool, device="cuda"),
        torch.arange(50, 50 + K, dtype=torch.int32, device="cuda"),
        learner.meta)
    blk = blocks[0].to("cuda")
    stats = torch.randint(-127, 128, (3, R), generator=gen, device="cuda",
                          dtype=torch.int8)
    stats[2] = 1
    sg._timings, sg._bytes = [], 0
    steps = {
        "copy_host_s": _host_s(lambda: sg._stream_blocks(
            blocks, [0], lambda *a: None)),
        "partition_host_s": _host_s(
            lambda: sg._partition_block(blk, leaf.clone(), plan)),
        "hist_host_s": _host_s(lambda: H.build_histogram_rows(
            blk, G, stats, leaf, sel, B, "int8")),
        "hist_ms": cs.cuda_ms(lambda: H.build_histogram_rows(
            blk, G, stats, leaf, sel, B, "int8"), REPS),
        "rows": R, "block_bytes": int(blocks[0].nbytes)}
    copies = [t for t, _ in sg._timings]
    steps["copy_ms"] = float(np.mean([s.elapsed_time(e)
                                      for s, e in copies]))
    print("block_step " + json.dumps(steps), flush=True)
    del b, learner, sg

    chunk = {}
    for trees in (2, 50):
        p = dict(int8, num_iterations=trees)
        bt = lgb.Booster(params=p, train_set=ds)
        for _ in range(trees):
            bt.update()
        bt.predict(X[cs.N_TRAIN:cs.N_TRAIN + 100])
        drv = bt._driver
        plan = membudget.plan_training(drv.config, drv.learner, 1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bt.predict(X[cs.N_TRAIN:cs.N_TRAIN + 65536])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        chunk[trees] = {"peak_bytes": peak,
                        "plan_bytes": plan.components["predict_scratch"],
                        "live_bytes": membudget.live_bytes(drv)[
                            "predict_scratch"],
                        "plan_over_peak": plan.components[
                            "predict_scratch"] / peak}
        del bt, drv
    print("predict_chunk " + json.dumps(chunk), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
