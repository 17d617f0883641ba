#!/usr/bin/env python3
"""Find out why torch.profiler sometimes sees only a few of a profile's
kernel launches on one CUDA card, and what brings them back.

    python3 probes/profiler_starvation.py [--seconds S] [--no-load]
                                          [--variants a,b,...]

chip_smoke.device_ms times a kernel from the device events of a profile
of 20 calls, with an empty profile before it (events late from earlier
profiles) and one after it (its own late events).  This script builds
the package's kernels, trains the hilo path of chip_smoke.py for two
iterations and times phase 4's first row (kernel B1 at random operands)
the same way, under these conditions:

  idle     nothing else running;
  history  after a profile of one training iteration and one of 30,000
           small torch kernels (phase 3 profiles whole iterations);
  load     with 2 busy processes a CPU core running beside it (the host's
           cores are shared with other machines);
  aged     after S seconds (default 240) of training under no profile.

In each it first holds the profiler's mean kernel time against CUDA
events around 20 calls queued behind a device sleep and around 20 calls
back to back, and takes a profile of 200 calls.  Then it takes the same
measurement in the variants --variants names (default all): `plain`
as device_ms; `pad` sleeps 50 ms inside the timed profile after its
synchronize; `late` sleeps 200 ms inside the profile after it; `flood`
launches 20,000 small kernels in the profile after it; `lead` sleeps
100 ms inside the timed profile before the first call; `lead_pad`
sleeps 100 ms before and after; `tail64` and `tail2048` launch 64 or
2,048 small kernels inside the timed profile after its calls.  For
each it prints one JSON line: the port launches seen in the profile
before, the timed profile and the one after; the kernel-launch calls
the host saw in the timed profile; and, for the launches seen, the
device start minus the host's launch call (median, by correlation id),
how many device starts lie outside the host's clock reading of the
timed window and where they start in it.  With KINETO_LOG_LEVEL=1 the
profiler logs, for each profile, the device records it dropped as
outside its window ("Out-of-range").
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

REPS = 20
TRIES = 5
# about 50 ms at the H100's highest SM clock: longer than the host takes
# to enqueue REPS calls
SLEEP_CYCLES = 100_000_000
VARIANTS = {"plain": {}, "pad": {"pad_s": 0.05}, "late": {"late_s": 0.2},
            "flood": {"flood": 20_000}, "lead": {"lead_s": 0.1},
            "lead_pad": {"lead_s": 0.1, "pad_s": 0.1},
            "tail64": {"tail": 64}, "tail2048": {"tail": 2048}}


def port_launches(prof):
    """(kineto events of the port's kernels, all kineto events)."""
    import torch

    events = list(prof.profiler.kineto_results.events())
    dev = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    labels = cs.port_kernels([e.name() for e in dev])
    return [e for e, label in zip(dev, labels) if label is not None], events


def measure(fn, filler, pad_s=0.0, late_s=0.0, flood=0, lead_s=0.0,
            tail=0):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=acts) as pre:
        torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        if lead_s:
            time.sleep(lead_s)
        t0 = time.time_ns()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
        for _ in range(tail):
            filler.add_(1.0)
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
    with tprofile(activities=acts) as late:
        torch.cuda.synchronize()
        for _ in range(flood):
            filler.add_(1.0)
        torch.cuda.synchronize()
        if late_s:
            time.sleep(late_s)
    seen, events = port_launches(prof)
    starts = sorted((e.start_ns() - t0) / 1e6 for e in seen)
    launch_calls = {e.correlation_id(): e.start_ns() for e in events
                    if "LaunchKernel" in e.name()}
    offsets = [(e.start_ns() - launch_calls[e.correlation_id()]) / 1e3
               for e in seen if e.correlation_id() in launch_calls]
    outside = sum(1 for e in seen if not t0 <= e.start_ns() <= t1)
    return {"pre": len(port_launches(pre)[0]), "timed": len(seen),
            "late": len(port_launches(late)[0]),
            "host_launch_calls": len(launch_calls),
            "median_offset_us": (statistics.median(offsets) if offsets
                                 else None),
            "outside_window": outside,
            "seen_starts_ms": [round(x, 4) for x in starts]}


def queued_ms(fn, reps):
    """Mean device time of fn() over reps calls queued behind a device
    sleep: the host enqueues every call before the device starts on
    them, so the host's own time does not enter (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiler_ms(fn, reps):
    """Mean device time of the port launches seen in one profile of
    reps calls (ms), and how many were seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen, _ = port_launches(prof)
    if not seen:
        return None, 0
    return sum(e.duration_ns() for e in seen) / len(seen) / 1e6, len(seen)


def compare_clocks(name, fn):
    """The profiler's mean kernel time against queued CUDA events and
    back-to-back CUDA events, three times each, and a profile of 200
    calls."""
    rows = []
    for _ in range(3):
        prof_ms, seen = profiler_ms(fn, REPS)
        rows.append({"profiler_ms": prof_ms, "seen": seen,
                     "queued_ms": queued_ms(fn, REPS),
                     "events_ms": cs.cuda_ms(fn, REPS)})
    big_ms, big_seen = profiler_ms(fn, 200)
    print(json.dumps({"condition": name, "clocks": rows,
                      "profile_200": {"ms": big_ms, "seen": big_seen}}),
          flush=True)


def run_condition(name, fn, filler, variants):
    compare_clocks(name, fn)
    for variant in variants:
        kw = VARIANTS[variant]
        rows = [measure(fn, filler, **kw) for _ in range(TRIES)]
        print(json.dumps({
            "condition": name, "variant": variant,
            "seen_of": REPS * TRIES,
            "timed_seen": sum(r["timed"] for r in rows),
            "late_seen": sum(r["late"] for r in rows),
            "timed_plus_late_min": min(r["timed"] + r["late"]
                                       for r in rows),
            "tries": rows}), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seconds", type=float, default=240.0)
    parser.add_argument("--no-load", action="store_true")
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args()
    variants = args.variants.split(",")
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    if not torch.cuda.is_available():
        sys.exit("this probe needs a CUDA card")
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import kernels

    print(cs.smi_line(), flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    kernels.library()
    name, params, _, _ = next(p for p in cs.PATHS if p[0] == "hilo")
    X, y = cs.make_data(cs.N_TRAIN + cs.N_HOLD, cs.N_FEAT)
    ds = lgb.Dataset(X[:cs.N_TRAIN], label=y[:cs.N_TRAIN],
                     params=dict(params)).construct()
    booster = lgb.train(dict(params), ds, num_boost_round=2,
                        keep_training_booster=True)
    booster.num_trees()
    learner = booster._driver.learner
    gen = torch.Generator(device="cuda").manual_seed(7)
    bins_t, _, pb, _, _ = cs._b1_operands(learner)
    wrapper, _, _ = cs._hist_route(learner)
    stats, _, _ = cs._hilo_stats(learner, gen)
    leaf, slots = cs._slots_of(learner, gen, "random")

    def fn():
        return wrapper(bins_t, stats, leaf, slots, learner.num_bins,
                       packed_block=pb)

    filler = torch.zeros(1, device="cuda")
    run_condition("idle", fn, filler, variants)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts):
        booster.update()
        booster.num_trees()
        torch.cuda.synchronize()
    with tprofile(activities=acts):
        for _ in range(30_000):
            filler.add_(1.0)
        torch.cuda.synchronize()
    run_condition("history", fn, filler, variants)

    busy = [] if args.no_load else [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(2 * (os.cpu_count() or 8))]
    try:
        if busy:
            time.sleep(1.0)
            run_condition("load", fn, filler, variants)
    finally:
        for p in busy:
            p.kill()
        for p in busy:
            p.wait()

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        booster.update()
        booster.num_trees()
    torch.cuda.synchronize()
    run_condition("aged", fn, filler, variants)
    time.sleep(5.0)
    run_condition("aged_rested", fn, filler, variants)


if __name__ == "__main__":
    main()
