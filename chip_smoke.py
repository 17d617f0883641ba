#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card: the quickest proof
that the port still starts on the GPU.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (exit code 1, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from lightgbm_tpu_torch/csrc with nvcc;
  3. three paths at full width, each lgb.train on the Higgs-1M shape
     (1,000,000 rows x 28 dense features, binary, 255 leaves, 255 bins,
     tpu_partition_impl=kernel), then predict 100,000 held-out rows; the
     launch counters are set to 0 just before each path and read just
     after, and each kernel of the path must have launched:
       hilo  hilo histograms, 10 iterations: B1 and B3;
       int8  tpu_hist_precision=int8 with its defaults (stochastic
             rounding, leaf refit), 10 iterations: B1's integer variant
             at the root, B2 in every grower round, B3;
       flat  tpu_hist_impl=pallas, hilo, 3 iterations: B4 and B3;
  4. each kernel against its plain PyTorch twin on the card, at the
     shapes its path gives it, with times (ms: the kernel's device time
     per call from torch.profiler; event_ms: CUDA events around 20
     back-to-back calls, which read the host's time when a call is
     shorter than its wrapper), the bound (every leaf id, the
     bins and stats of the live rows, the output) and, where one exists,
     one PyTorch library call computing the same function; B1 and B1-int
     also at the root call's operands (every row in slot 0, the other
     slots dead);
  5. the card against the CPU path at a reduced size (50,000 rows): hilo
     and binary int8 by AUC, and regression int8 with the leaf refit
     off by its model text, which must be byte-identical.
With --profile, two more iterations of the hilo and the int8 paths run
under torch.profiler and the device time by op, each port kernel's
device time per call on the path and the device's idle share are
printed.
The line before the last is {"kernels": [...]}, the last is
{"ok": true, "device": {...}}.  The data is the seeded synthetic
generator of bench.py (its non-env branch), copied here.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_TRAIN = 1_000_000
N_HOLD = 100_000
N_FEAT = 28
ITERS = 10
ITERS_FLAT = 3
N_SMALL = 50_000
ITERS_SMALL = 5
# the small run's AUC on the card and on the CPU: their trees differ only
# where f32 sums taken in another order flip an exact tie between split
# gains (noise-level gains of pure leaves), which moves a few leaves
AUC_TOL = 5e-3
# kernel B1 against its twin: count rows exact; g and h within this
# fraction of the slot's sum of |stat|, the f32 summation-order bound
HIST_RTOL = 1e-6
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_S = 67e12         # H100 SXM f32 outside the tensor cores
PEAK_ALU_S = 67e12         # H100 SXM scalar rate (the f32 row of the table)
PARAMS = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
          "min_data_in_leaf": 20, "max_bin": 255, "metric": "auc",
          "tree_learner": "serial", "tpu_hist_precision": "hilo",
          "tpu_partition_impl": "kernel", "tpu_shape_buckets": 0,
          "verbosity": -1}
# (name, params, iterations, kernels the path must launch)
PATHS = [
    ("hilo", PARAMS, ITERS, ("hist_batched", "partition_rows")),
    ("int8", dict(PARAMS, tpu_hist_precision="int8"), ITERS,
     ("hist_batched_int", "fused_hist_scan", "partition_rows")),
    ("flat", dict(PARAMS, tpu_hist_impl="pallas"), ITERS_FLAT,
     ("hist_flat", "partition_rows")),
]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_data(n, f, seed=42):
    """bench.py's synthetic Higgs-shaped generator (non-env branch)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(f,))
    logits = (X[:, :8] ** 2 - 1.0).sum(axis=1) * 0.3 + X @ w * 0.5
    y = (logits + rng.logistic(size=n) > 0).astype(np.float64)
    return X.astype(np.float64), y


def auc(score, label):
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.models.metrics import AUCMetric

    m = AUCMetric(None)
    m.init(Metadata(len(label), label), len(label))
    return m.eval(np.asarray(score, np.float64)[None, :], None)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps, kernels_of=None):
    """Device time per fn() of the port's own kernels, from
    torch.profiler: unlike cuda_ms it leaves out the time the device
    waits for the host between calls, which is what back-to-back CUDA
    events read when a call is shorter than its Python wrapper.
    kernels_of: as profile's."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    labels = (kernels_of or port_kernels)([ev.name for ev in events])
    us = sum(float(ev.self_device_time_total)
             for ev, label in zip(events, labels) if label is not None)
    return us / 1e3 / reps


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main_path(lgb, kernels, ds, X, y, params, iters, must_launch):
    """Phase 3, one path: train + predict at full width; returns the
    report and the booster."""
    import torch

    Xho, yho = X[N_TRAIN:], y[N_TRAIN:]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    booster = lgb.train(dict(params), ds, num_boost_round=iters)
    trees = booster.num_trees()       # materializes: one records fetch
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    driver = booster._driver
    train_auc = [v for _, name, v, _ in booster.eval_train()
                 if name == "auc"][0]
    t0 = time.perf_counter()
    pred = booster.predict(Xho)
    predict_s = time.perf_counter() - t0
    if trees != iters:
        fail(f"trained {trees} trees, expected {iters}")
    if not np.all(np.isfinite(pred)) or pred.shape != (N_HOLD,):
        fail(f"held-out predictions: shape {pred.shape}, finite "
             f"{bool(np.all(np.isfinite(pred)))}")
    for name in must_launch:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on this path")
    hold_auc = auc(pred, yho)
    if not 0.6 < train_auc <= 1.0 or not 0.6 < hold_auc <= 1.0:
        fail(f"AUC out of range: train {train_auc}, held-out {hold_auc}")
    learner = driver.learner
    return {"train_s": train_s, "iters_per_s": iters / train_s,
            "train_auc": train_auc, "holdout_auc": hold_auc,
            "predict_s": predict_s, "predict_rows_per_s": N_HOLD / predict_s,
            "host_syncs_per_tree": driver.grower_syncs / trees,
            "launches_per_tree": {k: v / trees for k, v in launches.items()},
            "launches": launches, "n_pad": learner.n_pad,
            "f_pad": learner.f_pad, "hist_impl": learner.params.hist_impl,
            "precision": learner.params.precision,
            "split_batch": learner.params.split_batch}, booster


_VIEW_OPS = {"aten::view", "aten::select", "aten::slice", "aten::as_strided",
             "aten::unbind", "aten::permute", "aten::expand",
             "aten::reshape", "aten::squeeze", "aten::unsqueeze", "aten::t",
             "aten::transpose", "aten::alias", "aten::detach",
             "aten::lift_fresh", "aten::_unsafe_view"}


# device kernel name -> the port kernel (launch counter) it belongs to
_PORT_KERNELS = (("ScanTail", "fused_hist_scan"),
                 ("grouped_hist_kernel<float", "hist_batched"),
                 ("grouped_hist_kernel<int", "hist_batched_int"),
                 ("partition_rows_kernel", "partition_rows"),
                 ("hist_flat_kernel", "hist_flat"))


def port_kernel(device_name):
    for part, name in _PORT_KERNELS:
        if part in device_name:
            return name
    return None


def port_kernels(device_names):
    """The port kernel of each device launch (None: not the port's)."""
    return [port_kernel(name) for name in device_names]


def _device_events(prof):
    """The device events of a torch.profiler run, in launch order."""
    import torch

    return sorted((ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda ev: ev.time_range.start)


def profile(booster, iters=2, kernels_of=None):
    """`--profile`: where the time of `iters` more iterations goes, from
    torch.profiler's device trace.  kernels_of maps the device launches'
    names, in launch order, to the port kernels they belong to (default
    port_kernels; a caller timing another version of the package gives
    one that knows that version's kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from lightgbm_tpu_torch.ops import kernels

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    kernels.reset_launches()
    syncs = booster._driver.grower_syncs
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            booster.update()
        booster.num_trees()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = dict(kernels.launches)
    syncs = booster._driver.grower_syncs - syncs
    # device busy time: the kernel, copy and set events themselves (the
    # torch ops that launched them carry the same time as self device
    # time, so summing both would count it twice)
    rows = []
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = float(ev.self_device_time_total)
        busy_us += dev_us
        rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    # host work: the torch ops the Python code issued (top level, views
    # excluded); each is at least one launch or host-side step
    ops = sum(1 for ev in prof.events()
              if ev.cpu_parent is None and ev.name.startswith("aten::")
              and ev.name not in _VIEW_OPS)
    # each port kernel's device launches summed under its name, so that
    # its time per call on the path reads directly (calls: its wrapper's
    # count over the profiled iterations)
    per_kernel = {}
    events = _device_events(prof)
    labels = (kernels_of or port_kernels)([ev.name for ev in events])
    for ev, name in zip(events, labels):
        if name is None:
            continue
        row = per_kernel.setdefault(name, {"calls": calls[name],
                                           "device_launches": 0,
                                           "device_ms": 0.0})
        row["device_launches"] += 1
        row["device_ms"] += float(ev.self_device_time_total) / 1e3
    for row in per_kernel.values():
        row["ms_per_call"] = row["device_ms"] / max(row["calls"], 1)
    return {"iters": iters, "wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "host_torch_ops_per_iter": ops / iters,
            "host_syncs_per_tree": syncs / iters,
            "kernels": per_kernel,
            "top": [{"kernel": k[:70], "calls": c, "device_ms": d / 1e3}
                    for d, k, c in rows[:12]]}


def check_hist(learner, gen, operands):
    """Phase 4, kernel B1 at the hilo path's shapes.  operands "random":
    leaf ids over the L leaves, K random slots, one dead (about 9.4% of
    the rows live), held to the twin; "root": every row in slot 0 and
    the other K-1 slots dead (the root call), held to an f64 sum, since
    the f32 twin's own rounding over a million rows in one slot is of the
    tolerance's order."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    bins_t = learner.bins_t
    F, n = bins_t.shape
    B = learner.num_bins
    K = learner.params.split_batch
    stats, g, h = _hilo_stats(learner, gen)
    leaf, slots = _slots_of(learner, gen, operands)
    hk = H._unpack_hist(H.hist_batched_kernel(bins_t, stats, leaf, slots, B)
                        .permute(3, 2, 0, 1), "hilo")
    hp = H._unpack_hist(H.hist_batched_plain(bins_t, stats, leaf, slots, B)
                        .permute(3, 2, 0, 1), "hilo")
    torch.cuda.synchronize()
    extra = {}
    if operands == "root":
        h64 = _hist_f64(bins_t, stats, leaf, slots, B)
        err, rel = _hist_rel_err(hk.double(), h64, g, h, leaf, slots)
        extra["twin_max_abs_err_vs_f64"] = float(
            (hp.double() - h64).abs().max().item())
        extra["reference"] = "f64 sum of the same stats"
    else:
        err, rel = _hist_rel_err(hk, hp, g, h, leaf, slots)
    lib_ms, m = _index_add_ms(bins_t, stats, leaf, slots, B)
    ms = device_ms(lambda: H.hist_batched_kernel(bins_t, stats, leaf, slots,
                                                 B), 20)
    event_ms = cuda_ms(lambda: H.hist_batched_kernel(bins_t, stats, leaf,
                                                     slots, B), 20)
    plain_ms = cuda_ms(
        lambda: H.hist_batched_plain(bins_t, stats, leaf, slots, B), 5)
    S = stats.shape[0]
    return {"name": "hist_batched", "operands": operands, "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/histogram.cu",
            "replaces": "lightgbm_tpu/ops/histogram.py:584",
            "max_abs_err": err, "max_rel_err": rel,
            "tolerance": f"counts exact, g/h rel {HIST_RTOL:g}", "ms": ms,
            "event_ms": event_ms, "plain_ms": plain_ms,
            **_hist_bound(n, m, F, S, 2, K, F * B * K * S, PEAK_F32_S),
            "library_ms": lib_ms, **extra,
            "shape": f"bins [{F}, {n}] u8, stats [{S}, {n}] bf16, K={K}, "
                     f"B={B}, live rows {m}"}


def check_partition(learner, gen):
    """Phase 4, kernel B3 at the main path's shapes."""
    import torch
    from lightgbm_tpu_torch.ops import fused

    dev = learner.bins_t.device
    bins_t = learner.bins_t
    F, n = bins_t.shape
    K = learner.params.split_batch
    L = learner.params.num_leaves
    nf = learner.num_features
    meta = learner.meta
    leaf = torch.randint(0, L - K, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    sel = torch.randperm(L - K, generator=gen, device=dev)[:K].to(torch.int32)
    new_ids = (L - K + torch.arange(K, device=dev)).to(torch.int32)
    feat = torch.randint(0, nf, (K,), generator=gen, device=dev,
                         dtype=torch.int32)
    nbf = meta["num_bin"][feat.long()]
    thr = (torch.rand(K, generator=gen, device=dev) * (nbf - 1).float()
           ).to(torch.int32)
    dleft = torch.rand(K, generator=gen, device=dev) < 0.5
    mt = meta["missing_type"][feat.long()]
    db = meta["default_bin"][feat.long()]
    do_k = torch.arange(K, device=dev) < K - 2
    args = (bins_t, feat, leaf, sel, new_ids, thr, dleft, mt, nbf, db, do_k)
    out_k = fused.partition_rows_kernel(*args)
    out_p = fused.partition_rows_plain(*args)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    if err != 0:
        fail(f"partition_rows differs from its twin (max err {err})")
    ms = device_ms(lambda: fused.partition_rows_kernel(*args), 20)
    event_ms = cuda_ms(lambda: fused.partition_rows_kernel(*args), 20)
    plain_ms = cuda_ms(lambda: fused.partition_rows_plain(*args), 5)
    m = int(((leaf[None, :] == sel[:, None]) & do_k[:, None]).sum().item())
    nbytes = n * 4 + n * 4 + m + K * 9 * 4
    return {"name": "partition_rows", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/partition.cu",
            "replaces": "lightgbm_tpu/ops/fused.py:296",
            "max_abs_err": float(err), "max_rel_err": float(err),
            "tolerance": "bitwise", "ms": ms, "event_ms": event_ms,
            "plain_ms": plain_ms,
            **_bound(nbytes, n * K * 2, PEAK_ALU_S), "library_ms": None,
            "shape": f"bins [{F}, {n}] u8, leaf [{n}] i32, K={K}, "
                     f"rows of splitting leaves {m}"}


def _hilo_stats(learner, gen):
    """hilo [5, n] stats of random grad/hess on the learner's rows, and
    the grad and hess."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    dev = learner.bins_t.device
    n = learner.bins_t.shape[1]
    mask = learner._ones_mask
    g = torch.randn(n, generator=gen, device=dev) * 0.5 * mask
    h = torch.rand(n, generator=gen, device=dev) * 0.25 * mask
    return H.pack_stats(g, h, mask, "hilo").contiguous(), g, h


def _int8_stats(learner, gen):
    """int8 [3, n] stats of random grad/hess on the learner's rows,
    rounded as the quantized grower rounds them (nearest)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    dev = learner.bins_t.device
    n = learner.bins_t.shape[1]
    mask = learner._ones_mask
    q = H.quant_limit("int8", n)
    g = torch.randn(n, generator=gen, device=dev) * mask
    h = torch.rand(n, generator=gen, device=dev) * mask
    gq = H.quantize_values(g, g.abs().max() / q, q, "nearest")
    hq = H.quantize_values(h, h.abs().max() / q, q, "nearest")
    return H.pack_stats(gq, hq, mask, "int8").contiguous()


def _hist_rel_err(hk, hp, g, h, leaf, slots):
    """A float histogram kernel against its twin: counts exact, and g, h
    within HIST_RTOL of each slot's sum of |stat| (each row lands in one
    bin of every feature).  Returns (max abs err, max relative err)."""
    import torch

    err = (hk - hp).abs()
    match = (slots[:, None] == leaf[None, :]).float()
    scale = torch.stack([match @ g.abs(), match @ h.abs()], 1)
    ok_cnt = bool(torch.equal(hk[..., 2], hp[..., 2]))
    rel = (err[..., :2] / scale[:, None, None, :].clamp(min=1e-30)).max()
    if not ok_cnt or rel.item() > HIST_RTOL:
        fail(f"a histogram kernel disagrees with its twin: counts equal "
             f"{ok_cnt}, max relative g/h err {rel.item()}")
    return float(err.max().item()), float(rel.item())


def _bound(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _index_add_ms(bins_t, stats, leaf, slots, B):
    """The yardstick: one index_add_ over a precomputed flat
    (feature, bin, slot) index; unmatched rows add into a spare row."""
    import torch

    dev = bins_t.device
    F, n = bins_t.shape
    K = slots.shape[0]
    S = stats.shape[0]
    flat, m = _flat_index(bins_t, leaf, slots, B)
    acc = torch.float32 if stats.is_floating_point() else torch.int32
    vals = stats.to(acc).T[None].expand(F, -1, -1).reshape(-1, S)
    out = torch.zeros(F * B * K + 1, S, device=dev, dtype=acc)
    return cuda_ms(lambda: out.index_add_(0, flat, vals), 5), m


def _slots_of(learner, gen, operands):
    if operands == "random":
        return _random_slots(learner, gen)
    import torch

    dev = learner.bins_t.device
    K = learner.params.split_batch
    leaf = torch.zeros(learner.bins_t.shape[1], dtype=torch.int32,
                       device=dev)
    slots = torch.full((K,), -1, dtype=torch.int32, device=dev)
    slots[0] = 0
    return leaf, slots


def _hist_bound(n, m, F, S, stat_bytes, K, out_words, peak_ops):
    """The bound of a K-slot histogram call, from what its inputs need:
    every leaf id, the bins and stats of the m live rows only, the slot
    ids, and the output written once; m * F * S adds.  Beside it the
    bound that counts every row's bins and stats, as earlier versions of
    this script did."""
    live = n * 4 + m * (F + S * stat_bytes) + K * 4 + out_words * 4
    every = n * 4 + n * (F + S * stat_bytes) + K * 4 + out_words * 4
    return {**_bound(live, m * F * S, peak_ops),
            "bound_ms_all_rows": _bound(every, m * F * S,
                                        peak_ops)["bound_ms"]}


def _flat_index(bins_t, leaf, slots, B):
    """[F * n] flat (feature, bin, slot) index of each row's adds (one
    past the end for rows in no slot) and the live-row count."""
    import torch

    dev = bins_t.device
    F, n = bins_t.shape
    K = slots.shape[0]
    k_of = torch.full((n,), K * F * B, device=dev, dtype=torch.int64)
    for k in reversed(range(K)):
        k_of = torch.where(leaf == slots[k], k, k_of)
    live = k_of < K * F * B
    f_iota = torch.arange(F, device=dev)[:, None]
    flat = torch.where(live[None, :],
                       (f_iota * B + bins_t.long()) * K + k_of[None, :],
                       F * B * K).reshape(-1)
    return flat, int(live.sum().item())


def _hist_f64(bins_t, stats, leaf, slots, B):
    """[K, F, B, 3] f64 histogram of float stats (the reference of the
    root operands; distinct live slot ids)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    F, n = bins_t.shape
    K = slots.shape[0]
    S = stats.shape[0]
    flat, _ = _flat_index(bins_t, leaf, slots, B)
    vals = stats.double().T[None].expand(F, -1, -1).reshape(-1, S)
    out = torch.zeros(F * B * K + 1, S, device=bins_t.device,
                      dtype=torch.float64).index_add_(0, flat, vals)
    return H._unpack_hist(out[:-1].view(F, B, K, S).permute(3, 2, 0, 1),
                          "hilo")


def _random_slots(learner, gen):
    """Leaf ids over the learner's L leaves and K distinct slot leaves,
    one of them dead."""
    import torch

    dev = learner.bins_t.device
    n = learner.bins_t.shape[1]
    K = learner.params.split_batch
    L = learner.params.num_leaves
    leaf = torch.randint(0, L, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    slots = torch.randperm(L, generator=gen, device=dev)[:K].to(torch.int32)
    slots[K // 2] = -1
    return leaf, slots.contiguous()


def check_hist_int(learner, gen, operands):
    """Phase 4, kernel B1's integer variant at the int8 path's shapes
    (operands as check_hist's), bitwise."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    bins_t = learner.bins_t
    F, n = bins_t.shape
    B = learner.num_bins
    K = learner.params.split_batch
    stats = _int8_stats(learner, gen)
    leaf, slots = _slots_of(learner, gen, operands)
    raw_k = H.hist_batched_kernel(bins_t, stats, leaf, slots, B)
    raw_p = H.hist_batched_plain(bins_t, stats, leaf, slots, B)
    torch.cuda.synchronize()
    if not torch.equal(raw_k, raw_p):
        fail(f"hist_batched (int8, {operands}) differs from its twin: max "
             f"err {(raw_k - raw_p).abs().max().item()}")
    lib_ms, m = _index_add_ms(bins_t, stats, leaf, slots, B)
    ms = device_ms(lambda: H.hist_batched_kernel(bins_t, stats, leaf, slots,
                                                 B), 20)
    event_ms = cuda_ms(lambda: H.hist_batched_kernel(bins_t, stats, leaf,
                                                     slots, B), 20)
    plain_ms = cuda_ms(
        lambda: H.hist_batched_plain(bins_t, stats, leaf, slots, B), 5)
    S = 3
    return {"name": "hist_batched_int", "operands": operands, "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/histogram.cu",
            "replaces": "lightgbm_tpu/ops/histogram.py:584",
            "max_abs_err": 0.0, "max_rel_err": 0.0, "tolerance": "bitwise",
            "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            **_hist_bound(n, m, F, S, 1, K, F * B * K * S, PEAK_ALU_S),
            "library_ms": lib_ms,
            "shape": f"bins [{F}, {n}] u8, stats [3, {n}] int8, K={K}, "
                     f"B={B}, live rows {m}"}


def _fused_operands(learner, gen):
    """Kernel B2's operands at the int8 path's shapes: K parent leaves
    k and K + k, each split in two, the smaller child histogrammed.
    Returns (positional args, split_kw)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    dev = learner.bins_t.device
    bins_t = learner.bins_t
    F, n = bins_t.shape
    B = learner.num_bins
    K = learner.params.split_batch
    p = learner.params
    stats = _int8_stats(learner, gen)
    leaf = torch.randint(0, 2 * K, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    pairs = torch.arange(2 * K, device=dev, dtype=torch.int32)

    def hist_of(ids):
        return H._unpack_hist(H.hist_batched_plain(
            bins_t, stats, leaf, ids.contiguous(), B).permute(3, 2, 0, 1),
            "int8")

    left, right = hist_of(pairs[:K]), hist_of(pairs[K:])
    parent = (left + right).contiguous()
    small_left = torch.rand(K, generator=gen, device=dev) < 0.5
    slots = torch.where(small_left, pairs[:K], pairs[K:]).to(torch.int32)
    slots[K // 3] = -1                                   # a dead slot
    scales = torch.tensor([0.01, 0.004, 1.0], device=dev)
    tot = torch.cat([left, right])[:, 0].sum(1).float() * scales  # [2K, 3]
    ctx = torch.zeros((2 * K + 1, 8), device=dev)
    ctx[:2 * K, :3] = tot
    ctx[:2 * K, 3] = -1e30
    ctx[:2 * K, 4] = 1e30
    ctx[:2 * K, 5] = torch.cat([small_left, ~small_left]).float()
    ctx[2 * K, :3] = scales
    meta = learner.meta
    zi = torch.zeros(F, dtype=torch.int32, device=dev)
    meta_i = torch.stack([meta["num_bin"], meta["missing_type"],
                          meta["default_bin"], meta["monotone"], zi, zi, zi,
                          zi], 1).to(torch.int32).contiguous()
    zf = torch.zeros(F, device=dev)
    meta_f = torch.stack([meta["penalty"], learner.feature_mask, zf, zf, zf,
                          zf, zf, zf], 1).contiguous()
    kw = dict(l1=p.l1, l2=p.l2, max_delta_step=p.max_delta_step,
              min_data_in_leaf=p.min_data_in_leaf,
              min_sum_hessian=p.min_sum_hessian,
              min_gain_to_split=p.min_gain_to_split)
    return (bins_t, stats, leaf, slots, parent, ctx, meta_i, meta_f, B,
            "int8"), kw


def check_fused(learner, gen):
    """Phase 4, kernel B2 at `_fused_operands`' operands."""
    import torch
    from lightgbm_tpu_torch.ops import fused

    bins_t = learner.bins_t
    F, n = bins_t.shape
    B = learner.num_bins
    K = learner.params.split_batch
    args, kw = _fused_operands(learner, gen)
    leaf, slots = args[2], args[3]
    got = fused.fused_hist_scan_kernel(*args, split_kw=kw)
    ref = fused.fused_hist_scan_plain(*args, split_kw=kw)
    torch.cuda.synchronize()
    try:
        fused.assert_fused_equal(got, ref)
    except RuntimeError as exc:
        fail(str(exc))
    if not bool((ref[1][..., 0] > 0).any()):
        fail("fused_hist_scan check found no split: its operands are "
             "degenerate")
    ms = device_ms(lambda: fused.fused_hist_scan_kernel(*args, split_kw=kw),
                   20)
    event_ms = cuda_ms(
        lambda: fused.fused_hist_scan_kernel(*args, split_kw=kw), 20)
    plain_ms = cuda_ms(
        lambda: fused.fused_hist_scan_plain(*args, split_kw=kw), 3)
    m = int((slots[:, None] == leaf[None, :]).any(0).sum().item())
    C = 2 * K
    # each input read once, each output written once: every leaf id, the
    # bins and stats of the live rows, slots, parents, ctx, meta;
    # histograms and records (earlier versions: every row's bins and
    # stats)
    rest = 4 * K + 2 * K * F * B * 12 + (C + 1) * 32 + F * 64 + C * F * 32
    nbytes = 4 * n + m * (F + 3) + rest
    nbytes_all = 4 * n + n * (F + 3) + rest
    # histogram adds, then about 100 f32 operations per (child, feature,
    # bin) in the scan (prefix sums, dequantization, both directions'
    # leaf outputs, clips and gains)
    ops = m * F * 3 + C * F * B * 100
    return {"name": "fused_hist_scan", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/fused.cu",
            "replaces": "lightgbm_tpu/ops/fused.py:221",
            "max_abs_err": 0.0, "max_rel_err": 0.0, "tolerance": "bitwise",
            "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            **_bound(nbytes, ops, PEAK_F32_S), "library_ms": None,
            "bound_ms_all_rows": _bound(nbytes_all, ops,
                                        PEAK_F32_S)["bound_ms"],
            "shape": f"bins [{F}, {n}] u8, stats [3, {n}] int8, K={K}, "
                     f"B={B}, 2K children, live rows {m}"}


def check_flat(learner, gen):
    """Phase 4, kernel B4 at the flat path's shapes: hilo within the
    summation-order tolerance (timed), int8 bitwise."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    bins_t = learner.bins_t
    F, n = bins_t.shape
    B = learner.num_bins
    K = learner.params.split_batch
    stats, g, h = _hilo_stats(learner, gen)
    leaf, slots = _random_slots(learner, gen)
    hk = H._unpack_hist(H.hist_flat_kernel(bins_t, stats, leaf, slots, B)
                        .permute(3, 2, 0, 1), "hilo")
    hp = H._unpack_hist(H.hist_batched_plain(bins_t, stats, leaf, slots, B)
                        .permute(3, 2, 0, 1), "hilo")
    torch.cuda.synchronize()
    err, rel = _hist_rel_err(hk, hp, g, h, leaf, slots)
    st8 = _int8_stats(learner, gen)
    if not torch.equal(H.hist_flat_kernel(bins_t, st8, leaf, slots, B),
                       H.hist_batched_plain(bins_t, st8, leaf, slots, B)):
        fail("hist_flat (int8) differs from its twin")
    lib_ms, m = _index_add_ms(bins_t, stats, leaf, slots, B)
    ms = device_ms(lambda: H.hist_flat_kernel(bins_t, stats, leaf, slots, B),
                   10)
    event_ms = cuda_ms(lambda: H.hist_flat_kernel(bins_t, stats, leaf,
                                                  slots, B), 10)
    plain_ms = cuda_ms(
        lambda: H.hist_batched_plain(bins_t, stats, leaf, slots, B), 5)
    S = stats.shape[0]
    return {"name": "hist_flat", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/histogram.cu",
            "replaces": "lightgbm_tpu/ops/histogram.py:541",
            "max_abs_err": err, "max_rel_err": rel,
            "tolerance": f"counts exact, g/h rel {HIST_RTOL:g}; int8 bitwise",
            "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            **_hist_bound(n, m, F, S, 2, K, F * B * K * S, PEAK_F32_S),
            "library_ms": lib_ms,
            "shape": f"bins [{F}, {n}] u8, stats [{S}, {n}] bf16, K={K}, "
                     f"B={B}, live rows {m}"}


def cross_check(lgb, X, y):
    """Phase 5: the card against the CPU path at a reduced size."""
    Xs, ys = X[:N_SMALL], y[:N_SMALL]
    rng = np.random.default_rng(43)
    y_reg = Xs[:, 0] + 0.5 * Xs[:, 1] * Xs[:, 2] + 0.3 * rng.normal(
        size=N_SMALL)
    runs = {"hilo": (PARAMS, ys), "int8_binary": (PATHS[1][1], ys),
            "int8_regression": (dict(PARAMS, objective="regression",
                                     metric="l2", tpu_hist_precision="int8",
                                     tpu_quant_refit_leaves=False), y_reg)}
    out = {}
    texts = {}
    for name, (params, label) in runs.items():
        for dev in ("cuda", "cpu"):
            p = dict(params, device_type=dev)
            t0 = time.perf_counter()
            b = lgb.train(p, lgb.Dataset(Xs, label=label, params=p),
                          num_boost_round=ITERS_SMALL)
            if name == "int8_regression":
                texts[dev] = b.model_to_string().split("parameters:")[0]
            else:
                out[f"{name}_{dev}_auc"] = auc(b.predict(Xs, raw_score=True),
                                               ys)
            out[f"{name}_{dev}_s"] = time.perf_counter() - t0
        if name != "int8_regression":
            diff = abs(out[f"{name}_cuda_auc"] - out[f"{name}_cpu_auc"])
            out[f"{name}_auc_diff"] = diff
            if diff > AUC_TOL:
                fail(f"{name}: card and CPU AUC differ by {diff} > {AUC_TOL}")
    out["int8_regression_text_identical"] = texts["cuda"] == texts["cpu"]
    if not out["int8_regression_text_identical"]:
        fail("int8 regression: the card's model text differs from the CPU's")
    return out


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch.ops import kernels
    except ImportError as exc:
        fail(f"lightgbm_tpu_torch is not importable next to this script "
             f"({exc})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    kernels.library()
    print(f"kernels built in {kernels.build_seconds:.2f} s", flush=True)
    print(kernels.build_log.strip(), flush=True)

    X, y = make_data(N_TRAIN + N_HOLD, N_FEAT)
    t0 = time.perf_counter()
    ds = lgb.Dataset(X[:N_TRAIN], label=y[:N_TRAIN],
                     params=dict(PARAMS)).construct()
    torch.cuda.synchronize()
    print(f"ingest_s {time.perf_counter() - t0:.3f}", flush=True)
    reports, boosters = {}, {}
    for name, params, iters, must in PATHS:
        reports[name], boosters[name] = main_path(lgb, kernels, ds, X, y,
                                                  params, iters, must)
        print(f"main path {name} " + json.dumps(reports[name]), flush=True)
        if "--profile" in sys.argv[1:] and name != "flat":
            print(f"profile {name} " + json.dumps(profile(boosters[name])),
                  flush=True)

    gen = torch.Generator(device="cuda").manual_seed(7)
    learners = {k: b._driver.learner for k, b in boosters.items()}
    # (row, the path whose launches it reports)
    kernel_rows = [(check_hist(learners["hilo"], gen, "random"), "hilo"),
                   (check_hist(learners["hilo"], gen, "root"), "hilo"),
                   (check_hist_int(learners["int8"], gen, "random"), "int8"),
                   (check_hist_int(learners["int8"], gen, "root"), "int8"),
                   (check_fused(learners["int8"], gen), "int8"),
                   (check_partition(learners["hilo"], gen), "hilo"),
                   (check_flat(learners["flat"], gen), "flat")]
    for row, path in kernel_rows:
        row["launches"] = reports[path]["launches"][row["name"]]
        row["launches_per_tree"] = reports[path]["launches_per_tree"][
            row["name"]]
        row["path"] = path
        print("kernel " + json.dumps(row), flush=True)
    kernel_rows = [row for row, _ in kernel_rows]
    del boosters, learners

    cross = cross_check(lgb, X, y)
    print("cross-check " + json.dumps(cross), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # B1 and B1-int have two rows: random operands, then the root's
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **({"operands": r["operands"]} if "operands" in r else {})}
        for r in kernel_rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
