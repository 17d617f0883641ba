#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card: the quickest proof
that the port still starts on the GPU.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (exit code 1, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from lightgbm_tpu_torch/csrc with nvcc;
  3. the main path at full width: lgb.train on the Higgs-1M shape
     (1,000,000 rows x 28 dense features, binary, 255 leaves, 255 bins,
     hilo histograms, tpu_partition_impl=kernel) for a few iterations,
     then predict 100,000 held-out rows; every kernel launch counter must
     be > 0 after it;
  4. each kernel against its plain PyTorch twin on the card, at the
     shapes the main path gives it, with times, the bound and, where one
     exists, one PyTorch library call computing the same function;
  5. the card against the CPU path at a reduced size (50,000 rows).
With --profile, two more iterations run under torch.profiler and the
device time by op and the device's idle share are printed.
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


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main_path(lgb, kernels, X, y):
    """Phase 3: train + predict at full width; returns the report."""
    import torch

    Xtr, ytr = X[:N_TRAIN], y[:N_TRAIN]
    Xho, yho = X[N_TRAIN:], y[N_TRAIN:]
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xtr, label=ytr, params=dict(PARAMS)).construct()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    booster = lgb.train(dict(PARAMS), ds, num_boost_round=ITERS)
    trees = booster.num_trees()       # materializes: one records fetch
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    driver = booster._driver
    train_auc = [v for _, name, v, _ in booster.eval_train()
                 if name == "auc"][0]
    t0 = time.perf_counter()
    pred = booster.predict(Xho)
    predict_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if trees != ITERS:
        fail(f"trained {trees} trees, expected {ITERS}")
    if not np.all(np.isfinite(pred)) or pred.shape != (N_HOLD,):
        fail(f"held-out predictions: shape {pred.shape}, finite "
             f"{bool(np.all(np.isfinite(pred)))}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched on the main path")
    hold_auc = auc(pred, yho)
    if not 0.6 < train_auc <= 1.0 or not 0.6 < hold_auc <= 1.0:
        fail(f"AUC out of range: train {train_auc}, held-out {hold_auc}")
    return {"ingest_s": ingest_s, "train_s": train_s,
            "iters_per_s": ITERS / train_s, "train_auc": train_auc,
            "holdout_auc": hold_auc, "predict_s": predict_s,
            "predict_rows_per_s": N_HOLD / predict_s,
            "host_syncs_per_tree": driver.grower_syncs / trees,
            "launches_per_tree": {k: v / trees for k, v in launches.items()},
            "launches": launches, "n_pad": driver.learner.n_pad,
            "f_pad": driver.learner.f_pad,
            "split_batch": driver.learner.params.split_batch}, booster


def profile(booster, iters=2):
    """`--profile`: where the time of `iters` more iterations goes, from
    torch.profiler's device trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            booster.update()
        booster.num_trees()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    return {"iters": iters, "wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "top": [{"kernel": k[:70], "calls": c, "device_ms": d / 1e3}
                    for d, k, c in rows[:12]]}


def check_hist(learner, gen):
    """Phase 4, kernel B1 at the main path's shapes."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    dev = learner.bins_t.device
    bins_t = learner.bins_t
    F, n = bins_t.shape
    B = learner.num_bins
    K = learner.params.split_batch
    L = learner.params.num_leaves
    g = torch.randn(n, generator=gen, device=dev) * 0.5
    h = torch.rand(n, generator=gen, device=dev) * 0.25
    g, h = g * learner._ones_mask, h * learner._ones_mask
    stats = H.pack_stats(g, h, learner._ones_mask, "hilo").contiguous()
    leaf = torch.randint(0, L, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    slots = torch.randperm(L, generator=gen, device=dev)[:K].to(torch.int32)
    slots[K // 2] = -1                                   # a dead slot
    slots = slots.contiguous()
    raw_k = H.hist_batched_kernel(bins_t, stats, leaf, slots, B)
    raw_p = H.hist_batched_plain(bins_t, stats, leaf, slots, B)
    torch.cuda.synchronize()
    hk = H._unpack_hist(raw_k.permute(3, 2, 0, 1), "hilo")
    hp = H._unpack_hist(raw_p.permute(3, 2, 0, 1), "hilo")
    err = (hk - hp).abs()
    # per slot: sum of |g| and |h| over its rows (each row lands in one
    # bin of every feature)
    match = (slots[:, None] == leaf[None, :]).float()
    tol = HIST_RTOL * torch.stack([match @ g.abs(), match @ h.abs()], 1)
    ok_cnt = bool(torch.equal(hk[..., 2], hp[..., 2]))
    ok_gh = bool((err[..., :2] <= tol[:, None, None, :]).all())
    # g/h error relative to the slot's sum of |stat|, the tolerance's scale
    rel = (err[..., :2] / (tol[:, None, None, :] / HIST_RTOL)
           .clamp(min=1e-30)).max().item()
    if not (ok_cnt and ok_gh):
        fail(f"hist_batched disagrees with its twin: counts equal {ok_cnt}, "
             f"max g/h err {err[..., :2].max().item()}")
    # yardstick: one index_add_ over a precomputed flat
    # (feature, bin, slot) index; unmatched rows add into a spare row
    k_of = torch.full((n,), K * F * B, device=dev, dtype=torch.int64)
    for k in range(K):
        k_of = torch.where(leaf == slots[k], k, k_of)
    live = k_of < K * F * B
    f_iota = torch.arange(F, device=dev)[:, None]
    flat = torch.where(live[None, :],
                       (f_iota * B + bins_t.long()) * K + k_of[None, :],
                       F * B * K).reshape(-1)
    vals = stats.float().T[None].expand(F, -1, -1).reshape(-1, stats.shape[0])
    out = torch.zeros(F * B * K + 1, stats.shape[0], device=dev)
    lib_ms = cuda_ms(lambda: out.index_add_(0, flat, vals), 5)
    ms = cuda_ms(lambda: H.hist_batched_kernel(bins_t, stats, leaf, slots, B),
                 20)
    plain_ms = cuda_ms(
        lambda: H.hist_batched_plain(bins_t, stats, leaf, slots, B), 5)
    m = int(live.sum().item())
    S = stats.shape[0]
    nbytes = F * n + S * n * 2 + n * 4 + K * 4 + F * B * K * S * 4
    ops = m * F * S
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return {"name": "hist_batched", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/histogram.cu",
            "replaces": "lightgbm_tpu/ops/histogram.py:584",
            "max_abs_err": float(err.max().item()), "max_rel_err": rel,
            "tolerance": f"counts exact, g/h rel {HIST_RTOL:g}", "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "shape": f"bins [{F}, {n}] u8, stats [{S}, {n}] bf16, K={K}, "
                     f"B={B}, matched rows {m}"}


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
    ms = cuda_ms(lambda: fused.partition_rows_kernel(*args), 20)
    plain_ms = cuda_ms(lambda: fused.partition_rows_plain(*args), 5)
    m = int(((leaf[None, :] == sel[:, None]) & do_k[:, None]).sum().item())
    nbytes = n * 4 + n * 4 + m + K * 9 * 4
    ops = n * K * 2
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_ALU_S
    return {"name": "partition_rows", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/partition.cu",
            "replaces": "lightgbm_tpu/ops/fused.py:296",
            "max_abs_err": float(err), "max_rel_err": float(err),
            "tolerance": "bitwise", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "shape": f"bins [{F}, {n}] u8, leaf [{n}] i32, K={K}, "
                     f"rows of splitting leaves {m}"}


def cross_check(lgb, X, y):
    """Phase 5: the card against the CPU path at a reduced size."""
    Xs, ys = X[:N_SMALL], y[:N_SMALL]
    out = {}
    for dev in ("cuda", "cpu"):
        p = dict(PARAMS, device_type=dev)
        t0 = time.perf_counter()
        b = lgb.train(p, lgb.Dataset(Xs, label=ys, params=p),
                      num_boost_round=ITERS_SMALL)
        out[dev] = auc(b.predict(Xs, raw_score=True), ys)
        out[dev + "_s"] = time.perf_counter() - t0
    out["auc_diff"] = abs(out["cuda"] - out["cpu"])
    if out["auc_diff"] > AUC_TOL:
        fail(f"card and CPU AUC differ by {out['auc_diff']} > {AUC_TOL}")
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
    report, booster = main_path(lgb, kernels, X, y)
    print("main path " + json.dumps(report), flush=True)

    if "--profile" in sys.argv[1:]:
        print("profile " + json.dumps(profile(booster)), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(7)
    learner = booster._driver.learner
    kernel_rows = [check_hist(learner, gen), check_partition(learner, gen)]
    for row in kernel_rows:
        row["launches"] = report["launches"][row["name"]]
        print("kernel " + json.dumps(row), flush=True)
    del booster, learner

    cross = cross_check(lgb, X, y)
    print("cross-check " + json.dumps(cross), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernel_rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
