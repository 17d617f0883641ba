"""lightgbm_tpu_torch's CUDA kernels against their plain PyTorch twins.

Every test here needs the card and skips without one.  The file imports
neither JAX nor lightgbm_tpu, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import re

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import fused as TF
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import kernels

from .test_torch_util import cuda_device, fused_args, fused_case

pytestmark = pytest.mark.cuda


def _hist_inputs(dev, seed, F, n, B, leaves, slots, precision):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = (np.abs(rng.normal(size=n)) * 0.3 + 0.05).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-50:] = 0.0
    stats = TH.pack_stats(torch.from_numpy(g * mask), torch.from_numpy(h * mask),
                          torch.from_numpy(mask), precision)
    leaf = rng.integers(0, leaves, size=n).astype(np.int32)
    t = (torch.from_numpy(bins).to(dev), stats.to(dev).contiguous(),
         torch.from_numpy(leaf).to(dev),
         torch.tensor(slots, dtype=torch.int32, device=dev))
    return t, float(np.abs(g).sum()), float(np.abs(h).sum())


@pytest.mark.parametrize("precision", ["hilo", "bf16", "f32"])
@pytest.mark.parametrize("F,n,B,leaves,slots", [
    # full-width geometry: one feature per block, K=25 with a dead slot
    (32, 1 << 18, 255, 60, list(range(0, 48, 2)) + [-1]),
    # small bins: many features per block, B not a multiple of 8
    (7, 5000, 13, 5, [3, -1, 0]),
    # K=50 at 255 bins overflows one block's shared memory: slot chunks
    (8, 1 << 16, 255, 120, list(range(0, 100, 2))),
])
def test_hist_kernel_matches_twin(precision, F, n, B, leaves, slots):
    dev = cuda_device()
    args, sg, sh = _hist_inputs(dev, 1, F, n, B, leaves, slots, precision)
    before = kernels.launches["hist_batched"]
    got = TH._unpack_hist(TH.hist_batched_kernel(*args, B).permute(3, 2, 0, 1),
                          precision).cpu().numpy()
    assert kernels.launches["hist_batched"] == before + 1
    ref = TH._unpack_hist(TH.hist_batched_plain(*args, B).permute(3, 2, 0, 1),
                          precision).cpu().numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    # f32 sums taken in another order: within 1e-6 of the sum of |stat|
    assert np.abs(got[..., 0] - ref[..., 0]).max() <= 1e-6 * sg
    assert np.abs(got[..., 1] - ref[..., 1]).max() <= 1e-6 * sh
    # dead slots stay zero
    assert not got[np.asarray(slots) < 0].any()


def test_hist_kernel_refuses_bad_inputs():
    dev = cuda_device()
    args, _, _ = _hist_inputs(dev, 2, 4, 1000, 16, 3, [0, 1], "hilo")
    bins, stats, leaf, slots = args
    with pytest.raises(ValueError, match="uint8 or int32"):
        TH.hist_batched_kernel(bins.short(), stats, leaf, slots, 16)
    with pytest.raises(ValueError, match="contiguous"):
        TH.hist_batched_kernel(bins, stats[:, ::2], leaf[::2], slots, 16)
    with pytest.raises(ValueError, match="num_bins"):
        TH.hist_batched_kernel(bins, stats, leaf, slots, 300)


def test_partition_kernel_matches_twin():
    dev = cuda_device()
    rng = np.random.default_rng(3)
    F, n, K, leaves = 30, 1 << 16, 25, 60
    num_bin = rng.integers(4, 256, size=F).astype(np.int32)
    bins = np.stack([rng.integers(0, nb, size=n) for nb in num_bin]
                    ).astype(np.uint8)
    feat = rng.integers(0, F, size=K).astype(np.int32)
    mt = (np.arange(K) % 3).astype(np.int32)
    db = np.array([rng.integers(0, num_bin[f]) for f in feat], np.int32)
    thr = np.array([rng.integers(0, num_bin[f] - 1) for f in feat], np.int32)
    c = [bins, feat, rng.integers(0, leaves, size=n).astype(np.int32),
         rng.permutation(leaves)[:K].astype(np.int32),
         (leaves + np.arange(K)).astype(np.int32), thr, rng.random(K) < 0.5,
         mt, num_bin[feat], db, np.arange(K) < K - 3]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in c]
    before = kernels.launches["partition_rows"]
    got = TF.partition_rows_kernel(*args).cpu().numpy()
    assert kernels.launches["partition_rows"] == before + 1
    ref = TF.partition_rows_plain(*args).cpu().numpy()
    np.testing.assert_array_equal(got, ref)


def test_training_on_card_matches_cpu():
    import lightgbm_tpu_torch as lgb

    cuda_device()
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20000, 10))
    y = (X[:, 0] ** 2 + X[:, 1] - 1 + rng.logistic(size=20000) > 0
         ).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
         "tpu_partition_impl": "kernel", "verbosity": -1}
    kernels.reset_launches()
    gpu = lgb.train(dict(p), lgb.Dataset(X, label=y), num_boost_round=3,
                    keep_training_booster=True)
    # the hilo path: B1 and B3
    assert kernels.launches["hist_batched"] > 0
    assert kernels.launches["partition_rows"] > 0
    cpu = lgb.train(dict(p, device_type="cpu"), lgb.Dataset(X, label=y),
                    num_boost_round=3)
    pg, pc = gpu.predict(X), cpu.predict(X)
    assert np.isfinite(pg).all()
    # the trees may differ where an exact f32 tie between split gains
    # flips with the summation order; the predictions stay close
    assert np.abs(pg - pc).mean() < 1e-3


# ---- the quantized path: B1's integer variant, B2, and B4 ----------------

@pytest.mark.parametrize("precision", ["int8", "int16"])
@pytest.mark.parametrize("F,n,B,leaves,slots", [
    (32, 1 << 18, 255, 60, list(range(0, 48, 2)) + [-1]),
    (7, 5000, 13, 5, [3, -1, 0]),
    (8, 1 << 16, 255, 120, list(range(0, 100, 2))),
])
def test_hist_kernel_int_bitwise(precision, F, n, B, leaves, slots):
    dev = cuda_device()
    args = _int_hist_inputs(dev, 4, F, n, B, leaves, slots, precision)
    before = kernels.launches["hist_batched_int"]
    got = TH.hist_batched_kernel(*args, B)
    assert kernels.launches["hist_batched_int"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, TH.hist_batched_plain(*args, B))


def _int_hist_inputs(dev, seed, F, n, B, leaves, slots, precision):
    rng = np.random.default_rng(seed)
    q = TH.quant_limit(precision, n)
    g = rng.integers(-q, q + 1, size=n)
    h = rng.integers(0, q + 1, size=n)
    mask = np.ones(n, np.int64)
    mask[-50:] = 0
    stats = TH.pack_stats(torch.from_numpy(g * mask),
                          torch.from_numpy(h * mask),
                          torch.from_numpy(mask), precision)
    return (torch.from_numpy(rng.integers(0, B, size=(F, n))
                             .astype(np.uint8)).to(dev),
            stats.to(dev).contiguous(),
            torch.from_numpy(rng.integers(0, leaves, size=n)
                             .astype(np.int32)).to(dev),
            torch.tensor(slots, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("precision", ["hilo", "f32", "int8", "int16"])
@pytest.mark.parametrize("F,n,B,leaves,slots", [
    (32, 1 << 17, 255, 60, list(range(0, 48, 2)) + [-1]),
    (7, 5000, 13, 5, [3, -1, 0]),
    # the root call on the flat path's row count: every row in slot 0
    (32, 1_000_192, 255, 1, [0] + [-1] * 24),
])
def test_flat_kernel_matches_twin(precision, F, n, B, leaves, slots):
    dev = cuda_device()
    # B4 is the grouped body under its own instance, counted per variant
    name = "hist_flat_int" if precision.startswith("int") else "hist_flat"
    before = kernels.launches[name]
    if precision.startswith("int"):
        args = _int_hist_inputs(dev, 5, F, n, B, leaves, slots, precision)
        got = TH.hist_flat_kernel(*args, B)
        assert torch.equal(got, TH.hist_batched_plain(*args, B))
    else:
        args, sg, sh = _hist_inputs(dev, 5, F, n, B, leaves, slots,
                                    precision)
        got = TH._unpack_hist(TH.hist_flat_kernel(*args, B)
                              .permute(3, 2, 0, 1), precision).cpu().numpy()
        ref = TH._unpack_hist(TH.hist_batched_plain(*args, B)
                              .permute(3, 2, 0, 1), precision).cpu().numpy()
        np.testing.assert_array_equal(got[..., 2], ref[..., 2])
        # f32 atomics in arrival order: B1's HIST_RTOL
        assert np.abs(got[..., 0] - ref[..., 0]).max() <= 1e-6 * sg
        assert np.abs(got[..., 1] - ref[..., 1]).max() <= 1e-6 * sh
    assert kernels.launches[name] == before + 1


@pytest.mark.parametrize("precision", ["int8", "int16"])
@pytest.mark.parametrize("F,n,B,K,dead,extra", [
    (32, 1 << 18, 255, 25, (7, 24), {}),
    (28, 1 << 16, 63, 4, (), dict(l2=1.0, min_data=20.0)),
    (5, 3000, 13, 3, (1,), dict(l1=0.5, mds=0.3)),
    (8, 1 << 16, 255, 50, (0,), {}),
])
def test_fused_kernel_bitwise(precision, F, n, B, K, dead, extra):
    dev = cuda_device()
    case, kw = fused_case(6, F, n, B, K, precision, dead, **extra)
    ops = fused_args(case, B, precision, dev)
    before = kernels.launches["fused_hist_scan"]
    got = TF.fused_hist_scan_kernel(*ops, split_kw=kw)
    assert kernels.launches["fused_hist_scan"] == before + 1
    ref = TF.fused_hist_scan_plain(*ops, split_kw=kw)
    TF.assert_fused_equal(got, ref)
    # the scan found real splits, not only the -1e30 sentinel
    assert (ref[1][..., 0] > 0).any()


# ---- bagged operands: rows with zero stats (a bagging mask with about
# 20% of the rows out) and masked features (feature_fraction 0.8) --------

@pytest.mark.parametrize("precision", ["int8", "int16"])
def test_hist_kernel_int_bagged_bitwise(precision):
    dev = cuda_device()
    F, n, B, leaves = 28, 1 << 18, 255, 60
    slots = list(range(0, 48, 2)) + [-1]
    bins, stats, leaf, sl = _int_hist_inputs(dev, 8, F, n, B, leaves, slots,
                                             precision)
    keep = torch.from_numpy(np.random.default_rng(9).random(n) >= 0.2)
    stats = (stats * keep.to(dev).to(stats.dtype)).contiguous()
    assert 0.15 < 1.0 - float(stats[2].float().mean()) < 0.25
    before = kernels.launches["hist_batched_int"]
    got = TH.hist_batched_kernel(bins, stats, leaf, sl, B)
    assert kernels.launches["hist_batched_int"] == before + 1
    assert torch.equal(got, TH.hist_batched_plain(bins, stats, leaf, sl, B))


@pytest.mark.parametrize("precision", ["int8", "int16"])
@pytest.mark.parametrize("F,n,B,K,dead", [
    (28, 1 << 18, 255, 25, (7, 24)),
    (32, 1 << 16, 63, 4, ()),
])
def test_fused_kernel_bagged_bitwise(precision, F, n, B, K, dead):
    dev = cuda_device()
    case, kw = fused_case(11, F, n, B, K, precision, dead, bag=0.2)
    assert 0.15 < 1.0 - case["stats"][2].mean() < 0.25
    assert (case["meta_f"][:, 1] == 0).sum() >= 2
    ops = fused_args(case, B, precision, dev)
    before = kernels.launches["fused_hist_scan"]
    got = TF.fused_hist_scan_kernel(*ops, split_kw=kw)
    assert kernels.launches["fused_hist_scan"] == before + 1
    ref = TF.fused_hist_scan_plain(*ops, split_kw=kw)
    TF.assert_fused_equal(got, ref)
    assert (ref[1][..., 0] > 0).any()


def test_bagged_int8_training_on_card_matches_cpu():
    import lightgbm_tpu_torch as lgb

    cuda_device()
    rng = np.random.default_rng(2)
    X = rng.normal(size=(24000, 10))
    Xn = X.copy()
    X[rng.random(X.shape) < 0.03] = np.nan
    y = Xn[:, 0] + Xn[:, 1] ** 2 + 0.3 * rng.normal(size=24000)
    p = {"objective": "regression", "num_leaves": 63, "max_bin": 63,
         "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
         "tpu_partition_impl": "kernel", "verbosity": -1,
         "learning_rate": 0.5, "bagging_fraction": 0.8, "bagging_freq": 1,
         "feature_fraction": 0.8}
    out = {}
    for dev in ("cuda", "cpu"):
        train = lgb.Dataset(X[:20000], label=y[:20000],
                            params=dict(p, device_type=dev))
        valid = train.create_valid(X[20000:], label=y[20000:])
        evals = {}
        b = lgb.train(dict(p, device_type=dev), train, 6,
                      valid_sets=[valid], evals_result=evals,
                      early_stopping_rounds=2, verbose_eval=False)
        out[dev] = (_norm(b.model_to_string(), "device_type"), evals,
                    b.best_iteration)
    assert np.isfinite(out["cpu"][1]["valid_0"]["l2"]).all()
    assert out["cuda"] == out["cpu"]


def test_fused_probe_raises_on_a_corrupted_record():
    dev = cuda_device()
    TF.probe_fused(dev, "int8")           # passes on the card
    args, kw = TF.probe_operands("int8", dev)
    hist, rec = TF.fused_hist_scan_kernel(*args, split_kw=kw)
    ref = TF.fused_hist_scan_plain(*args, split_kw=kw)
    bad = rec.clone()
    bad.view(torch.int32)[1, 2, 0] += 1   # one ulp of one gain
    with pytest.raises(RuntimeError, match="records differ"):
        TF.assert_fused_equal((hist, bad), ref)


def test_int8_training_on_card_matches_cpu_text():
    import lightgbm_tpu_torch as lgb

    cuda_device()
    rng = np.random.default_rng(1)
    X = rng.normal(size=(20000, 10))
    X[rng.random(X.shape) < 0.03] = np.nan
    y = X[:, 0] + np.nan_to_num(X[:, 1]) ** 2 + 0.3 * rng.normal(size=20000)
    p = {"objective": "regression", "num_leaves": 63, "max_bin": 63,
         "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
         "tpu_partition_impl": "kernel", "verbosity": -1}
    kernels.reset_launches()
    gpu = lgb.train(dict(p), lgb.Dataset(X, label=y), num_boost_round=3,
                    keep_training_booster=True)
    for name in ("hist_batched_int", "fused_hist_scan", "partition_rows"):
        assert kernels.launches[name] > 0, name
    cpu = lgb.train(dict(p, device_type="cpu"), lgb.Dataset(X, label=y),
                    num_boost_round=3)
    # integer histograms, bitwise kernels, op-by-op f32: the same model
    assert gpu.model_to_string().split("parameters:")[0] == \
        cpu.model_to_string().split("parameters:")[0]


# ---- the grouped kernels' edge cases: B1, B1-int and B2 held to their
# twins (int bitwise, float within 1e-6 of each slot's sum of |stat|) ----

# (name, F, n, B, leaves, slots); leaf ids are drawn from range(leaves)
GROUPED_CASES = [
    # every row in slot 0, the other slots dead: the root call
    ("root", 32, 1 << 17, 255, 1, [0] + [-1] * 24),
    # a leaf id held by two live slots: both get its sums
    ("dup", 32, 50000, 255, 6, [2, 5, 2, -1, 4]),
    # a live slot whose leaf holds no row
    ("empty", 32, 50000, 255, 6, [1, 77, 3]),
    ("all_dead", 32, 20000, 255, 6, [-1, -1, -1]),
    ("k1", 32, 50000, 255, 3, [1]),
    ("b63", 28, 60000, 63, 8, [0, 2, 4, 6, -1]),
    # F not a multiple of the 32-feature chunk
    ("f40", 40, 30000, 255, 5, [0, 1, 2, 3, 4]),
    # n not a multiple of the block's tile nor of the segment
    ("n_odd", 32, 70001, 255, 4, [3, 1, -1, 0]),
    # leaf ids past the grouping's 4096-entry slot table (compared against
    # the slot ids instead), one of them held by two live slots
    ("high_ids", 32, 200000, 255, 5001, [5000, 4097, 5000, -1, 7]),
]


def _slot_abs_sums(leaf, slots, x):
    """Each slot's sum of |x| over its rows (the tolerance's scale)."""
    return np.array([np.abs(x[leaf == s]).sum() if s >= 0 else 0.0
                     for s in slots])


@pytest.mark.parametrize("precision", ["hilo", "int8"])
@pytest.mark.parametrize("case", GROUPED_CASES, ids=lambda c: c[0])
def test_grouped_hist_edge_cases(precision, case):
    _, F, n, B, leaves, slots = case
    dev = cuda_device()
    if precision == "int8":
        args = _int_hist_inputs(dev, 7, F, n, B, leaves, slots, precision)
        before = kernels.launches["hist_batched_int"]
        got = TH.hist_batched_kernel(*args, B)
        assert kernels.launches["hist_batched_int"] == before + 1
        assert torch.equal(got, TH.hist_batched_plain(*args, B))
        return
    args, _, _ = _hist_inputs(dev, 7, F, n, B, leaves, slots, precision)
    got = TH._unpack_hist(TH.hist_batched_kernel(*args, B)
                          .permute(3, 2, 0, 1), precision).cpu().numpy()
    ref = TH._unpack_hist(TH.hist_batched_plain(*args, B)
                          .permute(3, 2, 0, 1), precision).cpu().numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    leaf = args[2].cpu().numpy()
    stats = args[1].float().cpu().numpy()
    for c, (hi, lo) in enumerate(((0, 1), (2, 3))):
        scale = _slot_abs_sums(leaf, slots, stats[hi] + stats[lo])
        err = np.abs(got[..., c] - ref[..., c]).max(axis=(1, 2))
        assert (err <= 1e-6 * scale).all(), (c, err, scale)
    assert not got[np.asarray(slots) < 0].any()


@pytest.mark.parametrize("case", GROUPED_CASES, ids=lambda c: c[0])
def test_grouping_pass_matches_plain(case):
    _, F, n, B, leaves, slots = case
    dev = cuda_device()
    args = _int_hist_inputs(dev, 8, F, n, B, leaves, slots, "int8")
    rows, offsets = TH.hist_group_kernel(*args, B)
    ref_rows, ref_off = TH.group_rows_plain(args[2], args[3])
    assert torch.equal(offsets, ref_off)
    # stable: each slot's rows in row order, as the plain grouping
    assert torch.equal(rows, ref_rows)


@pytest.mark.parametrize("name,F,n,B,K,slots", [
    ("root", 32, 1 << 17, 255, 25, [0] + [-1] * 24),
    ("dup", 32, 50000, 255, 4, [2, 5, 2, -1]),
    ("empty", 32, 50000, 255, 3, [1, 77, 3]),
    ("all_dead", 32, 20000, 255, 3, [-1, -1, -1]),
    ("k1", 32, 50000, 255, 1, [1]),
    ("b63", 28, 60000, 63, 5, [0, 2, 4, 6, -1]),
    ("f40", 40, 30000, 255, 5, [0, 1, 2, 3, 4]),
    ("n_odd", 32, 70001, 255, 4, [3, 1, -1, 0]),
    # leaf ids 4090-4101: 4097 and 4099 past the slot table, 4097 twice
    ("high_ids", 32, 50000, 255, 4, [4097, 4092, 4097, 4099]),
])
def test_fused_kernel_edge_cases(name, F, n, B, K, slots):
    dev = cuda_device()
    case, kw = fused_case(9, F, n, B, K, "int8")
    case["slots"] = np.asarray(slots, np.int32)
    if name == "root":
        case["leaf"] = np.zeros(n, np.int32)
    if name == "high_ids":
        case["leaf"] = case["leaf"] + 4090
    ops = fused_args(case, B, "int8", dev)
    got = TF.fused_hist_scan_kernel(*ops, split_kw=kw)
    ref = TF.fused_hist_scan_plain(*ops, split_kw=kw)
    TF.assert_fused_equal(got, ref)


# ---- B1 on packed 4-bit bins, and the leaf refit's sums ------------------

# (name, F, n, B, leaves, slots, block): n a whole number of blocks
PACKED_CASES = [
    ("path", 32, 1 << 18, 16, 60, list(range(0, 48, 2)) + [-1], 8192),
    ("root", 32, 1 << 17, 15, 1, [0] + [-1] * 24, 8192),
    ("small", 7, 5120, 13, 5, [3, -1, 0], 512),
    ("f40", 40, 30720, 15, 5, [0, 1, 2, 3, 4], 1024),
    ("dup", 32, 51200, 16, 6, [2, 5, 2, -1, 4], 256),
]


@pytest.mark.parametrize("precision", ["hilo", "int8", "int16"])
@pytest.mark.parametrize("case", PACKED_CASES, ids=lambda c: c[0])
def test_hist_kernel_packed_matches_twin(precision, case):
    _, F, n, B, leaves, slots, block = case
    dev = cuda_device()
    if precision == "hilo":
        args, _, _ = _hist_inputs(dev, 10, F, n, 16, leaves, slots,
                                  precision)
    else:
        args = _int_hist_inputs(dev, 10, F, n, 16, leaves, slots, precision)
    # bins drawn below 16, some of them >= B: they add nothing
    packed = TH.pack_bins(args[0], block)
    args = (packed,) + args[1:]
    name = "hist_batched_packed" + ("" if precision == "hilo" else "_int")
    before = kernels.launches[name]
    got = TH.hist_batched_kernel(*args, B, packed_block=block)
    assert kernels.launches[name] == before + 1
    ref = TH.hist_batched_plain(*args, B, packed_block=block)
    if precision != "hilo":
        assert torch.equal(got, ref)
        return
    got = TH._unpack_hist(got.permute(3, 2, 0, 1), precision).cpu().numpy()
    ref = TH._unpack_hist(ref.permute(3, 2, 0, 1), precision).cpu().numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    leaf = args[2].cpu().numpy()
    stats = args[1].float().cpu().numpy()
    for c, (hi, lo) in enumerate(((0, 1), (2, 3))):
        scale = _slot_abs_sums(leaf, slots, stats[hi] + stats[lo])
        err = np.abs(got[..., c] - ref[..., c]).max(axis=(1, 2))
        assert (err <= 1e-6 * scale).all(), (c, err, scale)
    assert not got[np.asarray(slots) < 0].any()


@pytest.mark.parametrize("precision", ["hilo", "int8", "int16"])
@pytest.mark.parametrize("case", PACKED_CASES, ids=lambda c: c[0])
def test_flat_kernel_packed_matches_twin(precision, case):
    # kernel B4's packed variant, on the flat path's 256-row pack blocks
    _, F, n, B, leaves, slots, _ = case
    n = -(-n // 256) * 256
    dev = cuda_device()
    if precision == "hilo":
        args, _, _ = _hist_inputs(dev, 11, F, n, 16, leaves, slots,
                                  precision)
    else:
        args = _int_hist_inputs(dev, 11, F, n, 16, leaves, slots, precision)
    args = (TH.pack_bins(args[0], 256),) + args[1:]
    name = "hist_flat_packed" + ("" if precision == "hilo" else "_int")
    before = dict(kernels.launches)
    got = TH.hist_flat_kernel(*args, B, packed_block=256)
    # only this variant's counter moved
    assert {k: v - before[k] for k, v in kernels.launches.items()
            if v != before[k]} == {name: 1}
    ref = TH.hist_batched_plain(*args, B, packed_block=256)
    if precision != "hilo":
        assert torch.equal(got, ref)
        return
    got = TH._unpack_hist(got.permute(3, 2, 0, 1), precision).cpu().numpy()
    ref = TH._unpack_hist(ref.permute(3, 2, 0, 1), precision).cpu().numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    leaf = args[2].cpu().numpy()
    stats = args[1].float().cpu().numpy()
    for c, (hi, lo) in enumerate(((0, 1), (2, 3))):
        scale = _slot_abs_sums(leaf, slots, stats[hi] + stats[lo])
        err = np.abs(got[..., c] - ref[..., c]).max(axis=(1, 2))
        assert (err <= 1e-6 * scale).all(), (c, err, scale)
    assert not got[np.asarray(slots) < 0].any()


# the leaf sums' shapes: (n, L, how the ids are drawn); the last three
# leaves stay empty where the ids are drawn uniformly
LEAF_CASES = {
    "uniform": ((1 << 18) + 7, 256, "uniform"),
    "skew90": ((1 << 18) + 7, 256, "skew"),
    "one_leaf": ((1 << 18) + 7, 256, "one"),
    "ragged_n": (1_000_003, 256, "uniform"),
    "two_leaves": (100_001, 2, "uniform"),
    "L4097": ((1 << 18) + 7, 4097, "uniform"),
    # 8 x L counters miss shared memory: the grouping counts in global
    "L131073": (300_001, 131073, "uniform"),
}


def _leaf_operands(case):
    n, L, how = LEAF_CASES[case]
    rng = np.random.default_rng(12)
    leaf = rng.integers(0, max(L - 3, 1), size=n).astype(np.int32)
    if how == "skew":
        leaf[rng.random(n) < 0.9] = 5       # one leaf holds most rows
    if how == "one":
        leaf[:] = L // 3
    vals = np.stack([rng.normal(size=n), rng.random(n) * 0.25]
                    ).astype(np.float32)
    return torch.from_numpy(leaf), torch.from_numpy(vals), L


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_leaf_sums_kernel_bitwise_to_cpu_index_add(case):
    from lightgbm_tpu_torch.ops import leafsum as TL

    dev = cuda_device()
    ids_c, vals_c, L = _leaf_operands(case)
    before = dict(kernels.launches)
    got = TL.leaf_sums_kernel(ids_c.to(dev), vals_c.to(dev), L)
    assert {k: v - before[k] for k, v in kernels.launches.items()
            if v != before[k]} == {"leaf_group": 1, "leaf_sums": 1}
    # the twin: index_add_ on the CPU, each leaf's rows in row order
    assert torch.equal(got.cpu(), TL.leaf_sums_plain(ids_c, vals_c, L))


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_leaf_group_kernel_matches_twin(case):
    from lightgbm_tpu_torch.ops import leafsum as TL

    dev = cuda_device()
    ids_c, vals_c, L = _leaf_operands(case)
    ids, vals = ids_c.to(dev), vals_c.to(dev)
    grouped, offsets = TL.leaf_group_kernel(ids, vals, L)
    want_g, want_o = TL.leaf_group_plain(ids, vals, L)
    assert torch.equal(offsets, want_o)
    assert torch.equal(grouped, want_g)


def test_leaf_sums_launch_only_their_kernels():
    # no torch.sort, searchsorted or index_add_ on the card route: the
    # device sees the two hand-written kernels and nothing else
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.ops import leafsum as TL

    dev = cuda_device()
    ids_c, vals_c, L = _leaf_operands("skew90")
    ids, vals = ids_c.to(dev), vals_c.to(dev)
    TL.leaf_sums_kernel(ids, vals, L)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        TL.leaf_sums_kernel(ids, vals, L)
        torch.cuda.synchronize()
    names = {ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert names and all("leaf_group_kernel" in k or "leaf_sums_kernel" in k
                         for k in names), names


def test_leaf_sums_refuse_other_value_rows():
    from lightgbm_tpu_torch.ops import leafsum as TL

    dev = cuda_device()
    leaf = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=r"\[2, n\]"):
        TL.leaf_sums_kernel(leaf, torch.ones((3, 64), device=dev), 4)


def _norm(text, name):
    """Model text with the parameter line `name` normalized."""
    return re.sub(rf"^\[{name}: [^\]]*\]$", f"[{name}: -]", text,
                  flags=re.M)


def _packed_reg_data(n=40960):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(n, 10))
    X[rng.random(X.shape) < 0.03] = np.nan
    y = X[:, 0] + np.nan_to_num(X[:, 1]) ** 2 + 0.3 * rng.normal(size=n)
    return X, y


def test_packed_int8_training_on_card_matches_cpu_text():
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _packed_reg_data()
    p = {"objective": "regression", "num_leaves": 63, "max_bin": 15,
         "tpu_hist_precision": "int8", "tpu_hist_impl": "pallas2",
         "tpu_quant_refit_leaves": False, "verbosity": -1}
    kernels.reset_launches()
    gpu = lgb.train(dict(p), lgb.Dataset(X, label=y), num_boost_round=3,
                    keep_training_booster=True)
    assert gpu._driver.learner.packed_bins
    assert kernels.launches["hist_batched_packed_int"] > 0
    assert kernels.launches["hist_batched_int"] == 0
    cpu = lgb.train(dict(p, device_type="cpu"), lgb.Dataset(X, label=y),
                    num_boost_round=3)
    unpacked = lgb.train(dict(p, tpu_pack_bins=False),
                         lgb.Dataset(X, label=y), num_boost_round=3)
    text = gpu.model_to_string()
    assert _norm(text, "device_type") == \
        _norm(cpu.model_to_string(), "device_type")
    # packing is a layout: the unpacked run writes the same model
    assert _norm(unpacked.model_to_string(), "tpu_pack_bins") == \
        _norm(text, "tpu_pack_bins")


def test_refit_training_on_card_is_deterministic():
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _packed_reg_data()
    p = {"objective": "regression", "num_leaves": 63, "max_bin": 63,
         "tpu_hist_precision": "int8", "verbosity": -1}
    kernels.reset_launches()
    texts = [lgb.train(dict(p), lgb.Dataset(X, label=y),
                       num_boost_round=3).model_to_string()
             for _ in range(2)]
    assert kernels.launches["leaf_sums"] == 6
    assert kernels.launches["leaf_group"] == 6
    assert texts[0] == texts[1]


def test_packed_flat_int8_training_on_card_matches_cpu_text():
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _packed_reg_data()
    p = {"objective": "regression", "num_leaves": 63, "max_bin": 15,
         "tpu_hist_precision": "int8", "tpu_hist_impl": "pallas",
         "tpu_quant_refit_leaves": False, "verbosity": -1}
    kernels.reset_launches()
    gpu = lgb.train(dict(p), lgb.Dataset(X, label=y), num_boost_round=3,
                    keep_training_booster=True)
    assert gpu._driver.learner.packed_bins
    assert gpu._driver.learner.packed_block == 256
    assert kernels.launches["hist_flat_packed_int"] > 0
    assert kernels.launches["hist_batched_packed_int"] == 0
    cpu = lgb.train(dict(p, device_type="cpu"), lgb.Dataset(X, label=y),
                    num_boost_round=3)
    unpacked = lgb.train(dict(p, tpu_pack_bins=False),
                         lgb.Dataset(X, label=y), num_boost_round=3)
    text = gpu.model_to_string()
    assert _norm(text, "device_type") == \
        _norm(cpu.model_to_string(), "device_type")
    assert _norm(unpacked.model_to_string(), "tpu_pack_bins") == \
        _norm(text, "tpu_pack_bins")


# ---- kernel B3's edge cases, bitwise to its twin --------------------------

def _partition_case(seed, n, K=25, leaves=60, offset=0):
    """Kernel B3's operands: leaf ids offset..offset+leaves, K slots of
    distinct leaves over every missing type and both default directions,
    the last three not split."""
    rng = np.random.default_rng(seed)
    F = 30
    num_bin = rng.integers(4, 256, size=F).astype(np.int32)
    bins = np.stack([rng.integers(0, nb, size=n) for nb in num_bin]
                    ).astype(np.uint8)
    feat = rng.integers(0, F, size=K).astype(np.int32)
    c = dict(bins=bins, feat=feat,
             leaf=(rng.integers(0, leaves, size=n) + offset).astype(np.int32),
             sel=(rng.permutation(leaves)[:K] + offset).astype(np.int32),
             new_ids=(offset + leaves + np.arange(K)).astype(np.int32),
             thr=np.array([rng.integers(0, num_bin[f] - 1) for f in feat],
                          np.int32),
             dleft=np.arange(K) % 2 == 0,
             mt=(np.arange(K) // 2 % 3).astype(np.int32),
             nbf=num_bin[feat],
             db=np.array([rng.integers(0, num_bin[f]) for f in feat],
                         np.int32),
             do_k=np.arange(K) < K - 3)
    return c


_PART_KEYS = ("bins", "feat", "leaf", "sel", "new_ids", "thr", "dleft", "mt",
              "nbf", "db", "do_k")


def _partition_args(c, dev):
    return [torch.from_numpy(np.ascontiguousarray(c[k])).to(dev)
            for k in _PART_KEYS]


# (name, rows, leaf id offset, slot edits, K)
PARTITION_CASES = [
    ("path", 1_007_616, 0, None, 25),
    # two slots holding one leaf id, each with its own split
    ("dup", 100_000, 0, "dup", 25),
    # a repeated leaf id whose second slot is not split
    ("dup_dead", 100_000, 0, "dup_dead", 25),
    # leaf ids past the 4096-entry table, one held twice
    ("high_ids", 100_000, 4090, "dup", 25),
    ("do_false", 100_000, 0, "do_false", 25),
    # more slots than a warp's lanes: the table and chains built by loops
    ("k50_dup", 100_000, 0, "dup", 50),
    ("k50_high_ids", 100_000, 4090, "dup_dead", 50),
    # 32 slots: every lane of the warp a slot, the last one duplicated
    ("k32_dup", 100_000, 0, "dup_last", 32),
    # tails: the last 1-3 rows after whole 16-byte groups, and arrays
    # shorter than one group
    ("tail1", 100_001, 0, None, 25),
    ("tail2", 100_002, 0, None, 25),
    ("tail3", 100_003, 0, None, 25),
    ("n3", 3, 0, None, 25),
    ("n5", 5, 0, None, 25),
]


@pytest.mark.parametrize("case", PARTITION_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
def test_partition_kernel_edge_cases(case, aligned):
    name, n, offset, edit, K = case
    dev = cuda_device()
    c = _partition_case(13, n, K=K, leaves=2 * K + 10, offset=offset)
    if edit in ("dup", "dup_dead"):
        c["sel"][5] = c["sel"][1]
        if edit == "dup_dead":
            c["do_k"][5] = False
    elif edit == "dup_last":
        c["sel"][K - 1] = c["sel"][2]
        c["do_k"][:] = True
    elif edit == "do_false":
        c["do_k"] = np.arange(len(c["sel"])) % 2 == 0
    args = _partition_args(c, dev)
    if not aligned:
        # leaf ids one int32 into an allocation: not 16-byte aligned, the
        # kernel's scalar loads
        padded = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        padded[1:] = args[2]
        args[2] = padded[1:]
    assert (args[2].data_ptr() % 16 == 0) == aligned
    before = kernels.launches["partition_rows"]
    got = TF.partition_rows_kernel(*args)
    assert kernels.launches["partition_rows"] == before + 1
    ref = TF.partition_rows_plain(*args)
    assert torch.equal(got, ref)
    if n > 1000:
        assert (ref != args[2]).any()


# ---- wide bins (int32 bins_t, more than 256 bins): B1, B4, B2, B3 --------

WIDE_CASES = [
    # (name, F, n, B, leaves, slots)
    # the Higgs-1M width at max_bin=1023: 4 bin tiles of f32 sums, 3 int
    ("k25_b1023", 32, 1 << 17, 1023, 60, list(range(0, 48, 2)) + [-1]),
    # just past a byte, a duplicated slot and a dead one
    ("b257_dup", 5, 5000, 257, 5, [3, -1, 0, 3]),
    # two feature chunks, 14 bin tiles of f32 sums
    ("f40_b4096", 40, 20000, 4096, 10, [1, 4, -1, 7]),
    # every row in slot 0: the root call
    ("root", 28, 1 << 17, 1023, 1, [0] + [-1] * 24),
    # more tiles than a cluster holds: each entry walked once per tile
    # group, a duplicated slot
    ("b16384", 8, 30000, 16384, 6, [2, 5, -1, 2]),
    # and the root call there
    ("root_b16384", 8, 30000, 16384, 1, [0, -1]),
]


def _wide(args, B):
    """The same operands with int32 bins over [0, B)."""
    rng = np.random.default_rng(B)
    bins = torch.from_numpy(rng.integers(0, B, size=tuple(args[0].shape))
                            .astype(np.int32)).to(args[0].device)
    return (bins,) + tuple(args[1:])


@pytest.mark.parametrize("flat", [False, True], ids=["B1", "B4"])
@pytest.mark.parametrize("precision", ["hilo", "f32", "int8", "int16"])
@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: c[0])
def test_hist_kernel_wide_matches_twin(case, precision, flat):
    dev = cuda_device()
    _, F, n, B, leaves, slots = case
    kernel = TH.hist_flat_kernel if flat else TH.hist_batched_kernel
    name = ("hist_flat" if flat else "hist_batched") + "_wide"
    if precision.startswith("int"):
        name += "_int"
        args = _wide(_int_hist_inputs(dev, 12, F, n, B, leaves, slots,
                                      precision), B)
    else:
        args, sg, sh = _hist_inputs(dev, 12, F, n, 2, leaves, slots,
                                    precision)
        args = _wide(args, B)
    before = kernels.launches[name]
    got = kernel(*args, B)
    assert kernels.launches[name] == before + 1
    ref = TH.hist_batched_plain(*args, B)
    if precision.startswith("int"):
        assert got.dtype == torch.int32 and torch.equal(got, ref)
        return
    got = TH._unpack_hist(got.permute(3, 2, 0, 1), precision).cpu().numpy()
    ref = TH._unpack_hist(ref.permute(3, 2, 0, 1), precision).cpu().numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    # f32 sums taken in another order: within 1e-6 of the sum of |stat|
    assert np.abs(got[..., 0] - ref[..., 0]).max() <= 1e-6 * sg
    assert np.abs(got[..., 1] - ref[..., 1]).max() <= 1e-6 * sh
    # a slot repeating a leaf id gets the same sums, in f32 atomics of
    # another arrival order
    dup = [k for k in range(1, len(slots)) if slots[k] in slots[:k]]
    for k in dup:
        first = got[slots.index(slots[k])]
        np.testing.assert_array_equal(got[k][..., 2], first[..., 2])
        assert np.abs(got[k][..., 0] - first[..., 0]).max() <= 1e-6 * sg


def test_hist_kernel_wide_bins_past_num_bins_add_nothing():
    dev = cuda_device()
    args = _wide(_int_hist_inputs(dev, 13, 6, 4000, 600, 3, [0, 2],
                                  "int16"), 600)
    # bins in [300, 600) lie past num_bins=300: no tile adds them
    got = TH.hist_batched_kernel(*args, 300)
    assert torch.equal(got, TH.hist_batched_plain(*args, 300))


@pytest.mark.parametrize("precision", ["int8", "int16"])
@pytest.mark.parametrize("F,n,B,K,dead,root", [
    (32, 1 << 17, 1023, 25, (7, 24), False),
    (6, 3000, 300, 3, (1,), False),
    (8, 1 << 15, 4096, 4, (), False),
    # more tiles than a cluster holds, and the root call there and at
    # max_bin=1023
    (8, 30000, 16384, 4, (), False),
    (8, 30000, 16384, 1, (), True),
    (28, 1 << 17, 1023, 1, (), True),
])
def test_fused_kernel_wide_bitwise(precision, F, n, B, K, dead, root):
    dev = cuda_device()
    case, kw = fused_case(14, F, n, B, K, precision, dead, root=root)
    assert case["bins"].dtype == np.int32
    ops = fused_args(case, B, precision, dev)
    before = kernels.launches["fused_hist_scan_wide"]
    got = TF.fused_hist_scan_kernel(*ops, split_kw=kw)
    assert kernels.launches["fused_hist_scan_wide"] == before + 1
    ref = TF.fused_hist_scan_plain(*ops, split_kw=kw)
    TF.assert_fused_equal(got, ref)
    assert (ref[1][..., 0] > 0).any()
    # some feature's best threshold lies past the first 256-bin tile
    assert (ref[1][..., 1][ref[1][..., 0] > 0] > 255).any()


@pytest.mark.parametrize("bad", ["grid_past_resident", "smem_past_card",
                                 "cluster_past_portable"])
def test_wide_launch_refused_raises(bad, monkeypatch):
    """A wide launch that the card (or the launcher's own check) refuses
    raises through kernels.check: no tiled read, no twin, no launch
    counted."""
    dev = cuda_device()
    args = _wide(_int_hist_inputs(dev, 17, 8, 20000, 1023, 6, [0, 2, 4],
                                  "int8"), 1023)
    plan_of = TH.hist_plan

    def bad_plan(*a, **k):
        p = plan_of(*a, **k)
        assert p.cluster > 1
        if bad == "grid_past_resident":
            return p._replace(grid=p.grid + p.cluster)
        if bad == "smem_past_card":
            return p._replace(smem=TH._device_limits(dev.index)[1] + 1024)
        return p._replace(cluster=16, grid=16 * max(1, p.grid // 16))

    monkeypatch.setattr(TH, "hist_plan", bad_plan)
    before = dict(kernels.launches)
    for kernel in (TH.hist_batched_kernel, TH.hist_flat_kernel):
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernel(*args, 1023)
    assert kernels.launches == before
    monkeypatch.undo()
    # and the card still takes the planned launch; a later launch that
    # checks the runtime's last error does not find the refusal there
    got = TH.hist_batched_kernel(*args, 1023)
    assert torch.equal(got, TH.hist_batched_plain(*args, 1023))
    from lightgbm_tpu_torch.ops import leafsum as TL
    leaf = torch.arange(64, dtype=torch.int32, device=dev) % 5
    vals = torch.ones((2, 64), device=dev)
    assert torch.equal(TL.leaf_sums_kernel(leaf, vals, 5).cpu(),
                       TL.leaf_sums_plain(leaf.cpu(), vals.cpu(), 5))


def test_fused_probe_wide_passes():
    dev = cuda_device()
    TF.probe_fused(dev, "int8", wide=True)
    TF.probe_fused(dev, "int16", wide=True)


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "offset"])
def test_partition_kernel_wide_matches_twin(aligned):
    dev = cuda_device()
    rng = np.random.default_rng(15)
    F, n, K, leaves = 30, (1 << 16) + 3, 25, 60
    num_bin = rng.integers(300, 1024, size=F).astype(np.int32)
    bins = np.stack([rng.integers(0, nb, size=n) for nb in num_bin]
                    ).astype(np.int32)
    feat = rng.integers(0, F, size=K).astype(np.int32)
    mt = (np.arange(K) % 3).astype(np.int32)
    db = np.array([rng.integers(0, num_bin[f]) for f in feat], np.int32)
    thr = np.array([rng.integers(256, num_bin[f] - 1) for f in feat],
                   np.int32)
    sel = rng.permutation(leaves)[:K].astype(np.int32)
    sel[3] = sel[2]                                  # a duplicated slot
    leaf = rng.integers(0, leaves, size=n + 1).astype(np.int32)
    c = [bins, feat, leaf, sel, (leaves + np.arange(K)).astype(np.int32),
         thr, rng.random(K) < 0.5, mt, num_bin[feat], db,
         np.arange(K) < K - 3]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in c]
    args[2] = args[2][:n] if aligned else args[2][1:]
    before = kernels.launches["partition_rows_wide"]
    got = TF.partition_rows_kernel(*args).cpu().numpy()
    assert kernels.launches["partition_rows_wide"] == before + 1
    ref = TF.partition_rows_plain(*args).cpu().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_wide_int8_training_on_card_matches_cpu_text(impl):
    import lightgbm_tpu_torch as lgb

    cuda_device()
    rng = np.random.default_rng(16)
    X = rng.normal(size=(20000, 10))
    X[rng.random(X.shape) < 0.03] = np.nan
    y = X[:, 0] + np.nan_to_num(X[:, 1]) ** 2 + 0.3 * rng.normal(size=20000)
    p = {"objective": "regression", "num_leaves": 63, "max_bin": 511,
         "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
         "tpu_partition_impl": "kernel", "tpu_hist_impl": impl,
         "verbosity": -1}
    kernels.reset_launches()
    texts = {}
    for dev in ("cuda", "cpu"):
        b = lgb.train(dict(p, device_type=dev), lgb.Dataset(X, label=y), 3,
                      keep_training_booster=True)
        assert b._driver.learner.bins_t.dtype == torch.int32
        texts[dev] = _norm(b.model_to_string(), "device_type")
    route = "fused_hist_scan_wide" if impl == "auto" else "hist_flat_wide_int"
    assert kernels.launches[route] > 0
    assert kernels.launches["partition_rows_wide"] > 0
    assert texts["cuda"] == texts["cpu"]


def _multiclass_booster(dev):
    import lightgbm_tpu_torch as lgb

    rng = np.random.default_rng(18)
    X = rng.normal(size=(20000, 8))
    X[rng.random(X.shape) < 0.03] = np.nan
    lat = np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) \
        + 0.5 * rng.normal(size=20000)
    y = np.digitize(lat, np.quantile(lat, [0.25, 0.5, 0.75]))
    p = {"objective": "multiclass", "num_class": 4, "num_leaves": 31,
         "max_bin": 63, "verbosity": -1, "device_type": dev}
    return X, lgb.train(p, lgb.Dataset(X, label=y), 12)


def test_multiclass_class_scores_deterministic_and_equal_to_cpu():
    # each class's trees add in tree order as elementwise adds (no
    # atomics), so the card's [k, n] scores are the same every call and
    # equal the CPU's
    from lightgbm_tpu_torch.ops.predict import class_scores

    dev = cuda_device()
    X, b = _multiclass_booster("cuda")
    drv = b._driver
    meta = drv._pred_ctx.meta_dev(dev)
    tables, depth = drv._forest(len(drv.models))
    bins_t = drv._pred_ctx.bin_rows_t(X, dev)
    runs = [class_scores(tables, bins_t, meta, 4, depth).cpu()
            for _ in range(10)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    assert runs[0].shape == (4, 20000)
    cpu = _cpu_copy(b)
    np.testing.assert_array_equal(b.predict(X, raw_score=True),
                                  cpu.predict(X, raw_score=True))


def _cpu_copy(b):
    """The same model, loaded on the CPU."""
    import lightgbm_tpu_torch as lgb

    return lgb.Booster(model_str=b.model_to_string(),
                       params={"device_type": "cpu"})


@pytest.mark.parametrize("objective", ["regression_l1", "lambdarank"])
def test_sync_step_objectives_on_card_match_cpu_text(objective):
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _packed_reg_data(40950)
    group = None
    if objective == "lambdarank":
        y = np.digitize(y, np.quantile(y, [0.2, 0.4, 0.6, 0.8]))
        group = [50] * (len(y) // 50)
    p = {"objective": objective, "num_leaves": 31, "max_bin": 63,
         "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
         "verbosity": -1}
    kernels.reset_launches()
    texts = {}
    for dev in ("cuda", "cpu"):
        b = lgb.train(dict(p, device_type=dev),
                      lgb.Dataset(X, label=y, group=group), 3)
        texts[dev] = _norm(b.model_to_string(), "device_type")
    assert kernels.launches["fused_hist_scan"] > 0
    assert texts["cuda"] == texts["cpu"]


@pytest.mark.parametrize("impl", ["fused", "pallas2"])
def test_categorical_int8_training_on_card_matches_cpu_text(impl):
    """Categorical features (one-hot and sorted-CTR splits) through B1-int
    every round: no B2 launch, the card's model text the CPU's, and the
    card's predict of rows with NaN, negative and unseen categories equal
    to the booster's scores after a save and load."""
    import lightgbm_tpu_torch as lgb

    cuda_device()
    rng = np.random.default_rng(3)
    n = 30000
    X = rng.normal(size=(n, 6))
    X[rng.random(X.shape) < 0.03] = np.nan
    X[:, 1] = rng.integers(-1, 40, n)
    X[:, 4] = rng.integers(0, 3, n)
    eff = rng.normal(size=41)
    y = (np.nan_to_num(X[:, 0]) + eff[X[:, 1].astype(int) + 1]
         + 0.5 * (X[:, 4] == 2) + 0.3 * rng.normal(size=n))
    p = {"objective": "regression", "num_leaves": 63, "max_bin": 63,
         "tpu_hist_precision": "int8", "tpu_hist_impl": impl,
         "tpu_quant_refit_leaves": False, "verbosity": -1}
    kernels.reset_launches()
    gpu = lgb.train(dict(p),
                    lgb.Dataset(X, label=y, categorical_feature=[1, 4]),
                    num_boost_round=3, keep_training_booster=True)
    assert kernels.launches["hist_batched_int"] > 0
    assert kernels.launches["fused_hist_scan"] == 0
    cpu = lgb.train(dict(p, device_type="cpu"),
                    lgb.Dataset(X, label=y, categorical_feature=[1, 4]),
                    num_boost_round=3)
    text = gpu.model_to_string()
    assert re.search(r"^num_cat=[1-9]", text, flags=re.M)
    assert _norm(text, "device_type") == \
        _norm(cpu.model_to_string(), "device_type")
    P = X[:200].copy()
    P[0::4, 1], P[1::4, 1], P[2::4, 1] = np.nan, -5.0, 1000.0
    loaded = lgb.Booster(model_str=text)
    np.testing.assert_array_equal(loaded.predict(P, raw_score=True),
                                  gpu.predict(P, raw_score=True))


def _onehot_csr(n, seed):
    """A seeded sparse table: a gamma-distributed column and one-hot
    blocks of 12, 31, 7, 24 and 60 categories (135 features) as a scipy
    CSR matrix, and a regression label of per-category effects."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    dist = rng.gamma(2.0, 350.0, n)
    y = 0.001 * dist + 0.3 * rng.normal(size=n)
    cols, off = [np.zeros(n, np.int64)], 1
    for k in (12, 31, 7, 24, 60):
        code = rng.integers(0, k, n)
        y += rng.normal(size=k)[code]
        cols.append(off + code)
        off += k
    data = np.ones((n, len(cols)))
    data[:, 0] = dist
    X = sp.csr_matrix((data.reshape(-1),
                       np.stack(cols, 1).reshape(-1).astype(np.int32),
                       np.arange(0, n * len(cols) + 1, len(cols))),
                      shape=(n, off))
    return X, y


EFB_CARD = {"objective": "regression", "num_leaves": 63, "max_bin": 63,
            "tpu_partition_impl": "select", "tpu_quant_refit_leaves": False,
            "verbosity": -1}


@pytest.mark.parametrize("precision", ["hilo", "int8"])
def test_hist_kernels_on_bundle_columns_match_twin(precision):
    """B1 (hilo) and B1-int on the EFB learner's bundle columns, padded to
    32: random slots over its rows against the twin, counts and int sums
    exact, float sums within 1e-6 of each slot's sum of |stat|; the
    training itself launched B1 or B1-int, and neither B2 nor B3."""
    import lightgbm_tpu_torch as lgb

    dev = cuda_device()
    X, y = _onehot_csr(40000, 5)
    kernels.reset_launches()
    b = lgb.train(dict(EFB_CARD, tpu_hist_precision=precision),
                  lgb.Dataset(X, label=y), 1, keep_training_booster=True)
    name = "hist_batched" if precision == "hilo" else "hist_batched_int"
    assert kernels.launches[name] > 0
    assert kernels.launches["fused_hist_scan"] == 0
    assert kernels.launches["partition_rows"] == 0
    learner = b._driver.learner
    bins = learner.bins_t
    assert learner.bundle_plan is not None
    assert bins.shape[0] == learner.g_pad == 32 < learner.num_features
    n, B = learner.n_pad, learner.num_bins
    rng = np.random.default_rng(6)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    mask = learner._ones_mask.cpu().numpy()
    if precision == "int8":
        g, h = np.clip(np.round(g * 40), -127, 127), np.round(h * 120)
    stats = TH.pack_stats(torch.from_numpy(g * mask),
                          torch.from_numpy(h * mask),
                          torch.from_numpy(mask), precision)
    stats = stats.to(dev).contiguous()
    leaf = torch.from_numpy(rng.integers(0, 60, n).astype(np.int32)).to(dev)
    slots = torch.tensor(list(range(0, 48, 2)) + [-1], dtype=torch.int32,
                         device=dev)
    before = kernels.launches[name]
    got = TH.hist_batched_kernel(bins, stats, leaf, slots, B)
    assert kernels.launches[name] == before + 1
    ref = TH.hist_batched_plain(bins, stats, leaf, slots, B)
    if precision == "int8":
        assert torch.equal(got, ref)
        return
    got = TH._unpack_hist(got.permute(3, 2, 0, 1), precision).cpu().numpy()
    ref = TH._unpack_hist(ref.permute(3, 2, 0, 1), precision).cpu().numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    assert np.abs(got[..., 0] - ref[..., 0]).max() <= 1e-6 * np.abs(
        g * mask).sum()
    assert np.abs(got[..., 1] - ref[..., 1]).max() <= 1e-6 * np.abs(
        h * mask).sum()


def test_efb_int8_training_on_card_matches_cpu_text():
    """int8 on sparse one-hot data, bundled: the card's model text is the
    CPU's, and predict of the CSR rows equals predict of their dense
    copy."""
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _onehot_csr(30000, 7)
    p = dict(EFB_CARD, tpu_hist_precision="int8")
    texts = {}
    for dev in ("cuda", "cpu"):
        b = lgb.train(dict(p, device_type=dev), lgb.Dataset(X, label=y), 3,
                      keep_training_booster=True)
        assert b._driver.learner.bundle_plan is not None
        texts[dev] = _norm(b.model_to_string(), "device_type")
        if dev == "cuda":
            np.testing.assert_array_equal(
                b.predict(X[:5000], raw_score=True),
                b.predict(X[:5000].toarray(), raw_score=True))
    assert texts["cuda"] == texts["cpu"]


# ---- monotone constraints, CEGB, forced splits, deterministic=true ------


def _unconstrained(case):
    """The operands of a monotone fused_case without its constraints and
    bounds."""
    free = dict(case, ctx=case["ctx"].copy(), meta_i=case["meta_i"].copy())
    free["ctx"][:-1, 3], free["ctx"][:-1, 4] = -1e30, 1e30
    free["meta_i"][:, 3] = 0
    return free


@pytest.mark.parametrize("precision", ["int8", "int16"])
@pytest.mark.parametrize("F,n,B,K,dead", [
    (32, 1 << 18, 255, 25, (7, 24)),
    (8, 1 << 16, 63, 4, ()),
    (28, 1 << 17, 1023, 25, (7,)),
    (8, 30000, 300, 3, (1,)),
])
def test_fused_kernel_monotone_bitwise(precision, F, n, B, K, dead):
    """B2 and B2-wide with monotone constraints on half of the features
    and bounds that bind on some children: bitwise to the twin, and the
    constraints change the records."""
    dev = cuda_device()
    case, kw = fused_case(17, F, n, B, K, precision, dead, mono=True)
    name = "fused_hist_scan" + ("_wide" if B > 256 else "")
    ops = fused_args(case, B, precision, dev)
    before = kernels.launches[name]
    got = TF.fused_hist_scan_kernel(*ops, split_kw=kw)
    assert kernels.launches[name] == before + 1
    ref = TF.fused_hist_scan_plain(*ops, split_kw=kw)
    TF.assert_fused_equal(got, ref)
    assert (ref[1][..., 0] > 0).any()
    free = TF.fused_hist_scan_plain(
        *fused_args(_unconstrained(case), B, precision, dev), split_kw=kw)
    assert (free[1][..., 0] != ref[1][..., 0]).any()


def _constraint_data(n=30000, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8))
    y = X[:, 0] - 0.5 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] \
        + 0.3 * rng.normal(size=n)
    return X, y


CONSTRAINT_CARD = {"objective": "regression", "num_leaves": 31,
                   "max_bin": 63, "min_data_in_leaf": 20, "verbosity": -1,
                   "tpu_hist_precision": "int8",
                   "tpu_quant_refit_leaves": False}


@pytest.mark.parametrize("extra", [
    {"monotone_constraints": [1, -1, 0, 1, 0, 0, 0, 0]},
    {"cegb_penalty_feature_coupled": [50.0] * 8,
     "cegb_penalty_feature_lazy": [0.0] * 4 + [0.01] * 4,
     "cegb_penalty_split": 0.001}], ids=["monotone", "cegb"])
def test_constraint_int8_training_on_card_matches_cpu_text(extra):
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _constraint_data()
    texts = {}
    for dev in ("cuda", "cpu"):
        p = dict(CONSTRAINT_CARD, device_type=dev, **extra)
        b = lgb.train(p, lgb.Dataset(X, label=y, params=p), 3)
        texts[dev] = _norm(b.model_to_string(), "device_type")
    assert texts["cuda"] == texts["cpu"]


def test_deterministic_training_on_card_is_byte_identical():
    """deterministic=true: f64 histograms in torch ops (no histogram
    kernel), two card runs write the same text, and its trees are the
    CPU's within 1e-12 of each tree's largest leaf."""
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _constraint_data()
    p = dict(CONSTRAINT_CARD, tpu_hist_precision="hilo", deterministic=True,
             tpu_hist_impl="xla")
    hist_kernels = [k for k in kernels.launches if k.startswith("hist_")
                    or k.startswith("fused_")]
    before = {k: kernels.launches[k] for k in hist_kernels}
    texts, models = [], []
    for dev in ("cuda", "cuda", "cpu"):
        b = lgb.train(dict(p, device_type=dev),
                      lgb.Dataset(X, label=y, params=p), 3)
        texts.append(b.model_to_string())
        models.append(b._driver.models)
    assert {k: kernels.launches[k] for k in hist_kernels} == before
    assert texts[0] == texts[1]
    for tc, tp in zip(models[0], models[2]):
        nl = tc.num_leaves
        assert tp.num_leaves == nl
        np.testing.assert_array_equal(tc.split_feature[:nl - 1],
                                      tp.split_feature[:nl - 1])
        np.testing.assert_array_equal(tc.threshold_in_bin[:nl - 1],
                                      tp.threshold_in_bin[:nl - 1])
        ref = np.asarray(tp.leaf_value[:nl])
        assert np.abs(np.asarray(tc.leaf_value[:nl]) - ref).max() \
            <= 1e-12 * np.abs(ref).max()


def _sparse_card_data(n=20000, seed=9):
    """Four dense normal columns and twelve with about 2% nonzero rows."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, 16))
    X[:, :4] = rng.normal(size=(n, 4))
    for f in range(4, 16):
        nz = rng.choice(n, size=n // 50, replace=False)
        X[nz, f] = rng.normal(size=len(nz)) + f * 0.1
    y = X[:, 0] + 2.0 * X[:, 5] - X[:, 9] + 0.3 * rng.normal(size=n)
    return X, y


def test_sparse_storage_on_card_matches_cpu():
    """tpu_sparse_threshold: the dense columns through B1 on the card,
    the sparse entries through torch ops; f64 trees (deterministic=true)
    within 1e-12 of the CPU's and of the card's dense storage; hilo
    launches B1 and not B3."""
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _sparse_card_data()
    p = dict(CONSTRAINT_CARD, tpu_hist_precision="hilo", deterministic=True,
             tpu_hist_impl="xla", enable_bundle=False,
             tpu_partition_impl="select")
    models = {}
    for tag, dev, sth in (("cuda", "cuda", 0.05), ("cpu", "cpu", 0.05),
                          ("dense", "cuda", 0.0)):
        q = dict(p, device_type=dev, tpu_sparse_threshold=sth)
        b = lgb.train(q, lgb.Dataset(X, label=y, params=q), 3,
                      keep_training_booster=True)
        assert b._driver.learner.params.has_sparse == (sth > 0)
        assert b.num_trees() == 3        # the lazy trees materialized
        models[tag] = b._driver.models
    for other in ("cpu", "dense"):
        for tc, tp in zip(models["cuda"], models[other]):
            nl = tc.num_leaves
            assert tp.num_leaves == nl
            np.testing.assert_array_equal(tc.split_feature[:nl - 1],
                                          tp.split_feature[:nl - 1])
            np.testing.assert_array_equal(tc.threshold_in_bin[:nl - 1],
                                          tp.threshold_in_bin[:nl - 1])
            ref = np.asarray(tp.leaf_value[:nl])
            assert np.abs(np.asarray(tc.leaf_value[:nl]) - ref).max() \
                <= 1e-12 * np.abs(ref).max()
    q = dict(p, deterministic=False, device_type="cuda",
             tpu_sparse_threshold=0.05, tpu_hist_impl="pallas2")
    before = dict(kernels.launches)
    lgb.train(q, lgb.Dataset(X, label=y, params=q), 2)
    assert kernels.launches["hist_batched"] > before["hist_batched"]
    assert kernels.launches["partition_rows"] == before["partition_rows"]


def test_sparse_f64_on_card_is_deterministic():
    """deterministic=true with sparse storage on the card: two runs
    write the same model text, which is also the card's dense storage
    text (the sparse histograms add in a fixed order, as the dense f64
    histograms do)."""
    import re

    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _sparse_card_data()
    p = dict(CONSTRAINT_CARD, tpu_hist_precision="hilo", deterministic=True,
             tpu_hist_impl="xla", enable_bundle=False, device_type="cuda",
             tpu_partition_impl="select")
    texts = []
    for sth in (0.05, 0.05, 0.0):
        q = dict(p, tpu_sparse_threshold=sth)
        text = lgb.train(q, lgb.Dataset(X, label=y, params=q),
                         3).model_to_string()
        texts.append(re.sub(r"^\[tpu_sparse_threshold: [^\]]*\]$", "",
                            text, flags=re.M))
    assert texts[0] == texts[1]
    assert texts[0] == texts[2]


def test_predict_binned_on_card_equals_array_predict():
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _constraint_data()
    p = dict(CONSTRAINT_CARD, device_type="cuda")
    train = lgb.Dataset(X[:20000], label=y[:20000], params=p)
    b = lgb.train(p, train, 3)
    valid = lgb.Dataset(X[20000:], label=y[20000:], reference=train)
    got = b.predict(valid, raw_score=True)
    np.testing.assert_array_equal(got, b.predict(X[20000:], raw_score=True))


def test_file_ingest_on_card_matches_cpu_bins(tmp_path):
    import lightgbm_tpu_torch as lgb

    cuda_device()
    X, y = _constraint_data(n=5000)
    X[::7, 2] = np.nan
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    for extra in ({}, {"two_round": True, "bin_construct_sample_cnt": 1000}):
        bins = {}
        for dev in ("cuda", "cpu"):
            q = dict(CONSTRAINT_CARD, device_type=dev, **extra)
            ds = lgb.Dataset(str(path), params=q).construct()
            assert ds._inner.bins_t.device.type == dev
            bins[dev] = ds._inner.bins
        np.testing.assert_array_equal(bins["cuda"], bins["cpu"])


# ---- the model utilities: the f64 leaf sums, the raw-value walker, SHAP --


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_leaf_sums_f64_kernel_bitwise_to_cpu_index_add(case):
    """Booster.refit's sums: the f32 pairs added into doubles in row
    order, bitwise index_add_ in f64 on the CPU (np.bincount's order)."""
    from lightgbm_tpu_torch.ops import leafsum as TL

    dev = cuda_device()
    ids_c, vals_c, L = _leaf_operands(case)
    before = dict(kernels.launches)
    got = TL.leaf_sums(ids_c.to(dev), vals_c.to(dev), L,
                       out_dtype=torch.float64)
    assert {k: v - before[k] for k, v in kernels.launches.items()
            if v != before[k]} == {"leaf_group": 1, "leaf_sums_f64": 1}
    assert got.dtype == torch.float64
    assert torch.equal(got.cpu(), TL.leaf_sums_plain(
        ids_c, vals_c, L, out_dtype=torch.float64))


def _utility_model(cat):
    import lightgbm_tpu_torch as tlgb

    rng = np.random.default_rng(21)
    X = rng.normal(size=(3000, 6))
    X[rng.random(X.shape) < 0.05] = np.nan
    if cat:
        X[:, 0] = rng.integers(0, 6, len(X)).astype(np.float64)
        X[:40, 0] = np.nan
    y = np.nan_to_num(X[:, 1]) - 0.5 * np.nan_to_num(X[:, 2]) ** 2
    kw = {"categorical_feature": [0]} if cat else {}
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
              "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
              "verbosity": -1}
    cpu = tlgb.train(dict(params, device_type="cpu"),
                     tlgb.Dataset(X, label=y, **kw), 6)
    return X, y, params, cpu.model_to_string()


@pytest.mark.parametrize("cat", [False, True], ids=["numerical",
                                                    "categorical"])
def test_raw_walker_and_shap_on_card_equal_cpu(cat):
    """The raw-value walk (scores, leaves, early stop) and the batched
    SHAP contributions of one model text, card against CPU, bit for bit
    (f64 torch ops, no fused multiply-add)."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops.predict import raw_scores_plain

    dev = cuda_device()
    X, _, _, text = _utility_model(cat)
    card = tlgb.Booster(model_str=text, params={"device_type": "cuda"})
    cpu = tlgb.Booster(model_str=text, params={"device_type": "cpu"})
    assert card._driver.device.type == dev.type
    for kw in ({"raw_score": True, "tpu_predict_device": False},
               {"pred_leaf": True},
               {"raw_score": True, "pred_early_stop": True,
                "pred_early_stop_freq": 2, "pred_early_stop_margin": 0.5}):
        np.testing.assert_array_equal(card.predict(X, **kw),
                                      cpu.predict(X, **kw))
    np.testing.assert_array_equal(
        card.predict(X, raw_score=True, tpu_predict_device=False),
        raw_scores_plain(cpu._driver.models, X, 1)[0])
    np.testing.assert_array_equal(card.predict(X[:300], pred_contrib=True),
                                  cpu.predict(X[:300], pred_contrib=True))


def test_refit_and_continuation_on_card_equal_cpu():
    """Booster.refit on the card (leaf_group and the f64 leaf sums)
    writes the CPU's text; an int8 regression continuation with a
    validation set writes the CPU's text and rolls back alike."""
    import lightgbm_tpu_torch as tlgb

    dev = cuda_device()
    X, y, params, text = _utility_model(False)
    y2 = y[::-1].copy()
    before = dict(kernels.launches)
    card = tlgb.Booster(model_str=text, params={"device_type": "cuda"}
                        ).refit(X, y2, decay_rate=0.9)
    used = {k for k, v in kernels.launches.items() if v != before[k]}
    assert used == {"leaf_group", "leaf_sums_f64"}
    cpu = tlgb.Booster(model_str=text, params={"device_type": "cpu"}
                       ).refit(X, y2, decay_rate=0.9)
    assert card.model_to_string() == cpu.model_to_string()
    texts = []
    for device in ("cuda", "cpu"):
        p = dict(params, device_type=device)
        ds = tlgb.Dataset(X[:2500], label=y[:2500])
        b = tlgb.train(p, ds, 3, init_model=tlgb.Booster(
            model_str=text, params=p),
            valid_sets=[ds.create_valid(X[2500:], label=y[2500:])],
            keep_training_booster=True)
        b.rollback_one_iter()
        texts.append(re.sub(r"\[device_type: [^\]]*\]", "",
                            b.model_to_string()))
    assert texts[0] == texts[1]
    assert dev.type == "cuda"


def _text_without_params(booster):
    """A model text without its parameters block (checkpoint directory,
    device)."""
    text = booster.model_to_string(num_iteration=-1)
    head, rest = text.split("\nparameters:", 1)
    return head + rest.split("end of parameters", 1)[1]


def _ft_data():
    rng = np.random.default_rng(31)
    X = rng.normal(size=(6000, 8))
    y = X[:, 0] - 0.5 * X[:, 1] ** 2 + 0.3 * X[:, 2] * X[:, 3]
    params = {"objective": "regression", "num_leaves": 31, "max_bin": 63,
              "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
              "bagging_fraction": 0.8, "bagging_freq": 1, "verbosity": -1,
              "device_type": "cuda"}
    return X, y, params


def test_genuine_cuda_oom_in_a_guard_names_its_site():
    """An allocation past the card's memory inside oom_guard is a
    DeviceOutOfMemory naming the site, its cause torch's own error."""
    from lightgbm_tpu_torch.utils import membudget

    dev = cuda_device()
    total = torch.cuda.get_device_properties(dev).total_memory
    with pytest.raises(membudget.DeviceOutOfMemory) as ei:
        with membudget.oom_guard("predict_chunk", rows=1):
            torch.empty(2 * total, dtype=torch.uint8, device=dev)
    assert ei.value.site == "predict_chunk"
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)
    assert membudget.device_capacity_bytes(dev) == \
        torch.cuda.mem_get_info(dev)[1]


def test_card_checkpoint_resumes_on_the_card_byte_identically(tmp_path):
    """int8 training on the card cut after 3 rounds and resumed from its
    bundle gives the uninterrupted card run's text; the run launches the
    int8 kernels."""
    import lightgbm_tpu_torch as tlgb

    cuda_device()
    X, y, params = _ft_data()
    before = dict(kernels.launches)
    full = tlgb.train(params, tlgb.Dataset(X, label=y), 6,
                      keep_training_booster=True)
    assert kernels.launches["fused_hist_scan"] > before["fused_hist_scan"]
    p = dict(params, tpu_checkpoint_dir=str(tmp_path))
    tlgb.train(p, tlgb.Dataset(X, label=y), 3)
    resumed = tlgb.train(p, tlgb.Dataset(X, label=y), 6, resume=True,
                         keep_training_booster=True)
    assert _text_without_params(resumed) == _text_without_params(full)


def test_fused_unfuse_rung_on_the_card_equals_the_fused_text():
    """Two injected OOMs with B2 pinned: the ladder shrinks the chunks,
    then leaves B2 for B1-int and the torch split search, and the text
    is the undisturbed fused run's."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.utils import faultline

    cuda_device()
    X, y, params = _ft_data()
    p = dict(params, tpu_hist_impl="fused", tpu_ingest_chunk_rows=8192,
             tpu_predict_chunk_rows=8192)
    want = _text_without_params(tlgb.train(p, tlgb.Dataset(X, label=y), 5,
                                           keep_training_booster=True))
    b = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y))
    faultline.reset()
    try:
        for it in range(5):
            if it == 2:
                faultline.arm("device_alloc", action="oom", times=2)
            if it == 3:
                before = dict(kernels.launches)
            b.update()
    finally:
        faultline.reset()
    assert b._driver._mem_ladder.describe() == ["shrink_chunk_rows",
                                                "fused_unfuse"]
    assert kernels.launches["fused_hist_scan"] == before["fused_hist_scan"]
    assert kernels.launches["hist_batched_int"] > before["hist_batched_int"]
    assert _text_without_params(b) == want


# ---- the streamed layout (ops/stream.py): B1 and B1-int on pinned
# row-major blocks, block sums, a streamed run, the predict chunk ----

def _pinned_block(bins_t, row0, rows, dev):
    """Rows [row0, row0 + rows) of [F, n] uint8 bins as a pinned
    row-major host block (`make_host_blocks`' layout) copied to dev."""
    from lightgbm_tpu_torch.ops.stream import make_host_blocks

    F, n = bins_t.shape
    host = make_host_blocks(bins_t[:, row0:row0 + rows], rows, rows,
                            -(-F // 32) * 32, pin=True)[0]
    assert host.is_pinned()
    return host.to(dev, non_blocking=True)


@pytest.mark.parametrize("flat", [False, True], ids=["B1", "B4"])
@pytest.mark.parametrize("precision", ["hilo", "int8"])
def test_hist_kernel_on_a_row_major_block_matches_twin(precision, flat):
    dev = cuda_device()
    slots = list(range(0, 48, 2)) + [-1]
    if precision == "int8":
        args = _int_hist_inputs(dev, 5, 28, 131072, 255, 60, slots,
                                precision)
    else:
        args = _hist_inputs(dev, 5, 28, 131072, 255, 60, slots,
                            precision)[0]
    bins, stats, leaf, sl = args
    blk = _pinned_block(bins.cpu(), 0, 131072, dev)
    name = ("hist_flat" if flat else "hist_batched") \
        + ("_int" if precision == "int8" else "")
    before = kernels.launches[name]
    got = TH.build_histogram_rows(blk, 28, stats, leaf, sl, 255, precision,
                                  "pallas" if flat else "pallas2")
    assert kernels.launches[name] == before + 1
    ref = TH._unpack_hist(TH.hist_batched_plain(bins, stats, leaf, sl, 255)
                          .permute(3, 2, 0, 1), precision)
    if precision == "int8":
        assert torch.equal(got, ref)
    else:
        assert torch.equal(got[..., 2], ref[..., 2])
        assert (got - ref).abs().max() <= 1e-6 * float(
            stats.float().abs().sum())


def test_int32_block_sums_equal_one_resident_call():
    """The streamed histogram: a B1-int call a block, the int32 sums
    added, bitwise one B1-int call over every row."""
    dev = cuda_device()
    slots = list(range(0, 48, 2)) + [-1]
    bins, stats, leaf, sl = _int_hist_inputs(dev, 6, 28, 300000, 255, 60,
                                             slots, "int8")
    whole = TH.build_histogram_batched_t(bins, stats, leaf, sl, 255, "int8")
    R = 131072
    acc = torch.zeros_like(whole)
    for row0 in range(0, 300000, R):
        rows = min(R, 300000 - row0)
        blk = _pinned_block(bins.cpu(), row0, rows, dev)
        acc = acc + TH.build_histogram_rows(
            blk, 28, stats[:, row0:row0 + rows].contiguous(),
            leaf[row0:row0 + rows], sl, 255, "int8")
    assert torch.equal(acc, whole)


def test_streamed_int8_training_on_card_matches_cpu_text():
    import lightgbm_tpu_torch as lgb

    cuda_device()
    rng = np.random.default_rng(2)
    X = rng.normal(size=(40000, 10))
    X[rng.random(X.shape) < 0.03] = np.nan
    y = X[:, 0] + np.nan_to_num(X[:, 1]) ** 2 + 0.3 * rng.normal(size=40000)
    p = {"objective": "regression", "num_leaves": 63, "max_bin": 63,
         "tpu_hist_precision": "int8", "tpu_quant_refit_leaves": False,
         "tpu_stream_mode": "streamed", "tpu_stream_block_rows": 16384,
         "verbosity": -1}
    kernels.reset_launches()
    gpu = lgb.train(dict(p), lgb.Dataset(X, label=y), num_boost_round=3,
                    keep_training_booster=True)
    learner = gpu._driver.learner
    assert learner.stream_layout and learner.bins_t is None
    assert learner._host_blocks[0].is_pinned()
    assert kernels.launches["hist_batched_int"] > 0
    assert kernels.launches["fused_hist_scan"] == 0
    stats = learner.stream_stats
    assert stats["h2d_bytes"] > 0 and 0.0 <= stats["overlap_pct"] <= 100.0
    cpu = lgb.train(dict(p, device_type="cpu"), lgb.Dataset(X, label=y),
                    num_boost_round=3)
    assert gpu.model_to_string().split("parameters:")[0] == \
        cpu.model_to_string().split("parameters:")[0]


@pytest.mark.parametrize("trees", [2, 50, 1000])
def test_plan_predict_scratch_covers_a_predict_chunks_peak(trees):
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.utils import membudget

    dev = cuda_device()
    rng = np.random.default_rng(3)
    X = rng.normal(size=(70000, 28))
    y = (X[:, 0] + X[:, 1] ** 2 > 0.5).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
         "num_iterations": trees, "tpu_hist_precision": "int8",
         "tpu_predict_chunk_rows": 65536, "verbosity": -1}
    b = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    for _ in range(trees):
        b.update()
    b.predict(X[:100])        # the forest's tables, made once
    drv = b._driver
    plan = membudget.plan_training(drv.config, drv.learner, 1)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    b.predict(X[:65536])
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert membudget.live_bytes(drv)["predict_scratch"] \
        == plan.components["predict_scratch"]
    assert plan.components["predict_scratch"] >= peak > 0


# -- the sharded learners ------------------------------------------------------
def test_sharded_b1_int_and_b3_on_two_streams_equal_one_call():
    """Two shard threads on one card, each launching B1-int and B3 on its
    own stream over its half of the rows: the histograms psummed over the
    data axis equal one B1-int call over all rows, bit for bit, and the
    halves' leaf ids one B3 call's."""
    from lightgbm_tpu_torch.parallel import strategies, topology

    dev = cuda_device()
    F, n, B, L, K = 32, 1 << 18, 255, 60, 24
    rng = np.random.default_rng(5)
    bins = torch.from_numpy(rng.integers(0, B, (F, n)).astype(np.uint8)).to(
        dev)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    mask = torch.ones(n, device=dev)
    q = TH.quant_limit("int8", n)
    stats = TH.pack_stats(TH.quantize_values(g, g.abs().max() / q, q,
                                             "nearest"),
                          TH.quantize_values(h, h.abs().max() / q, q,
                                             "nearest"),
                          mask, "int8").contiguous()
    leaf = torch.from_numpy(rng.integers(0, L, n).astype(np.int32)).to(dev)
    slots = torch.from_numpy(rng.permutation(L)[:K].astype(np.int32)).to(dev)
    slots[K // 2] = -1
    i32 = dict(dtype=torch.int32, device=dev)
    sel = torch.from_numpy(rng.permutation(L - K)[:K].astype(np.int32)).to(
        dev)
    new_ids = torch.arange(L - K, L, **i32)
    feat = torch.from_numpy(rng.integers(0, F, K).astype(np.int32)).to(dev)
    thr = torch.from_numpy(rng.integers(0, B - 1, K).astype(np.int32)).to(
        dev)
    dleft = torch.from_numpy(rng.random(K) < 0.5).to(dev)
    mt = torch.zeros(K, **i32)
    nbf = torch.full((K,), B, **i32)
    db = torch.zeros(K, **i32)
    do_k = torch.arange(K, device=dev) < K - 2
    half = n // 2
    parts = [bins[:, r * half:(r + 1) * half].contiguous() for r in (0, 1)]
    for part in parts:
        TH.row_major_bins(part)       # before the shard threads start
    t = topology.make_topology(2, devices=[dev])
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    before = kernels.launches["hist_batched_int"]

    def shard(ctx):
        lo = ctx.rank * half
        rows = slice(lo, lo + half)
        lf = leaf[rows].contiguous()
        raw = TH.hist_batched_kernel(parts[ctx.rank],
                                     stats[:, rows].contiguous(), lf, slots,
                                     B)
        out = TF.partition_rows_kernel(parts[ctx.rank], feat, lf, sel,
                                       new_ids, thr, dleft, mt, nbf, db,
                                       do_k)
        return topology.axis_psum(raw, topology.DATA), out

    res = strategies.run_shards(t, shard, streams)
    whole = TH.hist_batched_kernel(bins, stats, leaf, slots, B)
    moved = TF.partition_rows_kernel(bins, feat, leaf, sel, new_ids, thr,
                                     dleft, mt, nbf, db, do_k)
    torch.cuda.synchronize()
    assert kernels.launches["hist_batched_int"] == before + 3
    for raw, _ in res:
        assert torch.equal(raw, whole)
    assert torch.equal(torch.cat([res[0][1], res[1][1]]), moved)


@pytest.mark.parametrize("learner", ["data", "voting", "feature",
                                     "data_feature"])
def test_sharded_int8_training_on_card_matches_cpu(learner):
    """A sharded int8 regression run (2 shards, 4 under data_feature)
    gives the CPU's text on the card, launching no B2; under data and
    data_feature, and with the refit off, the serial text too."""
    import lightgbm_tpu_torch as lgb

    cuda_device()
    rng = np.random.default_rng(4)
    X = rng.normal(size=(20000, 12))
    y = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=20000)
    P = 4 if learner == "data_feature" else 2
    p = {"objective": "regression", "num_leaves": 31, "max_bin": 63,
         "tpu_hist_precision": "int8", "tpu_partition_impl": "kernel",
         "tpu_quant_refit_leaves": False, "tree_learner": learner,
         "num_machines": P, "verbosity": -1}

    def text(params):
        b = lgb.train(params, lgb.Dataset(X, label=y, params=params), 4)
        return b.model_to_string().split("parameters:")[0]

    kernels.reset_launches()
    card = text(p)
    assert kernels.launches["fused_hist_scan"] == 0
    assert kernels.launches["hist_batched_int"] > 0
    assert kernels.launches["partition_rows"] > 0
    assert card == text(dict(p, device_type="cpu"))
    if learner in ("data", "data_feature"):
        serial = {k: v for k, v in p.items()
                  if k not in ("tree_learner", "num_machines")}
        assert card == text(serial)


@pytest.mark.parametrize("learner", ["data", "voting", "data_feature",
                                     "data_efb"])
def test_multiprocess_int8_on_one_card_matches_in_process(learner,
                                                          tmp_path):
    """Two processes on the first card (time-sliced CUDA contexts, each
    launching B1-int and B3 cooperatively on its own shards), joined over
    gloo: both ranks' int8 texts equal the in-process run's on the card
    at tpu_topology_hosts=2, and each rank launched B1-int and B3 and no
    B2.  data_efb: EFB bundles under data (B1-int on the bundle columns;
    B3 refuses bundles, so a select partition)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    import lightgbm_tpu_torch as lgb

    from .test_torch_util import model_text
    from .torch_mp_worker import INT8, grid_data

    cuda_device()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    efb = learner == "data_efb"
    params = dict(INT8, tpu_partition_impl="select" if efb else "kernel",
                  tree_learner="data" if efb else learner, num_machines=4)
    spec = {"root": root, "out": str(tmp_path), "device": "cuda",
            "machines": ",".join(f"127.0.0.1:{p}" for p in ports),
            "rounds": 3, "grid": {learner: params}, "cases": ["grid"]}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    procs, logs = [], []
    for rank in range(2):
        logs.append(tmp_path / f"rank{rank}.log")
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[2]); "
             "from tests.torch_mp_worker import main; main()",
             str(tmp_path / "spec.json"), root], cwd=root,
            env=dict(os.environ, LIGHTGBM_TPU_PROCESS_ID=str(rank)),
            stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT))
    X, _, y = grid_data(learner)
    q = dict(params, tpu_topology_hosts=2)
    want = model_text(lgb.train(q, lgb.Dataset(X, label=y, params=q), 3))
    for p in procs:
        try:
            p.wait(timeout=240)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            pytest.fail("\n".join(log.read_text()[-4000:] for log in logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    for rank in range(2):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        run = got["grid"][learner]
        assert run["text"] == want
        assert run["bundled"] == efb
        assert run["launches"]["hist_batched_int"] > 0
        assert (run["launches"]["partition_rows"] > 0) == (not efb)
        assert run["launches"]["fused_hist_scan"] == 0
