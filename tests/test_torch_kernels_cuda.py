"""lightgbm_tpu_torch's CUDA kernels against their plain PyTorch twins.

Every test here needs the card and skips without one.  The file imports
neither JAX nor lightgbm_tpu, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

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
    with pytest.raises(ValueError, match="uint8"):
        TH.hist_batched_kernel(bins.int(), stats, leaf, slots, 16)
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
    gpu = lgb.train(dict(p), lgb.Dataset(X, label=y), num_boost_round=3)
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
])
def test_flat_kernel_matches_twin(precision, F, n, B, leaves, slots):
    dev = cuda_device()
    before = kernels.launches["hist_flat"]
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
    assert kernels.launches["hist_flat"] == before + 1


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
    gpu = lgb.train(dict(p), lgb.Dataset(X, label=y), num_boost_round=3)
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
