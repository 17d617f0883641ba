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

from .test_torch_util import cuda_device

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
    assert all(v > 0 for v in kernels.launches.values())
    cpu = lgb.train(dict(p, device_type="cpu"), lgb.Dataset(X, label=y),
                    num_boost_round=3)
    pg, pc = gpu.predict(X), cpu.predict(X)
    assert np.isfinite(pg).all()
    # the trees may differ where an exact f32 tie between split gains
    # flips with the summation order; the predictions stay close
    assert np.abs(pg - pc).mean() < 1e-3
