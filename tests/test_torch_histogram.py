"""lightgbm_tpu_torch histogram (kernel B1's module) against lightgbm_tpu.

Inputs are made with numpy from fixed seeds and handed to both packages.
The JAX reference runs its perfeature Pallas kernel (impl="pallas2") and
its flat one (impl="pallas", kernel B4's function) in interpret mode on
the CPU, as the JAX package's own tests run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu_torch.ops import histogram as TH


def _stats_np(n, rng, zero_tail=0):
    g = rng.normal(size=n).astype(np.float32)
    h = (np.abs(rng.normal(size=n)) * 0.3 + 0.05).astype(np.float32)
    mask = np.ones(n, np.float32)
    if zero_tail:
        mask[-zero_tail:] = 0.0          # padding rows: zero stats
    return g * mask, h * mask, mask


@pytest.mark.parametrize("precision", ["hilo", "bf16", "f32"])
def test_pack_stats_bitwise(precision):
    rng = np.random.default_rng(1)
    g, h, mask = _stats_np(4096, rng, zero_tail=100)
    ref = np.asarray(JH.pack_stats(jnp.asarray(g), jnp.asarray(h),
                                   jnp.asarray(mask), precision)
                     .astype(jnp.float32))
    got = TH.pack_stats(torch.from_numpy(g), torch.from_numpy(h),
                        torch.from_numpy(mask), precision).float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _hist_case(seed, nb, F, block, B, leaves, slots):
    rng = np.random.default_rng(seed)
    n = nb * block
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    g, h, mask = _stats_np(n, rng, zero_tail=37)
    leaf = rng.integers(0, leaves, size=n).astype(np.int32)
    return bins, g, h, mask, leaf, np.asarray(slots, np.int32)


@pytest.mark.parametrize("precision", ["hilo", "bf16", "f32"])
@pytest.mark.parametrize("case", [
    # K=5 with a dead slot, B=27 (not a multiple of 8), 2 row blocks
    dict(seed=3, nb=2, F=5, block=512, B=27, leaves=7,
         slots=[2, 0, -1, 6, 4]),
    # K=3, a leaf id in the slots that no row carries, B=13
    dict(seed=4, nb=3, F=3, block=256, B=13, leaves=4,
         slots=[1, 9, 3]),
])
def test_batched_twin_matches_pallas2(case, precision):
    bins, g, h, mask, leaf, slots = _hist_case(**case)
    F, n = bins.shape
    nb, block, B = case["nb"], case["block"], case["B"]
    stats_j = JH.pack_stats(jnp.asarray(g), jnp.asarray(h),
                            jnp.asarray(mask), precision)
    ref = np.asarray(JH.build_histogram_batched_t(
        jnp.asarray(bins.reshape(F, nb, block).transpose(1, 0, 2)),
        stats_j.reshape(stats_j.shape[0], nb, block),
        jnp.asarray(leaf.reshape(nb, block)), jnp.asarray(slots), B,
        precision, impl="pallas2"))
    stats_t = TH.pack_stats(torch.from_numpy(g), torch.from_numpy(h),
                            torch.from_numpy(mask), precision)
    got = TH.build_histogram_batched_t(
        torch.from_numpy(bins), stats_t, torch.from_numpy(leaf),
        torch.from_numpy(slots), B, precision).numpy()
    assert got.shape == ref.shape == (len(slots), F, B, 3)
    # counts: exact
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    # g, h: f32 summation order, within 1e-6 of the slot's sum of |stat|
    # (each row lands in one bin of every feature)
    for k, s in enumerate(slots):
        rows = leaf == s
        for j, v in ((0, g), (1, h)):
            tol = 1e-6 * max(float(np.abs(v[rows]).sum()), 1e-30)
            assert np.abs(got[k, :, :, j] - ref[k, :, :, j]).max() <= tol
    dead = slots < 0
    assert not got[dead].any()


def test_out_of_range_bins_contribute_nothing():
    rng = np.random.default_rng(5)
    F, n, B = 2, 300, 10
    bins = rng.integers(0, B + 3, size=(F, n)).astype(np.uint8)
    g, h, mask = _stats_np(n, rng)
    leaf = np.zeros(n, np.int32)
    stats = TH.pack_stats(torch.from_numpy(g), torch.from_numpy(h),
                          torch.from_numpy(mask), "f32")
    got = TH.build_histogram_batched_t(
        torch.from_numpy(bins), stats, torch.from_numpy(leaf),
        torch.tensor([0], dtype=torch.int32), B, "f32").numpy()
    for f in range(F):
        keep = bins[f] < B
        assert got[0, f, :, 2].sum() == keep.sum()
        np.testing.assert_allclose(got[0, f, :, 0].sum(), g[keep].sum(),
                                   rtol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    # the CPU twin is taken only by the dispatcher; the kernel wrapper
    # itself never falls back
    bins = torch.zeros((2, 8), dtype=torch.uint8)
    stats = torch.zeros((5, 8), dtype=torch.bfloat16)
    leaf = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TH.hist_batched_kernel(bins, stats, leaf,
                               torch.zeros(1, dtype=torch.int32), 4)


def test_flat_kernel_wrapper_refuses_cpu_tensors():
    # kernel B4's wrapper never falls back either, packed or not
    bins = torch.zeros((2, 512), dtype=torch.uint8)
    stats = torch.zeros((3, 512), dtype=torch.int8)
    leaf = torch.zeros(512, dtype=torch.int32)
    slots = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="kernel B4 takes CUDA"):
        TH.hist_flat_kernel(bins, stats, leaf, slots, 4)
    with pytest.raises(ValueError, match="kernel B4 takes CUDA"):
        TH.hist_flat_kernel(bins[:, :256], stats, leaf, slots, 4,
                            packed_block=256)


@pytest.mark.parametrize("precision", ["hilo", "int8", "int16"])
def test_flat_twin_matches_pallas_flat(precision):
    # the flat kernel's 256-row blocks; slot 4 repeats slot 1's leaf id
    # and gets the same sums (B1's contract, which B4 keeps)
    nb, block, B = 3, 256, 21
    bins, g, h, mask, leaf, slots = _hist_case(
        seed=6, nb=nb, F=4, block=block, B=B, leaves=6,
        slots=[2, 0, -1, 5, 0])
    F, n = bins.shape
    if precision == "hilo":
        stats_j = JH.pack_stats(jnp.asarray(g), jnp.asarray(h),
                                jnp.asarray(mask), precision)
        stats_t = TH.pack_stats(torch.from_numpy(g), torch.from_numpy(h),
                                torch.from_numpy(mask), precision)
    else:
        q = TH.quant_limit(precision, n)
        rng = np.random.default_rng(7)
        st = np.stack([rng.integers(-q, q + 1, size=n) * mask,
                       rng.integers(0, q + 1, size=n) * mask,
                       mask]).astype(np.dtype(precision))
        stats_j, stats_t = jnp.asarray(st), torch.from_numpy(st)
    ref = np.asarray(JH.build_histogram_batched_t(
        jnp.asarray(bins.reshape(F, nb, block).transpose(1, 0, 2)),
        stats_j.reshape(stats_j.shape[0], nb, block),
        jnp.asarray(leaf.reshape(nb, block)), jnp.asarray(slots), B,
        precision, impl="pallas"))
    got = TH.build_histogram_batched_t(
        torch.from_numpy(bins), stats_t, torch.from_numpy(leaf),
        torch.from_numpy(slots), B, precision, impl="pallas").numpy()
    assert got.shape == ref.shape == (len(slots), F, B, 3)
    np.testing.assert_array_equal(got[4], got[1])
    if precision != "hilo":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        return
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    for k, s in enumerate(slots):
        rows = leaf == s
        for j, v in ((0, g), (1, h)):
            tol = 1e-6 * max(float(np.abs(v[rows]).sum()), 1e-30)
            assert np.abs(got[k, :, :, j] - ref[k, :, :, j]).max() <= tol
