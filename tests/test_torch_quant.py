"""lightgbm_tpu_torch's quantized-gradient pieces against lightgbm_tpu.

quant_limit, the hashed uniforms, quantize_values (both modes and the
flag form), int8/int16 pack_stats, the integer batched histogram and the
integer split scan (per_feature_best_split with acc_scale), on the same
seeded numpy inputs.  All of it is integer arithmetic or single f32
operations, so every comparison is bitwise.  The JAX functions run
eagerly, one XLA op at a time; the JAX histogram runs its perfeature
Pallas kernel in interpret mode and its XLA scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import split as TS

PRECS = ("int8", "int16")


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("rows", [1, 4096, 70_000, 20_000_000])
def test_quant_limit(precision, rows):
    assert TH.quant_limit(precision, rows) == JH.quant_limit(precision, rows)


def test_quant_limit_refuses_overflowing_row_counts():
    with pytest.raises(ValueError, match="overflow"):
        TH.quant_limit("int16", 2 ** 32)


@pytest.mark.parametrize("seeds", [(0, 0, 0), (123, 456789, 0x9E3779B9),
                                   (2 ** 32 - 1, 5, 0x85EBCA6B)])
def test_hashed_uniform_bitwise(seeds):
    idx = np.arange(50_000, dtype=np.uint32) * np.uint32(7919)
    ref = np.asarray(JH.hashed_uniform(jnp.asarray(idx), *seeds))
    got = TH.hashed_uniform(torch.from_numpy(idx.astype(np.int64)),
                            *seeds).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _values(n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 3).astype(np.float32)
    x[:5] = [0.0, -0.0, 1e-30, -7.25, 7.25]
    return x


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("mode", ["stochastic", "nearest"])
def test_quantize_values_bitwise(precision, mode):
    x = _values()
    q = JH.quant_limit(precision, x.size)
    scale = np.float32(np.abs(x).max()) / np.float32(q)
    kw = dict(seed_a=977, seed_b=2 ** 31 + 3, row_offset=11,
              salt=0x9E3779B9)
    ref = np.asarray(JH.quantize_values(jnp.asarray(x), jnp.float32(scale),
                                        q, mode, **kw))
    got = TH.quantize_values(torch.from_numpy(x), scale, q, mode,
                             **kw).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() <= q


@pytest.mark.parametrize("flag", [0.0, 1.0])
def test_quantize_values_flag_form_bitwise(flag):
    x = _values(seed=1)
    scale = np.float32(np.abs(x).max() / 127)
    ref = np.asarray(JH.quantize_values(
        jnp.asarray(x), jnp.float32(scale), 127, "stochastic", 3, 4,
        salt=0x85EBCA6B, stochastic=jnp.float32(flag)))
    got = TH.quantize_values(torch.from_numpy(x), scale, 127, "stochastic",
                             3, 4, salt=0x85EBCA6B, stochastic=flag).numpy()
    np.testing.assert_array_equal(got, ref)
    # each branch of the flag equals its static mode
    mode = "stochastic" if flag else "nearest"
    np.testing.assert_array_equal(got, TH.quantize_values(
        torch.from_numpy(x), scale, 127, mode, 3, 4,
        salt=0x85EBCA6B).numpy())


def test_key_words():
    key = np.array([0xDEADBEEF, 17], np.uint32)
    assert TH.key_words(key) == tuple(int(w) for w in JH.key_words(
        jnp.asarray(key)))


def _int_stats(n, precision, rng, tail=0):
    q = JH.quant_limit(precision, n)
    g = rng.integers(-q, q + 1, size=n).astype(np.int32)
    h = rng.integers(0, q + 1, size=n).astype(np.int32)
    mask = np.ones(n, np.float32)
    if tail:
        mask[-tail:] = 0.0
    return g * mask.astype(np.int32), h * mask.astype(np.int32), mask


@pytest.mark.parametrize("precision", PRECS)
def test_pack_stats_int_bitwise(precision):
    g, h, mask = _int_stats(4096, precision, np.random.default_rng(2), 99)
    ref = np.asarray(JH.pack_stats(jnp.asarray(g), jnp.asarray(h),
                                   jnp.asarray(mask), precision))
    got = TH.pack_stats(torch.from_numpy(g), torch.from_numpy(h),
                        torch.from_numpy(mask), precision).numpy()
    assert got.dtype == ref.dtype == np.dtype(precision)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("impl", ["pallas2", "xla"])
@pytest.mark.parametrize("case", [
    dict(seed=3, nb=2, F=5, block=512, B=27, leaves=7,
         slots=[2, 0, -1, 6, 4]),
    dict(seed=4, nb=3, F=3, block=256, B=13, leaves=4, slots=[1, 9, 3]),
])
def test_batched_int_histogram_bitwise(precision, impl, case):
    rng = np.random.default_rng(case["seed"])
    nb, F, block, B = case["nb"], case["F"], case["block"], case["B"]
    n = nb * block
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    g, h, mask = _int_stats(n, precision, rng, 37)
    leaf = rng.integers(0, case["leaves"], size=n).astype(np.int32)
    slots = np.asarray(case["slots"], np.int32)
    stats_j = JH.pack_stats(jnp.asarray(g), jnp.asarray(h),
                            jnp.asarray(mask), precision)
    ref = np.asarray(JH.build_histogram_batched_t(
        jnp.asarray(bins.reshape(F, nb, block).transpose(1, 0, 2)),
        stats_j.reshape(3, nb, block), jnp.asarray(leaf.reshape(nb, block)),
        jnp.asarray(slots), B, precision, impl=impl))
    got = TH.build_histogram_batched_t(
        torch.from_numpy(bins),
        TH.pack_stats(torch.from_numpy(g), torch.from_numpy(h),
                      torch.from_numpy(mask), precision),
        torch.from_numpy(leaf), torch.from_numpy(slots), B,
        precision).numpy()
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


KW = dict(l1=0.0, l2=0.0, max_delta_step=0.0, min_data_in_leaf=20.0,
          min_sum_hessian=1e-3, min_gain_to_split=0.0)


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("extra", [{}, dict(l1=0.3, l2=1.5,
                                             max_delta_step=0.7)])
def test_int_split_scan_bitwise(precision, extra):
    # one leaf's int32 [F, B, 3] histogram from quantized rows; NaN-, zero-
    # and no-missing features, a 2-bin NaN feature, a masked and a
    # penalized one
    rng = np.random.default_rng(8)
    n, F, B = 3000, 7, 33
    q = JH.quant_limit(precision, n)
    num_bin = rng.integers(8, B + 1, size=F).astype(np.int32)
    num_bin[3] = 2
    missing = np.array([2, 1, 0, 2, 1, 0, 2], np.int32)
    default_bin = np.array([rng.integers(0, nb) for nb in num_bin],
                           np.int32)
    g = rng.integers(-q, q + 1, size=n)
    h = rng.integers(1, q + 1, size=n)
    hist = np.zeros((F, B, 3), np.int64)
    for f in range(F):
        b = rng.integers(0, num_bin[f], size=n)
        np.add.at(hist[f, :, 0], b, g)
        np.add.at(hist[f, :, 1], b, h)
        np.add.at(hist[f, :, 2], b, 1)
    hist = hist.astype(np.int32)
    scale = np.array([1.7 / q, 0.9 / q, 1.0], np.float32)
    sums = (np.float32(g.sum()) * scale[0], np.float32(h.sum()) * scale[1],
            np.float32(n))
    meta = dict(num_bin=num_bin, missing_type=missing,
                default_bin=default_bin, monotone=np.zeros(F, np.int32),
                penalty=np.ones(F, np.float32),
                feature_mask=np.ones(F, np.float32))
    meta["penalty"][5] = 0.5
    meta["feature_mask"][4] = 0.0
    kw = dict(KW, **extra)
    mj = {k: jnp.asarray(v) for k, v in meta.items()}
    ref = JS.per_feature_best_split(
        jnp.asarray(hist), *[jnp.float32(s) for s in sums], mj["num_bin"],
        mj["missing_type"], mj["default_bin"], mj["monotone"],
        mj["penalty"], mj["feature_mask"], acc_scale=jnp.asarray(scale),
        **kw)
    mt = {k: torch.from_numpy(v) for k, v in meta.items()}
    got = TS.per_feature_best_split(
        torch.from_numpy(hist), *[torch.tensor(s) for s in sums],
        mt["num_bin"], mt["missing_type"], mt["default_bin"],
        mt["monotone"], mt["penalty"], mt["feature_mask"],
        acc_scale=torch.from_numpy(scale), **kw)
    for name in ("gain", "threshold", "default_left", "left_sum_g",
                 "left_sum_h", "left_count"):
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        np.testing.assert_array_equal(b.view(a.dtype) if b.dtype == a.dtype
                                      else b, a, err_msg=name)
        if a.dtype == np.float32:
            np.testing.assert_array_equal(b.view(np.int32),
                                          a.view(np.int32), err_msg=name)
    assert (got.gain > 0).any()
