"""lightgbm_tpu_torch's threefry keys (utils/prng.py) against jax.random.

The port computes the key stream on the host with numpy uint32 integer
arithmetic; every key must equal JAX's bit for bit, under both forms of
`split` (`jax_threefry_partitionable` True and False).
"""

import jax
import numpy as np
import pytest

from lightgbm_tpu_torch.utils import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1, -7, 2 ** 33 + 5]


@pytest.fixture(autouse=True)
def x32_mode():
    # the port's keys are JAX's default 32-bit-mode keys; a test elsewhere
    # in the process may have left 64-bit mode on
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def partitionable(request):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_key_data(seed):
    ref = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    got = prng.key_data(prng.PRNGKey(seed))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 7])
def test_split_bitwise(partitionable, seed, num):
    ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(prng.PRNGKey(seed), num, partitionable)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("data", [0, 7, 0x5154, 2 ** 32 - 1])
def test_fold_in_bitwise(partitionable, data):
    for seed in SEEDS:
        ref = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        np.testing.assert_array_equal(
            prng.fold_in(prng.PRNGKey(seed), data), ref)


def test_training_key_stream(partitionable):
    # the training step's per-iteration draws (learner.py:1135,1196):
    # split off the feature-fraction key, then the node key, then fold in
    # the quantization salt -- twenty iterations deep
    kj, kt = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for _ in range(20):
        kj, _ = jax.random.split(kj)
        kj, nj = jax.random.split(kj)
        kt = prng.split(kt, partitionable=partitionable)[0]
        kt, nt = prng.split(kt, partitionable=partitionable)
        np.testing.assert_array_equal(
            prng.fold_in(nt, 0x5154),
            np.asarray(jax.random.fold_in(nj, 0x5154)))
    np.testing.assert_array_equal(kt, np.asarray(kj))


def test_key_data_refuses_other_shapes():
    with pytest.raises(ValueError, match="uint32"):
        prng.key_data(np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="uint32"):
        prng.key_data(np.zeros(2, np.int64))
