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


@pytest.mark.parametrize("n", [1, 2, 28, 32, 1625, 1626, 5000])
def test_permutation_bitwise(partitionable, n):
    # 1 takes no sort round, 2..1625 one, 1626 on two (the round count
    # ceil(3 log n / log(2**32 - 1))); the feature_fraction draw of the
    # training step permutes F features with its split-off key kf
    for seed in SEEDS:
        for kj, kt in ((jax.random.PRNGKey(seed), prng.PRNGKey(seed)),
                       (jax.random.split(jax.random.PRNGKey(seed))[1],
                        prng.split(prng.PRNGKey(seed),
                                   partitionable=partitionable)[1])):
            ref = np.asarray(jax.random.permutation(kj, n))
            got = prng.permutation(kt, n, partitionable)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_random_bits_bitwise(partitionable, n):
    key = prng.split(prng.PRNGKey(11), partitionable=partitionable)[0]
    ref = np.asarray(jax.random.bits(jnp_key(key), (n,), np.uint32))
    np.testing.assert_array_equal(prng.random_bits(key, n, partitionable),
                                  ref)


def jnp_key(words):
    import jax.numpy as jnp

    return jnp.asarray(words, jnp.uint32)
