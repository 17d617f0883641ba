"""Threefry-2x32 PRNG keys on the host, bit-equal to `jax.random`'s.

The JAX package draws every per-iteration key from `PRNGKey(seed)` with
`split` and `fold_in` (models/gbdt.py, models/learner.py), and the
quantized grower turns one of them into the two seed words of its
stochastic rounding.  This module computes the same keys with integer
arithmetic on numpy uint32 arrays (wrapping adds, rotations, xors), so
the port reproduces the JAX package's rounding draws without importing
JAX.  The key stream never depends on device data, so it costs the card
no synchronisation.

A key is a numpy uint32 array of shape (2,), as `jax.random.PRNGKey`
returns in its default 32-bit mode.  The threefry2x32 hash and the two
forms of `split` follow jax/_src/prng.py: the "partitionable" form
(`jax_threefry_partitionable=True`, the default of current JAX) hashes
the counter pairs (0, i); the original form hashes an iota of 2*num
counters split into two halves.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64).astype(np.uint32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 block cipher (20 rounds) on uint32 arrays:
    returns the two hashed words of each counter pair (x0, x1)."""
    k1, k2 = _u32(k1), _u32(k2)
    x0 = np.array(x0, dtype=np.uint32, ndmin=1)
    x1 = np.array(x1, dtype=np.uint32, ndmin=1)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r)
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _hash_counts(key: np.ndarray, count: np.ndarray) -> np.ndarray:
    """`threefry_2x32(keypair, count)`: hash a flat counter array whose
    first half pairs with its second half (padded with 0 when odd)."""
    flat = np.asarray(count, np.uint32).ravel()
    odd = flat.size % 2
    if odd:
        flat = np.concatenate([flat, np.zeros(1, np.uint32)])
    half = flat.size // 2
    y0, y1 = threefry2x32(key[0], key[1], flat[:half], flat[half:])
    out = np.concatenate([y0, y1])
    return out[:-1] if odd else out


def PRNGKey(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` in JAX's default 32-bit mode: the key
    (0, seed mod 2**32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def key_data(key) -> np.ndarray:
    """The raw uint32[2] words of a key."""
    arr = np.asarray(key)
    if arr.shape != (2,) or arr.dtype != np.uint32:
        raise ValueError(f"a threefry key is uint32[2], got {arr.dtype} "
                         f"{arr.shape}")
    return arr


def split(key, num: int = 2, partitionable: bool = True) -> np.ndarray:
    """`jax.random.split(key, num)`: [num, 2] uint32 keys.

    partitionable selects the form of `jax_threefry_partitionable`
    (True, the default of the installed JAX; False, the original)."""
    key = key_data(key)
    num = int(num)
    if partitionable:
        b1, b2 = threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
        return np.stack([b1, b2], axis=1)
    counts = np.arange(2 * num, dtype=np.uint32)
    return _hash_counts(key, counts).reshape(num, 2)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`: the key hashed with the counter
    pair (0, data mod 2**32); the same under either split form."""
    key = key_data(key)
    return _hash_counts(key, np.array([0, int(data) & 0xFFFFFFFF],
                                      np.uint32))


def random_bits(key, n: int, partitionable: bool = True) -> np.ndarray:
    """`jax.random.bits(key, (n,), uint32)`: [n] uint32.  The partitionable
    form hashes the counter pairs (0, i) and xors the two words; the
    original hashes an iota of n counters split into two halves."""
    key = key_data(key)
    n = int(n)
    if partitionable:
        b1, b2 = threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                              np.arange(n, dtype=np.uint32))
        return b1 ^ b2
    return _hash_counts(key, np.arange(n, dtype=np.uint32))


def permutation(key, n: int, partitionable: bool = True) -> np.ndarray:
    """`jax.random.permutation(key, n)`: [n] int32, a shuffle of
    arange(n) by repeated stable sorts on fresh 32-bit keys
    (jax/_src/random.py:_shuffle).  The round count,
    ceil(3 * log(n) / log(2**32 - 1)), is 0 at n = 1, 1 up to n = 1625
    and 2 from there to about 2.6 million."""
    n = int(n)
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key, 2, partitionable)
        bits = random_bits(sub, n, partitionable)
        x = x[np.argsort(bits, kind="stable")]
    return x


def uniform(key, shape, partitionable: bool = True) -> np.ndarray:
    """`jax.random.uniform(key, shape)` (f32 in [0, 1)): the random bits
    of the flattened shape, their top 23 bits as the mantissa of a float
    in [1, 2), minus 1."""
    shape = tuple(int(s) for s in np.atleast_1d(np.asarray(shape, np.int64)))
    size = int(np.prod(shape, dtype=np.int64))
    bits = random_bits(key, size, partitionable)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats).reshape(shape)
