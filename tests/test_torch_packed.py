"""4-bit packed bins (tpu_pack_bins, max_bin<=15), lightgbm_tpu_torch
against lightgbm_tpu on the CPU.

The JAX learner stores every feature of 16 bins or fewer two rows a byte
when the histogram is "pallas"/"pallas2" and the partition select-family;
its perfeature and flat Pallas kernels (`_hist_pallas(...,
packed_rows=True)`) run here in interpret mode.  The port stores the same
bytes, unpacks them the same way in its partitions, and reads them
packed in kernels B1 and B4 (their plain twin unpacks, then runs the
unpacked twin).  Small shapes: 2,000
rows x 6 features, 15 leaves, max_bin=15, 5 iterations; int8 text is
compared with the JAX package compiled without FMA
(tests/test_torch_util.py).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu_torch.ops import histogram as TH

from .test_torch_slice import _close
from .test_torch_util import binary_data, run_jax_nofma

ROUNDS = 5
# the defaults but for the JAX package's "auto", which off its
# accelerator is "xla" (never packed); on the accelerator it is "pallas2",
# as the port's "auto" is
HILO = {"objective": "binary", "num_leaves": 15, "max_bin": 15,
        "min_data_in_leaf": 20, "learning_rate": 0.1, "tpu_split_batch": 4,
        "tpu_hist_impl": "pallas2", "verbosity": -1}
INT8 = dict(HILO, objective="regression", tpu_hist_precision="int8",
            tpu_quant_refit_leaves=False)
# block rows: the default (one 2,048-row block) and four blocks of 512
BLOCKS = [0, 512]


def _reg_data():
    X, _ = binary_data(n=2000, f=6, seed=0)
    rng = np.random.default_rng(3)
    Xn = np.nan_to_num(X)
    return X, Xn[:, 0] + 0.5 * Xn[:, 1] * Xn[:, 2] + 0.3 * rng.normal(
        size=len(X))


def _text(text, *params):
    """Model text with the parameter lines named normalized."""
    for name in ("device_type",) + params:
        text = re.sub(rf"^\[{name}: [^\]]*\]$", f"[{name}: -]", text,
                      flags=re.M)
    return text


# ---- storage and unpacking -----------------------------------------------

@pytest.mark.parametrize("block", [256, 512, 2048])
def test_unpack2d_matches_jax(block):
    rng = np.random.default_rng(block)
    nb = 3
    packed = rng.integers(0, 256, size=(4, nb * block // 2)).astype(np.uint8)
    ref = np.asarray(JH.unpack2d(jnp.asarray(
        packed.reshape(4, nb, block // 2)))).reshape(4, -1)
    got = TH.unpack2d(torch.from_numpy(packed), block)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    # pack_bins is its inverse
    np.testing.assert_array_equal(TH.pack_bins(got, block).numpy(), packed)


@pytest.mark.parametrize("F", [6, 32, 40])
def test_packed_row_major_copy(F):
    rng = np.random.default_rng(F)
    block, n = 512, 1536
    bins = rng.integers(0, 16, size=(F, n)).astype(np.uint8)
    packed = TH.pack_bins(torch.from_numpy(bins), block)
    rows = TH.row_major_bins(packed, block).numpy()
    fr = -(-F // 32) * 32
    assert rows.shape == (n, fr // 2)
    full = np.zeros((fr, n), np.uint8)
    full[:F] = bins
    # feature 2j in the low nibble of byte j, 2j + 1 in the high one
    np.testing.assert_array_equal(rows & 0xF, full[0::2].T)
    np.testing.assert_array_equal(rows >> 4, full[1::2].T)
    # kept on the matrix, per layout
    assert TH.row_major_bins(packed, block) is TH.row_major_bins(packed,
                                                                 block)


def test_packed_plan_counts_smaller_tiles():
    h100 = (132, 232448, 233472)
    for floats, S in ((True, 5), (False, 3)):
        full = TH.hist_plan(32, 25, S, 16, 1 << 20, *h100, floats=floats)
        packed = TH.hist_plan(32, 25, S, 16, 1 << 20, *h100, floats=floats,
                              packed=True)
        assert packed.smem <= full.smem
        assert packed._replace(smem=0) == full._replace(smem=0)
        assert packed.cluster == full.cluster == 1
    # the int32 sums' block: the bins tiles set its size
    assert TH._smem_bytes(25, 16, 3, 512, False, False, packed=True) \
        == TH._smem_bytes(25, 16, 3, 512, False, False) - 4 * 16 * 32 * 4
    with pytest.raises(ValueError):
        TH.hist_plan(32, 25, 5, 17, 1000, *h100, packed=True)


# ---- kernel B1's packed variant: the twin against the Pallas kernel -------

def _packed_case(seed, precision, F=5, nb=2, block=512, B=13, leaves=6,
                 slots=(2, 0, -1, 5), impl="pallas2"):
    rng = np.random.default_rng(seed)
    n = nb * block
    bins = rng.integers(0, 16, size=(F, n)).astype(np.uint8)  # some >= B
    leaf = rng.integers(0, leaves, size=n).astype(np.int32)
    slots = np.asarray(slots, np.int32)
    mask = np.ones(n, np.float32)
    mask[-37:] = 0.0
    if precision in ("int8", "int16"):
        q = TH.quant_limit(precision, n)
        stats = np.stack([rng.integers(-q, q + 1, size=n) * mask,
                          rng.integers(0, q + 1, size=n) * mask,
                          mask]).astype(np.dtype(precision))
        stats_j, stats_t = jnp.asarray(stats), torch.from_numpy(stats)
        g = h = None
    else:
        g = rng.normal(size=n).astype(np.float32) * mask
        h = (np.abs(rng.normal(size=n)) * 0.3 + 0.05).astype(np.float32) \
            * mask
        stats_j = JH.pack_stats(jnp.asarray(g), jnp.asarray(h),
                                jnp.asarray(mask), precision)
        stats_t = TH.pack_stats(torch.from_numpy(g), torch.from_numpy(h),
                                torch.from_numpy(mask), precision)
    packed = TH.pack_bins(torch.from_numpy(bins), block)
    ref = np.asarray(JH.build_histogram_batched_t(
        jnp.asarray(packed.numpy().reshape(F, nb, block // 2)
                    .transpose(1, 0, 2)),
        stats_j.reshape(stats_j.shape[0], nb, block),
        jnp.asarray(leaf.reshape(nb, block)), jnp.asarray(slots), B,
        precision, impl=impl, packed_rows=True))
    got = TH.build_histogram_batched_t(
        packed, stats_t, torch.from_numpy(leaf), torch.from_numpy(slots), B,
        precision, impl=impl, packed_block=block).numpy()
    return got, ref, g, h, leaf, slots


@pytest.mark.parametrize("precision", ["int8", "int16"])
def test_packed_twin_bitwise_to_pallas(precision):
    got, ref, *_ = _packed_case(11, precision)
    assert got.dtype == np.int32 and got.shape == ref.shape == (4, 5, 13, 3)
    np.testing.assert_array_equal(got, ref)


def _assert_hilo_close(got, ref, g, h, leaf, slots):
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    # as tests/test_torch_histogram.py: within 1e-6 of the slot's sum of
    # |stat|
    for k, s in enumerate(slots):
        rows = leaf == s
        for j, v in ((0, g), (1, h)):
            tol = 1e-6 * max(float(np.abs(v[rows]).sum()), 1e-30)
            assert np.abs(got[k, :, :, j] - ref[k, :, :, j]).max() <= tol


def test_packed_twin_hilo_to_pallas():
    _assert_hilo_close(*_packed_case(12, "hilo"))


# kernel B4's packed read: the flat Pallas kernel on its 256-row blocks,
# and slots that hold one leaf id twice
FLAT = dict(impl="pallas", block=256, nb=4, slots=(2, 0, -1, 5, 0))


@pytest.mark.parametrize("precision", ["int8", "int16"])
def test_packed_flat_twin_bitwise_to_pallas(precision):
    got, ref, *_ = _packed_case(13, precision, **FLAT)
    assert got.dtype == np.int32 and got.shape == ref.shape == (5, 5, 13, 3)
    np.testing.assert_array_equal(got, ref)
    # the duplicated slot holds the same sums as the first
    np.testing.assert_array_equal(got[4], got[1])


def test_packed_flat_twin_hilo_to_pallas():
    _assert_hilo_close(*_packed_case(14, "hilo", **FLAT))


# ---- the whole slice at max_bin=15 ------------------------------------------

@pytest.fixture(scope="module", params=BLOCKS, ids=lambda b: f"block{b}")
def hilo_pair(request):
    X, y = binary_data(n=2000, f=6, seed=0)
    params = dict(HILO, tpu_block_rows=request.param)
    bj = jlgb.train(dict(params), jlgb.Dataset(X, label=y),
                    num_boost_round=ROUNDS, keep_training_booster=True)
    bt = tlgb.train(dict(params, device_type="cpu"),
                    tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                    keep_training_booster=True)
    return X, y, params, bj, bt


def test_packed_bins_equal_jax(hilo_pair):
    *_, bj, bt = hilo_pair
    lj, lt = bj._driver.learner, bt._driver.learner
    assert lj.packed_bins and lt.packed_bins
    assert (lt.n_pad, lt.f_pad) == (lj.n_pad, lj.f_pad) == (2048, 32)
    assert tuple(lt.bins_t.shape) == (32, 1024)
    assert lt.bins_t.dtype == torch.uint8
    np.testing.assert_array_equal(lt.bins_t.numpy(), np.asarray(lj.bins_t))


def test_packed_hilo_trees_equal_jax(hilo_pair):
    X, _, _, bj, bt = hilo_pair
    bj._driver._materialize()
    bt._driver._materialize()
    tj, tt = bj._driver.models, bt._driver.models
    assert len(tt) == len(tj) == ROUNDS
    for i, (a, b) in enumerate(zip(tj, tt)):
        assert b.num_leaves == a.num_leaves, i
        ni = a.num_leaves - 1
        for name in ("split_feature_inner", "threshold_in_bin",
                     "decision_type", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:ni],
                                          getattr(a, name)[:ni],
                                          err_msg=f"tree {i} {name}")
        _close(b.leaf_value[:a.num_leaves], a.leaf_value[:a.num_leaves])
        np.testing.assert_array_equal(b.leaf_count[:a.num_leaves],
                                      a.leaf_count[:a.num_leaves])
    _close(bt.predict(X), bj.predict(X))


@pytest.mark.parametrize("partition", ["vselect"])
def test_packed_hilo_layouts_and_lowerings_same_text(hilo_pair, partition):
    # packing is a layout: the unpacked run, and the other select-family
    # lowering, write the same model text
    X, y, params, _, bt = hilo_pair
    text = bt.model_to_string()
    for extra, name in (({"tpu_pack_bins": False}, "tpu_pack_bins"),
                        ({"tpu_partition_impl": partition},
                         "tpu_partition_impl")):
        b = tlgb.train(dict(params, device_type="cpu", **extra),
                       tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                       keep_training_booster=True)
        assert b._driver.learner.packed_bins == (name != "tpu_pack_bins")
        assert _text(b.model_to_string(), name) == _text(text, name)


@pytest.fixture(scope="module")
def int8_pair(tmp_path_factory):
    X, y = _reg_data()
    runs = [dict(INT8, tpu_block_rows=b, label="reg") for b in BLOCKS]
    out = run_jax_nofma("train", {"X": X, "y_reg": y},
                        {"runs": runs, "rounds": ROUNDS},
                        tmp_path_factory.mktemp("packed"))
    return X, y, out


@pytest.mark.parametrize("c", range(len(BLOCKS)),
                         ids=[f"block{b}" for b in BLOCKS])
def test_packed_int8_model_text_byte_identical(int8_pair, c):
    X, y, out = int8_pair
    params = dict(INT8, tpu_block_rows=BLOCKS[c], device_type="cpu")
    bt = tlgb.train(params, tlgb.Dataset(X, label=y),
                    num_boost_round=ROUNDS, keep_training_booster=True)
    assert bt._driver.learner.packed_bins
    assert bt._driver.learner.params.hist_impl == "pallas2"
    text = bt.model_to_string()
    assert "\ntpu_feature_profile:" in text
    assert _text(text) == _text(str(out[f"{c}_text"]))
    # and the unpacked run writes it too
    b = tlgb.train(dict(params, tpu_pack_bins=False),
                   tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                   keep_training_booster=True)
    assert not b._driver.learner.packed_bins
    assert _text(b.model_to_string(), "tpu_pack_bins") == \
        _text(text, "tpu_pack_bins")


# ---- kernel B4's packed read in the whole slice ----------------------------

@pytest.fixture(scope="module")
def flat_int_pair(tmp_path_factory):
    X, y = _reg_data()
    runs = [dict(INT8, tpu_hist_precision=p, tpu_hist_impl="pallas",
                 label="reg") for p in ("int8", "int16")]
    out = run_jax_nofma("train", {"X": X, "y_reg": y},
                        {"runs": runs, "rounds": ROUNDS},
                        tmp_path_factory.mktemp("packed_flat"))
    return X, y, out


@pytest.mark.parametrize("c,precision", enumerate(["int8", "int16"]),
                         ids=["int8", "int16"])
def test_packed_flat_int_model_text_byte_identical(flat_int_pair, c,
                                                   precision):
    X, y, out = flat_int_pair
    params = dict(INT8, tpu_hist_precision=precision, tpu_hist_impl="pallas",
                  device_type="cpu")
    bt = tlgb.train(params, tlgb.Dataset(X, label=y),
                    num_boost_round=ROUNDS, keep_training_booster=True)
    learner = bt._driver.learner
    assert learner.packed_bins and learner.params.hist_impl == "pallas"
    # the flat kernel's 256-row blocks are the pack layout's
    assert learner.packed_block == 256
    text = bt.model_to_string()
    assert _text(text) == _text(str(out[f"{c}_text"]))
    # and the unpacked run writes it too
    b = tlgb.train(dict(params, tpu_pack_bins=False),
                   tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                   keep_training_booster=True)
    assert not b._driver.learner.packed_bins
    assert _text(b.model_to_string(), "tpu_pack_bins") == \
        _text(text, "tpu_pack_bins")
