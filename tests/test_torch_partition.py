"""lightgbm_tpu_torch row partition (kernel B3's module) against
lightgbm_tpu's `partition_rows` Pallas kernel, run in interpret mode on
the CPU.  The integer math must agree bitwise, NaN-missing and
zero-missing columns included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.fused import partition_rows as j_partition_rows
from lightgbm_tpu_torch.ops import fused as TF

MISSING_NONE, MISSING_ZERO, MISSING_NAN = 0, 1, 2


def _case(seed, n=1024, F=6, K=5, leaves=8):
    rng = np.random.default_rng(seed)
    num_bin = rng.integers(4, 40, size=F).astype(np.int32)
    bins = np.stack([rng.integers(0, nb, size=n) for nb in num_bin]
                    ).astype(np.uint8)
    missing = np.array([MISSING_NAN, MISSING_ZERO, MISSING_NONE] * F,
                       np.int32)[:F]
    default_bin = np.array([rng.integers(0, nb) for nb in num_bin], np.int32)
    leaf = rng.integers(0, leaves, size=n).astype(np.int32)
    sel = rng.permutation(leaves)[:K].astype(np.int32)
    new_ids = (leaves + np.arange(K)).astype(np.int32)
    feat = rng.integers(0, F, size=K).astype(np.int32)
    feat[:3] = [0, 1, 2]          # one slot each on NaN-, zero-, no-missing
    thr = np.array([rng.integers(0, num_bin[f] - 1) for f in feat], np.int32)
    dleft = rng.random(K) < 0.5
    do_k = np.arange(K) < K - 1   # the last slot is dead
    return dict(bins=bins, feat=feat, leaf=leaf, sel=sel, new_ids=new_ids,
                thr=thr, dleft=dleft, mt=missing[feat], nbf=num_bin[feat],
                db=default_bin[feat], do_k=do_k)


def _port_args(c, dev="cpu"):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in c.items()}
    return (t["bins"], t["feat"], t["leaf"], t["sel"], t["new_ids"],
            t["thr"], t["dleft"], t["mt"], t["nbf"], t["db"], t["do_k"])


def _jax_ref(c, block=256):
    n = c["leaf"].shape[0]
    out = j_partition_rows(
        jnp.asarray(c["bins"][c["feat"]].astype(np.int32)),
        jnp.asarray(c["leaf"]), jnp.asarray(c["sel"]),
        jnp.asarray(c["new_ids"]), jnp.asarray(c["thr"]),
        jnp.asarray(c["dleft"]), jnp.asarray(c["mt"]),
        jnp.asarray(c["nbf"]), jnp.asarray(c["db"]),
        jnp.asarray(c["do_k"]), n // block, block)
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_bitwise_equal_to_pallas_kernel(seed):
    c = _case(seed)
    ref = _jax_ref(c)
    got = TF.partition_rows(*_port_args(c)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    # the missing-value routes were exercised: rows at the NaN bin of
    # slot 0's feature and at the zero bin of slot 1's feature
    assert (c["bins"][0] == c["nbf"][0] - 1).any()
    assert (c["bins"][1] == c["db"][1]).any()


def test_rows_of_other_leaves_and_dead_slots_stay():
    c = _case(7)
    got = TF.partition_rows(*_port_args(c)).numpy()
    live = set(c["sel"][c["do_k"]].tolist())
    stay = ~np.isin(c["leaf"], list(live))
    np.testing.assert_array_equal(got[stay], c["leaf"][stay])
    moved = got != c["leaf"]
    assert moved.any()
    assert set(got[moved].tolist()) <= set(c["new_ids"][c["do_k"]].tolist())


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        TF.partition_rows_kernel(*_port_args(_case(0)))
