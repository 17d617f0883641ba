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


# ---- kernel B3's edge cases: the twin held to the Pallas kernel ----------

def _edge_case(name, seed=21):
    """_case with the slot layout kernel B3 treats apart: its leaf id ->
    slot table, the chain between slots of one leaf, the do flags."""
    c = _case(seed, n=2048, F=6, K=6, leaves=10)
    K = len(c["sel"])
    if name == "dup":
        # slots 0 and 3 hold one leaf id (each with its own feature and
        # threshold): its rows take the larger new id of the slots that
        # move them
        c["sel"][3] = c["sel"][0]
        for k in ("feat", "thr", "mt", "nbf", "db"):   # slot 4's split
            c[k][3] = c[k][4]
    elif name == "dup_dead":
        # a slot that repeats a live leaf id but is not split
        c["sel"][3] = c["sel"][0]
        c["do_k"][3] = False
    elif name == "high_ids":
        # leaf ids past the 4096-entry table, one of them held twice
        c["leaf"] = c["leaf"] + 4090
        c["sel"] = c["sel"] + 4090
        c["sel"][4] = c["sel"][1]
        c["new_ids"] = c["new_ids"] + 5000
    elif name == "do_false":
        c["do_k"] = np.arange(K) % 2 == 0
    elif name == "missing":
        # every missing type on each default direction
        c["mt"] = np.array([MISSING_NAN, MISSING_NAN, MISSING_ZERO,
                            MISSING_ZERO, MISSING_NONE, MISSING_NONE],
                           np.int32)
        c["dleft"] = np.arange(K) % 2 == 0
        c["do_k"] = np.ones(K, bool)
    return c


EDGE_CASES = ["dup", "dup_dead", "high_ids", "do_false", "missing"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_twin_edge_cases_bitwise_to_pallas(name):
    c = _edge_case(name)
    ref = _jax_ref(c)
    got = TF.partition_rows(*_port_args(c)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != c["leaf"]).any()


def test_twin_duplicate_slots_take_the_larger_new_id():
    c = _edge_case("dup")
    got = TF.partition_rows(*_port_args(c)).numpy()
    rows = c["leaf"] == c["sel"][0]
    moved = got[rows][got[rows] != c["sel"][0]]
    # rows that only the later slot moves take its id, the others the max
    assert set(moved.tolist()) <= {int(c["new_ids"][0]),
                                   int(c["new_ids"][3])}
    assert int(c["new_ids"][3]) in set(moved.tolist())


def test_partition_args_checked_as_the_kernel_takes_them():
    args = _port_args(_case(0))
    TF.check_partition_args(*args)
    # the flags may be bool or uint8 bytes
    TF.check_partition_args(*args[:6], args[6].to(torch.uint8), *args[7:])
    with pytest.raises(ValueError, match="thr"):
        TF.check_partition_args(*args[:5], args[5].long(), *args[6:])
    with pytest.raises(ValueError, match="do_k"):
        TF.check_partition_args(*args[:10], args[10].int())
    with pytest.raises(ValueError, match="leaf_ids"):
        TF.check_partition_args(args[0], args[1], args[2].long(), *args[3:])


def test_grower_hands_the_kernel_its_types(monkeypatch):
    # on the CPU the grower's kernel lowering runs the twin; the arguments
    # it passes must be what kernel B3 takes without a host conversion
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.ops import grower as TG

    from .test_torch_util import binary_data

    calls = []

    def checked(*args):
        TF.check_partition_args(*args)
        calls.append(args[3].shape[0])
        return TF.partition_rows(*args)

    monkeypatch.setattr(TG, "partition_rows", checked)
    X, y = binary_data(n=600, f=4, seed=3)
    tlgb.train({"objective": "binary", "num_leaves": 15,
                "tpu_partition_impl": "kernel", "device_type": "cpu",
                "verbosity": -1}, tlgb.Dataset(X, label=y),
               num_boost_round=2)
    assert calls
