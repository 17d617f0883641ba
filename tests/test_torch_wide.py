"""Wide bins (max_bin>255: more than 256 bins a feature, stored int32),
lightgbm_tpu_torch against lightgbm_tpu on the CPU.

The JAX learner stores int32 bins once a feature has more than 256 bins,
and every Pallas kernel reads them: the perfeature and flat histograms
(`_hist_pallas`), the grow megakernel (`fused_hist_scan`) and the row
partition (`partition_rows`), each run here in interpret mode (the
bitwise B2 case and the model texts in the JAX process compiled without
FMA, tests/test_torch_util.py).  The port stores the same int32 matrix;
its twins take it as it is.  Small shapes: a few thousand rows, at most
6 features, max_bin=511.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops.fused import partition_rows as j_partition_rows
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.models.learner import TreeLearner
from lightgbm_tpu_torch.ops import fused as TF
from lightgbm_tpu_torch.ops import histogram as TH

from .test_torch_util import (FUSED_KEYS, assert_trees_match, binary_data,
                              fused_args, fused_case, run_jax_nofma)

# NVIDIA H100 SXM: SMs, opt-in shared memory of a block, of an SM
H100 = (132, 232448, 233472)
# a model of the clusters such a card holds at once: its SMs in GPCs of
# 16 and 18, a cluster inside one GPC (the plan asks the card itself)
H100_GPCS = [16] * 6 + [18] * 2


def h100_resident(threads, smem, cluster):
    per_sm = min(2048 // threads, H100[2] // (smem + 1024))
    return sum(g * per_sm // cluster for g in H100_GPCS)


def _text(text):
    """The whole model text with the device_type line normalized."""
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


# ---- 1. the layout ----------------------------------------------------------

@pytest.mark.parametrize("max_bin,dtype", [(511, np.int32), (256, np.uint8)],
                         ids=["wide", "b256"])
def test_layout_equals_jax(max_bin, dtype):
    X, y = binary_data(n=3000, f=3, seed=4, nan_frac=0.0)
    p = {"objective": "binary", "num_leaves": 2, "max_bin": max_bin,
         "min_data_in_bin": 1, "tpu_hist_impl": "pallas2", "verbosity": -1}
    bj = jlgb.train(dict(p), jlgb.Dataset(X, label=y, params=p), 1,
                    keep_training_booster=True)
    bt = tlgb.train(dict(p, device_type="cpu"),
                    tlgb.Dataset(X, label=y, params=p), 1,
                    keep_training_booster=True)
    lj, lt = bj._driver.learner, bt._driver.learner
    assert lt.num_bins == (max_bin if dtype == np.int32 else 256)
    ref = np.asarray(lj.bins_t)
    assert ref.dtype == dtype
    assert lt.bins_t.dtype == {np.int32: torch.int32,
                               np.uint8: torch.uint8}[dtype]
    assert (lt.n_pad, lt.f_pad) == (lj.n_pad, lj.f_pad)
    np.testing.assert_array_equal(lt.bins_t.numpy(), ref)


# ---- 2. B1's and B4's twin against _hist_pallas -----------------------------

def _wide_hist_case(B, precision, nb=2, block=512, F=5):
    rng = np.random.default_rng(B)
    n = nb * block
    bins = rng.integers(0, B, size=(F, n)).astype(np.int32)
    leaf = rng.integers(0, 6, size=n).astype(np.int32)
    slots = np.array([2, 0, -1, 5], np.int32)          # a dead slot
    mask = np.ones(n, np.float32)
    mask[-37:] = 0.0
    if precision in TH.INT_PRECISIONS:
        q = TH.quant_limit(precision, n)
        st = np.stack([rng.integers(-q, q + 1, size=n) * mask,
                       rng.integers(0, q + 1, size=n) * mask,
                       mask]).astype(np.dtype(precision))
        stats_j, stats_t, gh = jnp.asarray(st), torch.from_numpy(st), None
    else:
        g = rng.normal(size=n).astype(np.float32) * mask
        h = (np.abs(rng.normal(size=n)) * 0.3 + 0.05).astype(np.float32) \
            * mask
        stats_j = JH.pack_stats(jnp.asarray(g), jnp.asarray(h),
                                jnp.asarray(mask), precision)
        stats_t = TH.pack_stats(torch.from_numpy(g), torch.from_numpy(h),
                                torch.from_numpy(mask), precision)
        gh = (g, h)
    return bins, leaf, slots, stats_j, stats_t, gh


@pytest.mark.parametrize("impl", ["pallas2", "pallas"],
                         ids=["perfeature", "flat"])
@pytest.mark.parametrize("precision", ["int8", "int16", "hilo", "bf16",
                                       "f32"])
@pytest.mark.parametrize("B", [257, 600])
def test_twin_matches_hist_pallas(B, precision, impl):
    nb, block = 2, 512
    bins, leaf, slots, stats_j, stats_t, gh = _wide_hist_case(B, precision)
    F, n = bins.shape
    ref = np.asarray(JH.build_histogram_batched_t(
        jnp.asarray(bins.reshape(F, nb, block).transpose(1, 0, 2)),
        stats_j.reshape(stats_j.shape[0], nb, block),
        jnp.asarray(leaf.reshape(nb, block)), jnp.asarray(slots), B,
        precision, impl=impl))
    got = TH.build_histogram_batched_t(
        torch.from_numpy(bins), stats_t, torch.from_numpy(leaf),
        torch.from_numpy(slots), B, precision, impl=impl).numpy()
    assert got.shape == ref.shape == (len(slots), F, B, 3)
    assert not got[slots < 0].any()
    if gh is None:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        return
    # counts exact; g, h: f32 summation order, within 1e-6 of the slot's
    # sum of |stat| (test_torch_histogram.py's tolerance)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    for k, s in enumerate(slots):
        rows = leaf == s
        for j, v in enumerate(gh):
            tol = 1e-6 * max(float(np.abs(v[rows]).sum()), 1e-30)
            assert np.abs(got[k, :, :, j] - ref[k, :, :, j]).max() <= tol


# ---- 3. B2's twin against fused_hist_scan -----------------------------------

FUSED_B = 300


def _fused_wide_cases():
    """Two B = 300 cases: feature 1 (NaN-missing) has its rows in bins
    21, 280 and the NaN bin 299 only, so every threshold from 21 to 279
    splits them alike (a tie across the first 256-bin tile's end), and
    feature 2's rows sit in bins [257, 300), so its best threshold lies
    past bin 256."""
    out = []
    for c, prec in enumerate(("int8", "int16")):
        F, n, K = 6, 1024, 3
        rng = np.random.default_rng(40 + c)
        bins = rng.integers(0, FUSED_B, size=(F, n))
        bins[1] = rng.choice([21, 280, FUSED_B - 1], size=n)
        bins[2] = rng.integers(257, FUSED_B, size=n)
        case, kw = fused_case(30 + c, F, n, FUSED_B, K, prec, dead=(1,),
                              bins=bins)
        # every bin of both counts; feature 1 NaN-missing, 2 not missing
        case["meta_i"][1:3, 0] = FUSED_B
        case["meta_i"][1:3, 1] = [2, 0]
        out.append((prec, case, kw))
    return out


@pytest.fixture(scope="module")
def fused_ref(tmp_path_factory):
    cases = _fused_wide_cases()
    arrays = {f"{c}_{k}": case[k] for c, (_, case, _) in enumerate(cases)
              for k in FUSED_KEYS}
    spec = {"cases": [dict(precision=p, nb=2, B=FUSED_B, split_kw=kw)
                      for p, _, kw in cases]}
    return cases, run_jax_nofma("fused", arrays, spec,
                                tmp_path_factory.mktemp("fused_wide"))


@pytest.mark.parametrize("c", [0, 1], ids=["int8", "int16"])
def test_fused_twin_bitwise(fused_ref, c):
    cases, out = fused_ref
    prec, case, kw = cases[c]
    assert case["bins"].dtype == np.int32
    hist, rec = TF.fused_hist_scan(*fused_args(case, FUSED_B, prec),
                                   split_kw=kw)
    np.testing.assert_array_equal(hist.numpy(), out[f"{c}_hist"])
    ref = out[f"{c}_rec"]
    np.testing.assert_array_equal(rec.numpy().view(np.int32),
                                  ref.view(np.int32))
    # the children histogrammed fresh (the others subtract a parent that
    # carries noise in every bin): their rows are the case's bins
    C = ref.shape[0]
    fresh = case["ctx"][:C, 5] > 0
    gain, thr, dleft = (ref[fresh][..., i] for i in range(3))
    live = gain > 0
    # feature 2: the best threshold is past bin 256
    assert live[:, 2].any() and (thr[:, 2][live[:, 2]] > 256).all()
    # feature 1: the tie spans bins 21..279; +1 takes its first bin,
    # -1 its last
    assert live[:, 1].any()
    for t, d in zip(thr[:, 1][live[:, 1]], dleft[:, 1][live[:, 1]]):
        assert t == (279 if d > 0.5 else 21)


# ---- 4. B3's twin against partition_rows ------------------------------------

def test_partition_twin_bitwise_past_255():
    rng = np.random.default_rng(8)
    n, F, K, leaves = 1024, 5, 5, 8
    num_bin = rng.integers(300, 700, size=F).astype(np.int32)
    bins = np.stack([rng.integers(0, nb, size=n) for nb in num_bin]
                    ).astype(np.int32)
    missing = np.array([2, 1, 0, 2, 1], np.int32)
    default_bin = np.array([rng.integers(0, nb) for nb in num_bin], np.int32)
    feat = np.array([0, 1, 2, 3, 4], np.int32)
    thr = np.array([rng.integers(256, num_bin[f] - 1) for f in feat],
                   np.int32)
    c = dict(bins=bins, feat=feat,
             leaf=rng.integers(0, leaves, size=n).astype(np.int32),
             sel=rng.permutation(leaves)[:K].astype(np.int32),
             new_ids=(leaves + np.arange(K)).astype(np.int32), thr=thr,
             dleft=rng.random(K) < 0.5, mt=missing[feat],
             nbf=num_bin[feat], db=default_bin[feat],
             do_k=np.arange(K) < K - 1)
    block = 256
    ref = np.asarray(j_partition_rows(
        jnp.asarray(bins[feat]), jnp.asarray(c["leaf"]),
        jnp.asarray(c["sel"]), jnp.asarray(c["new_ids"]), jnp.asarray(thr),
        jnp.asarray(c["dleft"]), jnp.asarray(c["mt"]),
        jnp.asarray(c["nbf"]), jnp.asarray(c["db"]),
        jnp.asarray(c["do_k"]), n // block, block))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()}
    got = TF.partition_rows(t["bins"], t["feat"], t["leaf"], t["sel"],
                            t["new_ids"], t["thr"], t["dleft"], t["mt"],
                            t["nbf"], t["db"], t["do_k"]).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != c["leaf"]).any()


# ---- 5. models --------------------------------------------------------------

ROUNDS = 3
WIDE = {"num_leaves": 7, "max_bin": 511, "min_data_in_leaf": 10,
        "tpu_split_batch": 2, "tpu_block_rows": 512, "verbosity": -1}
# (precision, tpu_hist_impl, the impl the port resolves it to): the port's
# "auto" is "fused" (B2's twin), the JAX package's off its accelerator
# "xla", at the same 512-row blocks, which grow the same trees
REG_RUNS = [("int8", "auto", "fused"), ("int16", "auto", "fused"),
            ("int8", "pallas", "pallas"), ("int16", "pallas", "pallas")]


def _reg_data():
    X, _ = binary_data(n=1024, f=4, seed=9)
    Xn = np.nan_to_num(X)
    rng = np.random.default_rng(10)
    return X, Xn[:, 0] + 0.5 * Xn[:, 1] * Xn[:, 2] + 0.3 * rng.normal(
        size=len(X))


def _reg_params(precision, impl):
    return dict(WIDE, objective="regression", tpu_hist_precision=precision,
                tpu_quant_refit_leaves=False, tpu_hist_impl=impl)


@pytest.fixture(scope="module")
def jax_models(tmp_path_factory):
    X, y = _reg_data()
    runs = [dict(_reg_params(p, impl), label="reg")
            for p, impl, _ in REG_RUNS]
    return run_jax_nofma("train", {"X": X, "y_reg": y},
                         {"runs": runs, "rounds": ROUNDS,
                          "device_predict_iterations": [ROUNDS]},
                         tmp_path_factory.mktemp("train_wide"))


@pytest.fixture(scope="module")
def port_models():
    X, y = _reg_data()
    return [tlgb.train(dict(_reg_params(p, impl), device_type="cpu"),
                       tlgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                       keep_training_booster=True)
            for p, impl, _ in REG_RUNS]


@pytest.mark.parametrize("c", range(len(REG_RUNS)),
                         ids=[f"{p}-{impl}" for p, impl, _ in REG_RUNS])
def test_regression_model_text_byte_identical(jax_models, port_models, c):
    learner = port_models[c]._driver.learner
    assert learner.bins_t.dtype == torch.int32 and learner.num_bins > 256
    assert learner.params.hist_impl == REG_RUNS[c][2]
    assert _text(port_models[c].model_to_string()) \
        == _text(str(jax_models[f"{c}_text"]))


def test_models_cross_load(jax_models, port_models):
    X, _ = _reg_data()
    bt = port_models[0]
    bj = jlgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(bj.predict(X, raw_score=True),
                               bt.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    # the JAX model in the port predicts equal to the JAX package's own
    # device predict (f32 sums over trees in XLA's order)
    back = tlgb.Booster(model_str=str(jax_models["0_text"]),
                        params={"device_type": "cpu"})
    np.testing.assert_array_equal(back.predict(X, raw_score=True),
                                  jax_models[f"0_device_raw_{ROUNDS}"])


def test_binary_hilo_trees_match_jax():
    X, y = binary_data(n=2048, f=4, seed=11)
    p = dict(WIDE, objective="binary")
    # the port's "auto" is "pallas2" (kernel B1's twin here), the JAX
    # package's off its accelerator "xla": the JAX side runs its
    # perfeature kernel, in interpret mode
    bj = jlgb.train(dict(p, tpu_hist_impl="pallas2"),
                    jlgb.Dataset(X, label=y), ROUNDS)
    bt = tlgb.train(dict(p, device_type="cpu"), tlgb.Dataset(X, label=y),
                    ROUNDS, keep_training_booster=True)
    assert bt._driver.learner.params.hist_impl == "pallas2"
    assert bt._driver.learner.bins_t.dtype == torch.int32
    assert bt.num_trees() == ROUNDS         # materializes the lazy trees
    assert_trees_match(bj._driver.models, bt._driver.models)


# ---- 6. the plan and the auto rule ------------------------------------------

@pytest.mark.parametrize("B", [257, 511, 1024, 4096, 16384, 65536])
@pytest.mark.parametrize("K", [1, 25, 254])
@pytest.mark.parametrize("S", [3, 5])
def test_wide_plan_fits_and_tiles_cover(S, K, B):
    sms, smem_max, smem_sm = H100
    floats = S == 5
    for scan in ((False, True) if not floats else (False,)):
        p = TH.hist_plan(32, K, S, B, 1 << 20, sms, smem_max, smem_sm,
                         scan=scan, floats=floats, wide=True,
                         resident=h100_resident)
        per_sm = min(2048 // p.threads, smem_sm // (p.smem + 1024))
        assert per_sm in (1, 2)
        assert p.smem <= smem_max and per_sm * (p.smem + 1024) <= smem_sm
        # a portable cluster that tiles the grid, and no more clusters
        # than the card holds at once
        assert 1 <= p.cluster <= TH.MAX_CLUSTER
        assert p.grid % p.cluster == 0
        assert p.grid == p.cluster * h100_resident(p.threads, p.smem,
                                                   p.cluster)
        # each of the C blocks holds a tile's sums and the warps' 17-word
        # bins tiles, as a block alone did
        assert 4 * (p.bin_tile * S * (32 if floats else 33)
                    + p.threads * 17) <= p.smem
        # the tiles cover [0, B) once, each starting 16-byte aligned
        tiles = -(-B // p.bin_tile)
        starts = [t * p.bin_tile for t in range(tiles)]
        assert starts[-1] < B <= starts[-1] + p.bin_tile
        assert all(s * S % 4 == 0 for s in starts)
        # the entries are walked once per tile group: once while B fits
        # 8 tiles (max_bin 511 and 1023), and C is no larger than the
        # tiles need
        walks = TH.plan_walks(p, B)
        assert walks == -(-tiles // p.cluster) == -(-tiles // 8)
        assert p.cluster == -(-tiles // walks)
        if B <= 1024:
            assert walks == 1 and p.cluster == tiles
    with pytest.raises(ValueError):
        TH.hist_plan(32, K, S, B, 1000, *H100, floats=floats)
    # a wide plan needs the card's answer
    with pytest.raises(ValueError):
        TH.hist_plan(32, K, S, B, 1000, *H100, floats=floats, wide=True)


def _schedule_case(seed, K, m, F):
    """[K + 1] offsets of m grouped entries (a few slots empty)."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, m + 1, size=K - 1))
    if K > 2:
        cuts[K // 2] = cuts[K // 2 - 1]          # an empty slot
    return np.concatenate([[0], cuts, [m]])


@pytest.mark.parametrize("B", [257, 1023, 4096, 65536])
@pytest.mark.parametrize("K", [1, 25])
@pytest.mark.parametrize("m", [40, 1500], ids=["short", "long"])
def test_cluster_schedule_adds_each_entry_once_into_its_tile(B, K, m):
    """Phase C's items, shares and owners (the wide kernels' formulas):
    every (entry, feature) whose bin is below B is added exactly once,
    into the block that holds its bin's tile; the others nowhere.  m = 40
    entries is fewer than one warp of each of the C blocks takes."""
    F, floats = 40, True                        # two feature chunks
    p = TH.hist_plan(F, K, 5, B, 1 << 20, *H100, floats=floats, wide=True,
                     resident=h100_resident)
    offsets = _schedule_case(B + K, K, m, F)
    rng = np.random.default_rng(m)
    bins = rng.integers(0, B + 40, size=(m, F))  # some past num_bins
    bins[:, 3] = 0                               # a feature in one bin
    adds, tile, walked = TH.cluster_schedule(offsets, F, B, bins, p)
    live = bins < B
    np.testing.assert_array_equal(adds, live.astype(np.int64))
    np.testing.assert_array_equal(tile[live], bins[live] // p.bin_tile)
    assert (tile[~live] == -1).all()
    np.testing.assert_array_equal(walked, TH.plan_walks(p, B))
    if B <= 1023:
        assert (walked == 1).all()


def test_hist_plan_refuses_more_bins_than_the_wide_copy_holds():
    with pytest.raises(ValueError):
        TH.hist_plan(32, 25, 3, TH.MAX_WIDE_BINS + 1, 1000, *H100, wide=True)


@pytest.mark.parametrize("precision", ["hilo", "int8"])
@pytest.mark.parametrize("leaves,B", [(255, 1536), (255, 1537),
                                      (255, 1023), (255, 4000),
                                      (31, 3000), (255, 256)])
def test_auto_follows_jax_chunk_fits(precision, leaves, B):
    # the JAX learner's rule (learner.py:939-962), from its own budget
    from lightgbm_tpu.ops.grower import resolve_split_batch

    k = min(resolve_split_batch(0, leaves), leaves - 1)
    s = 5 if precision == "hilo" else 3
    ks_pad = -(-(k * s) // 128) * 128
    step = 32 if B <= 256 else 8
    fits = step * (-(-B // 8) * 8) * ks_pad * 4 \
        <= JH._PERFEATURE_OUT_BUDGET
    cfg = TConfig({"num_leaves": leaves, "tpu_hist_precision": precision})
    impl, block = TreeLearner._resolve_hist_impl(cfg, precision, B)
    want = ("fused" if precision == "int8" else "pallas2") if fits \
        else "xla"
    assert (impl, block) == (want, 8192 if fits else 16384)
