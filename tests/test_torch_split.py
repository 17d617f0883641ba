"""lightgbm_tpu_torch split search against lightgbm_tpu's, on the same
f32 histograms (made with numpy from fixed seeds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.ops import split as TS

KW = dict(l1=0.0, l2=0.0, max_delta_step=0.0, min_data_in_leaf=20.0,
          min_sum_hessian=1e-3, min_gain_to_split=0.0)


def _leaf_case(seed, n=3000, F=7, B=33):
    """One leaf's [F, B, 3] histogram from rows, and the per-feature
    meta: NaN-missing, zero-missing and plain features, a 2-bin NaN
    feature, a masked feature and a penalized one."""
    rng = np.random.default_rng(seed)
    num_bin = rng.integers(8, B + 1, size=F).astype(np.int32)
    num_bin[3] = 2
    missing = np.array([2, 1, 0, 2, 1, 0, 2][:F], np.int32)
    default_bin = np.array([rng.integers(0, nb) for nb in num_bin], np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = (np.abs(rng.normal(size=n)) * 0.2 + 0.05).astype(np.float32)
    hist = np.zeros((F, B, 3), np.float64)
    for f in range(F):
        b = rng.integers(0, num_bin[f], size=n)
        np.add.at(hist[f, :, 0], b, g)
        np.add.at(hist[f, :, 1], b, h)
        np.add.at(hist[f, :, 2], b, 1.0)
    meta = dict(num_bin=num_bin, missing_type=missing,
                default_bin=default_bin,
                monotone=np.zeros(F, np.int32),
                penalty=np.ones(F, np.float32),
                feature_mask=np.ones(F, np.float32))
    meta["penalty"][5] = 0.5
    meta["feature_mask"][4] = 0.0
    sums = (np.float32(g.sum()), np.float32(h.sum()), np.float32(n))
    return hist.astype(np.float32), meta, sums


def _jax_pf(hist, meta, sums, **extra):
    m = {k: jnp.asarray(v) for k, v in meta.items()}
    return JS.per_feature_best_split(
        jnp.asarray(hist), *[jnp.float32(s) for s in sums], m["num_bin"],
        m["missing_type"], m["default_bin"], m["monotone"], m["penalty"],
        m["feature_mask"], **KW, **extra)


def _torch_pf(hist, meta, sums, **extra):
    m = {k: torch.from_numpy(v) for k, v in meta.items()}
    return TS.per_feature_best_split(
        torch.from_numpy(hist), *[torch.tensor(s) for s in sums],
        m["num_bin"], m["missing_type"], m["default_bin"], m["monotone"],
        m["penalty"], m["feature_mask"], **KW, **extra)


def _assert_pf_equal(pt, pj):
    gain_j = np.asarray(pj.gain)
    np.testing.assert_array_equal(pt.threshold.numpy(),
                                  np.asarray(pj.threshold))
    np.testing.assert_array_equal(pt.default_left.numpy(),
                                  np.asarray(pj.default_left))
    np.testing.assert_allclose(pt.gain.numpy(), gain_j, rtol=1e-6)
    for a, b in ((pt.left_sum_g, pj.left_sum_g), (pt.left_sum_h, pj.left_sum_h),
                 (pt.left_count, pj.left_count)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_per_feature_best_split_matches(seed):
    hist, meta, sums = _leaf_case(seed)
    pj = _jax_pf(hist, meta, sums)
    pt = _torch_pf(hist, meta, sums)
    _assert_pf_equal(pt, pj)
    # the winning feature and threshold agree
    bj = int(np.argmax(np.asarray(pj.gain)))
    bt = int(torch.argmax(pt.gain))
    assert bt == bj
    assert int(pt.threshold[bt]) == int(np.asarray(pj.threshold)[bj])
    # finalize_split on the winner
    rj = JS.finalize_split(pj, jnp.int32(bj), jnp.float32(sums[0]),
                           jnp.float32(sums[1]), l1=0.0, l2=0.0,
                           max_delta_step=0.0)
    rt = TS.finalize_split(pt, torch.tensor(bt, dtype=torch.int32),
                           torch.tensor(sums[0]), torch.tensor(sums[1]),
                           l1=0.0, l2=0.0, max_delta_step=0.0)
    for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                 "left_output", "right_output"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)), rtol=1e-6,
                                   err_msg=name)
    assert bool(rt.default_left) == bool(rj.default_left)


def test_regularized_and_constrained_search_matches():
    hist, meta, sums = _leaf_case(11)
    meta["monotone"] = np.array([1, -1, 0, 0, 1, 0, -1], np.int32)
    kw = dict(KW, l1=0.5, l2=2.0, max_delta_step=0.8, min_gain_to_split=0.1)
    m = {k: jnp.asarray(v) for k, v in meta.items()}
    pj = JS.per_feature_best_split(
        jnp.asarray(hist), *[jnp.float32(s) for s in sums], m["num_bin"],
        m["missing_type"], m["default_bin"], m["monotone"], m["penalty"],
        m["feature_mask"], min_constraint=-0.3, max_constraint=0.4, **kw)
    mt = {k: torch.from_numpy(v) for k, v in meta.items()}
    pt = TS.per_feature_best_split(
        torch.from_numpy(hist), *[torch.tensor(s) for s in sums],
        mt["num_bin"], mt["missing_type"], mt["default_bin"],
        mt["monotone"], mt["penalty"], mt["feature_mask"],
        min_constraint=-0.3, max_constraint=0.4, **kw)
    _assert_pf_equal(pt, pj)


def test_batched_children_match_one_by_one():
    # the grower searches 2K children at once over a leading batch axis
    cases = [_leaf_case(s) for s in (20, 21, 22)]
    meta = cases[0][1]
    hist = np.stack([c[0] for c in cases])
    sums = [np.array([c[2][i] for c in cases], np.float32) for i in range(3)]
    pt = _torch_pf(hist, meta, sums)
    for i, (h, _, s) in enumerate(cases):
        one = _torch_pf(h, meta, s)
        np.testing.assert_array_equal(pt.gain[i].numpy(), one.gain.numpy())
        np.testing.assert_array_equal(pt.threshold[i].numpy(),
                                      one.threshold.numpy())


def test_numeric_go_left_matches():
    rng = np.random.default_rng(5)
    col = rng.integers(0, 12, size=500).astype(np.int32)
    for mt in (0, 1, 2):
        for dleft in (False, True):
            args = (col, np.int32(mt), np.int32(12), np.int32(4),
                    np.int32(6), np.bool_(dleft))
            ref = np.asarray(JS.numeric_go_left(
                *[jnp.asarray(a) for a in args]))
            got = TS.numeric_go_left(
                *[torch.as_tensor(a) for a in args]).numpy()
            np.testing.assert_array_equal(got, ref)


def test_argbest_tie_break_matches():
    gain = np.array([1.0, 3.0, 3.0, 2.0, 3.0], np.float32)
    feat = np.array([4, 2, 2, 0, 7], np.int32)
    thr = np.array([1, 9, 5, 0, 2], np.int32)
    ref = int(JS.argbest(jnp.asarray(gain), jnp.asarray(feat),
                         jnp.asarray(thr)))
    got = int(TS.argbest(torch.from_numpy(gain), torch.from_numpy(feat),
                         torch.from_numpy(thr)))
    assert got == ref == 2


def test_pf_records_round_trip():
    hist, meta, sums = _leaf_case(9)
    pt = _torch_pf(hist, meta, sums)
    rec = TS.pack_pf_records(pt)
    ref = np.asarray(JS.pack_pf_records(_jax_pf(hist, meta, sums)))
    assert rec.shape == ref.shape == (hist.shape[0], TS.PF_RECORD_WIDTH)
    np.testing.assert_array_equal(rec[:, 1:3].numpy(), ref[:, 1:3])
    np.testing.assert_allclose(rec.numpy(), ref, rtol=1e-6, atol=1e-5)
    back = TS.unpack_pf_records(rec)
    for a, b in zip(back, pt):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
