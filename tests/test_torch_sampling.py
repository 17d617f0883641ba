"""Bagging and feature_fraction in the train step, lightgbm_tpu_torch
against lightgbm_tpu.

The fused step samples as the JAX step does (learner.py:1116-1197): a
row is kept when the hashed uniform of its global row index under the
bagging key (split off at each refresh, every bagging_freq iterations)
falls below the fraction, or below pos/neg_bagging_fraction by its
label; ceil(F * feature_fraction) features are taken from
`permutation` of the key split off each tree.  The kernels then see
rows with zero stats and masked features.

- int8 and int16 regression with the leaf refit off, on the data of
  tests/test_torch_slice_quant.py: the whole model text byte-identical
  to the JAX package's (run without FMA, tests/test_torch_util.py), for
  bagging_fraction at bagging_freq 1 and 3, pos/neg fractions on binary
  labels, feature_fraction, all of them together, and once on 4-bit
  packed bins; the threefry and bagging keys end where the JAX ones do;
- hilo binary (f32 histogram sums in another order), bagged and
  feature-masked: the trees agree as tests/test_torch_slice.py's do.
"""

import re

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import grower as TG

from .test_torch_util import assert_trees_match, binary_data, run_jax_nofma
from .test_torch_valid import BASE, _data

ROUNDS = 5
BAG = {"bagging_fraction": 0.7, "bagging_freq": 1}
CASES = {
    "bagging_freq1": dict(BASE, **BAG),
    "bagging_freq3": dict(BASE, bagging_fraction=0.6, bagging_freq=3),
    "pos_neg_int16": dict(BASE, tpu_hist_precision="int16",
                          pos_bagging_fraction=0.6,
                          neg_bagging_fraction=0.8, bagging_freq=1),
    "feature_fraction": dict(BASE, feature_fraction=0.6),
    "all_int16": dict(BASE, tpu_hist_precision="int16", bagging_fraction=0.7,
                      bagging_freq=2, feature_fraction=0.7),
    # max_bin=15: the bins 4-bit packed, read by B1's packed variant
    "packed": dict(BASE, max_bin=15, tpu_hist_impl="pallas2",
                   feature_fraction=0.6, **BAG),
}
# pos/neg fractions draw by the label's sign: binary labels, regressed
LABELS = {"pos_neg_int16": "binary"}


def _text(text):
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    X, ys = _data()
    runs = [dict(p, label=LABELS.get(name, "regression"))
            for name, p in CASES.items()]
    return run_jax_nofma("train", {"X": X, **{"y_" + k: v
                                              for k, v in ys.items()}},
                         {"runs": runs, "rounds": ROUNDS},
                         tmp_path_factory.mktemp("sampling"))


@pytest.mark.parametrize("c,name", list(enumerate(CASES)),
                         ids=list(CASES))
def test_sampled_model_text_byte_identical(jax_ref, c, name):
    X, ys = _data()
    p = dict(CASES[name], device_type="cpu")
    b = tlgb.train(p, tlgb.Dataset(X, label=ys[LABELS.get(name,
                                                          "regression")],
                                   params={"max_bin": p["max_bin"]}),
                   num_boost_round=ROUNDS, keep_training_booster=True)
    learner = b._driver.learner
    assert learner.packed_bins == (name == "packed")
    assert not learner.refits_leaves
    assert b._driver._bag_cfg is not None or name == "feature_fraction"
    assert _text(b.model_to_string()) == _text(str(jax_ref[f"{c}_text"]))
    np.testing.assert_array_equal(b._driver._key, jax_ref[f"{c}_key"])
    np.testing.assert_array_equal(b._driver._bag_key,
                                  jax_ref[f"{c}_bag_key"])


def test_sampling_masks_rows_and_features(monkeypatch):
    # the masks the step hands the grower: the bagged share of the rows
    # and exactly ceil(F * fraction) features, padding always masked
    X, ys = _data()
    p = dict(CASES["all_int16"], device_type="cpu")
    b = tlgb.Booster(p, tlgb.Dataset(X, label=ys["regression"]))
    learner = b._driver.learner
    masks = []
    grow = TG.grow

    def spy(params, bins_t, g, h, mask, fmask, meta, key):
        masks.append((mask.clone(), fmask.clone()))
        return grow(params, bins_t, g, h, mask, fmask, meta, key)

    monkeypatch.setattr(TG, "grow", spy)
    for _ in range(4):
        b.update()
    n, F = learner.n, learner.num_features
    for mask, fmask in masks:
        assert not mask[n:].any() and not fmask[F:].any()
        assert 0.65 < float(mask[:n].mean()) < 0.75
        assert int(fmask.sum()) == int(np.ceil(F * 0.7))
    # bagging_freq=2: the rows refresh every other iteration, the
    # features every tree
    assert masks[0][0].equal(masks[1][0])
    assert not masks[1][0].equal(masks[2][0])
    assert not all(m[1].equal(masks[0][1]) for m in masks[1:])


def test_hilo_bagged_trees_agree():
    X, y = binary_data(n=2000, f=6, seed=0)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 31,
         "min_data_in_leaf": 20, "tpu_split_batch": 4,
         "tpu_hist_impl": "pallas2", "verbosity": -1,
         "bagging_fraction": 0.8, "bagging_freq": 1,
         "feature_fraction": 0.8}
    bj = jlgb.train(dict(p), jlgb.Dataset(X, label=y), ROUNDS,
                    keep_training_booster=True)
    bt = tlgb.train(dict(p, device_type="cpu"), tlgb.Dataset(X, label=y),
                    ROUNDS, keep_training_booster=True)
    bj._driver._materialize()
    bt._driver._materialize()
    assert_trees_match(bj._driver.models, bt._driver.models)
