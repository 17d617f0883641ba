"""Custom objectives (`fobj`) through the sync step, lightgbm_tpu_torch
against lightgbm_tpu.

With fobj the objective is none: each iteration hands the train scores
to the host function, grows one tree from its gradients and fetches it
(GBDT._train_one_iter_sync), with the bagging mask drawn from numpy's
default_rng(bagging_seed) and the feature mask and the tree's key from
default_rng(feature_fraction_seed), as the JAX package draws them.

- int8 regression, leaf refit off, on the data of
  tests/test_torch_valid.py: the whole model text byte-identical to the
  JAX package's (run without FMA), with and without bagging and
  feature_fraction, and with a validation set the evals_result equal;
- gradients that allow no split stop training at once with the
  constant tree, as in the JAX package;
- hilo binary with logloss gradients given as fobj: the valid AUC curve
  within AUC_TOL of the JAX package's.
"""

import json
import re

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb

from .test_torch_util import fobj_l2, run_jax_nofma, train_valid_run
from .test_torch_valid import AUC_TOL, BASE, N_TRAIN, _data

FOBJ = dict(BASE, metric="l2")
RUNS = [
    dict(params=FOBJ, label="regression", n_train=N_TRAIN, rounds=5,
         fobj="l2", valid="none"),
    dict(params=dict(FOBJ, bagging_fraction=0.7, bagging_freq=2,
                     feature_fraction=0.6), label="regression",
         n_train=N_TRAIN, rounds=5, fobj="l2", valid="none"),
    dict(params=dict(FOBJ, pos_bagging_fraction=0.7,
                     neg_bagging_fraction=0.9, bagging_freq=1),
         label="binary", n_train=N_TRAIN, rounds=4, fobj="l2"),
    dict(params=FOBJ, label="regression", n_train=N_TRAIN, rounds=5,
         fobj="zero", valid="none"),
    dict(params=dict(BASE, objective="binary", metric="auc",
                     tpu_hist_precision="hilo", tpu_hist_impl="pallas2",
                     bagging_fraction=0.8, bagging_freq=1),
         label="binary", n_train=N_TRAIN, rounds=4, fobj="logloss"),
]


def _text(text):
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    X, ys = _data()
    jax = run_jax_nofma("train_valid",
                        {"X": X, **{"y_" + k: v for k, v in ys.items()}},
                        {"runs": RUNS}, tmp_path_factory.mktemp("fobj"))
    port = [train_valid_run(tlgb, X, ys[r["label"]],
                            dict(r, params=dict(r["params"],
                                                device_type="cpu")))
            for r in RUNS]
    return jax, port


@pytest.mark.parametrize("c", [0, 1, 2], ids=["plain", "bagged",
                                              "pos_neg_valid"])
def test_fobj_model_text_byte_identical(runs, c):
    jax, port = runs
    text = port[c]["text"]
    # objective=none: no objective line, and the trees carry no
    # boost-from-average bias
    assert "\nobjective=" not in text
    assert text.count("\nTree=") == RUNS[c]["rounds"]
    assert _text(text) == _text(str(jax[f"{c}_text"]))
    assert port[c]["evals"] == str(jax[f"{c}_evals"])


def test_fobj_stall_keeps_the_constant_tree(runs):
    jax, port = runs
    text = port[3]["text"]
    assert text.count("\nTree=") == 1 and "num_leaves=1" in text
    assert _text(text) == _text(str(jax["3_text"]))


def test_fobj_hilo_valid_auc_within_tolerance(runs):
    jax, port = runs
    got = json.loads(port[4]["evals"])["valid"]["auc"]
    ref = json.loads(str(jax["4_evals"]))["valid"]["auc"]
    assert len(got) == len(ref) == 4 and got[-1] > 0.8
    assert np.abs(np.subtract(got, ref)).max() <= AUC_TOL


def test_fobj_update_takes_the_sync_path():
    X, ys = _data()
    y = ys["regression"][:N_TRAIN]
    train = tlgb.Dataset(X[:N_TRAIN], label=y)
    b = tlgb.Booster(dict(FOBJ, device_type="cpu", objective="none"), train)
    assert b._driver.objective is None and b._driver._step is None
    with pytest.raises(ValueError, match="fobj"):
        # without fobj there are no gradients to train on
        b.update()
    assert b.update(fobj=fobj_l2) is False
    # the tree was fetched and its scores added at once: nothing pends
    assert not b._driver._pending and b.current_iteration() == 1
    raw = b._driver.current_score_for_fobj()
    np.testing.assert_allclose(raw[0], b.predict(X[:N_TRAIN],
                                                 raw_score=True),
                               rtol=0, atol=1e-6)
