"""The training callbacks of lightgbm_tpu_torch (its own copy of
lightgbm_tpu/callback.py) against the JAX package's, on one training.

The data and the int8 regression of tests/test_torch_valid.py (exact
gradients, integer histograms, the leaf refit off), so every value the
callbacks see is equal in the two packages: record_evaluation's curves,
log_evaluation's and early_stopping's printed text, the learning-rate
schedule of reset_parameter (a callable, and the engine's
learning_rates list) and the iteration the stop fires at.  The JAX
package runs in a process compiled without FMA
(tests/test_torch_util.py).
"""

import json
import re

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import callback

from .test_torch_util import run_jax_nofma, train_valid_run
from .test_torch_valid import N_TRAIN, OVERFIT, _data

RUNS = [
    # the four callbacks given by the caller
    dict(params=OVERFIT, label="regression", n_train=N_TRAIN, rounds=30,
         callbacks=["record", "log", "early_stopping", "reset_lr"]),
    # the engine's own: learning_rates, verbose_eval, evals_result and the
    # early-stopping alias in params
    dict(params=dict(OVERFIT, early_stopping_round=3), label="regression",
         n_train=N_TRAIN, rounds=12, verbose_eval=2,
         learning_rates=[0.5 - 0.02 * i for i in range(12)]),
]


def _text(text):
    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    X, ys = _data()
    jax = run_jax_nofma("train_valid", {"X": X, "y_regression":
                                        ys["regression"]},
                        {"runs": RUNS}, tmp_path_factory.mktemp("callback"))
    port = [train_valid_run(tlgb, X, ys["regression"],
                            dict(r, params=dict(r["params"],
                                                device_type="cpu")))
            for r in RUNS]
    return jax, port


@pytest.mark.parametrize("c", range(len(RUNS)), ids=["given", "engine"])
def test_record_evaluation_equal(runs, c):
    jax, port = runs
    evals = json.loads(port[c]["evals"])
    assert len(evals["valid"]["l2"]) > 3
    assert port[c]["evals"] == str(jax[f"{c}_evals"])


@pytest.mark.parametrize("c", range(len(RUNS)), ids=["given", "engine"])
def test_log_evaluation_and_early_stopping_text_equal(runs, c):
    jax, port = runs
    log = port[c]["log"]
    assert "Training until validation scores don't improve for 3 rounds" \
        in log
    assert "\n[2]\tvalid" in log and "\n[3]\tvalid" not in log
    assert log == str(jax[f"{c}_log"])


def test_early_stopping_fires_where_jax_does(runs):
    jax, port = runs
    got = port[0]
    assert "Early stopping, best iteration is:" in got["log"]
    assert 0 < got["best_iteration"] == int(jax["0_best_iteration"])
    assert got["best_score"] == str(jax["0_best_score"])


@pytest.mark.parametrize("c", range(len(RUNS)), ids=["given", "engine"])
def test_reset_parameter_schedule_gives_the_same_model(runs, c):
    jax, port = runs
    text = port[c]["full_text"]
    # the model text lists the last learning rate the schedule set
    assert "[learning_rate: 0.5]" not in text
    assert _text(text) == _text(str(jax[f"{c}_full_text"]))


def test_callback_contracts():
    assert tlgb.print_evaluation is tlgb.log_evaluation
    with pytest.raises(TypeError, match="dict"):
        callback.record_evaluation([])
    with pytest.raises(ValueError, match="stopping_rounds"):
        callback.early_stopping(0)
    es = callback.early_stopping(2, verbose=False)
    assert (es.order, es.before_iteration) == (30, False)
    rp = callback.reset_parameter(learning_rate=[0.1, 0.2])
    assert (rp.order, rp.before_iteration) == (10, True)
    # the early-stopping state survives a snapshot and restore
    env = callback.CallbackEnv(
        model=None, params={}, iteration=0, begin_iteration=0,
        end_iteration=10,
        evaluation_result_list=[("valid", "l2", 1.0, False)])
    es(env)
    again = callback.early_stopping(2, verbose=False)
    again.restore_state(json.loads(json.dumps(es.snapshot_state())))
    assert again.snapshot_state() == es.snapshot_state()
    X, ys = _data()
    with pytest.raises(ValueError, match="learning_rates"):
        tlgb.train(dict(OVERFIT, device_type="cpu"),
                   tlgb.Dataset(X[:512], label=ys["regression"][:512]), 2,
                   learning_rates=0.1)
    with pytest.raises(ValueError, match="length of list"):
        tlgb.train(dict(OVERFIT, device_type="cpu"),
                   tlgb.Dataset(X[:512], label=ys["regression"][:512]), 2,
                   learning_rates=[0.1])
    np.testing.assert_array_equal(callback.EarlyStopException(3, []).
                                  best_iteration, 3)
