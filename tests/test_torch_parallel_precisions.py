"""The sharded tree learners of lightgbm_tpu_torch against lightgbm_tpu at
the other precisions: int16 model text byte-identical to the JAX
package's, a bagged int8 data run equal to it and to the serial text,
and the float runs (hilo, and int8 with the leaf refit on) held with
`assert_trees_match` and AUC within 1e-4.  The int8 grid, the contract
and the shared helpers are in tests/test_torch_parallel.py; these cases
run in a JAX process of their own, so that the two files' JAX work can
go side by side.
"""

import pytest

from .test_torch_parallel import (HILO, INT8, INT16, _learner,
                                  check_trees_match, grid_cases, run_grid)

# name -> (data, label, params, checks), as GRID of test_torch_parallel
CASES = {
    "data4_int16": ("a", "reg", dict(INT16, **_learner("data", 4)),
                    ("jax", "serial")),
    "voting2_topk5_int16": ("a", "reg", dict(INT16, **_learner(
        "voting", 2, top_k=5)), ("jax",)),
    "feature2_int16": ("a", "reg", dict(INT16, **_learner("feature", 2)),
                       ("jax", "serial")),
    "data_feature4_hosts2_int16": ("a", "reg", dict(INT16, **_learner(
        "data_feature", 4, 2)), ("jax", "serial")),
    # bagging masks key on the global row
    "data2_bagged_int8": ("a", "reg", dict(INT8, bagging_fraction=0.8,
                                           bagging_freq=1,
                                           **_learner("data", 2)),
                          ("jax", "serial")),
    "data2_refit_int8": ("a", "reg", dict(INT8, tpu_quant_refit_leaves=True,
                                          **_learner("data", 2)),
                         ("trees",)),
    "data2_hilo": ("nan", "bin", dict(HILO, **_learner("data", 2)),
                   ("trees",)),
    "voting2_hilo": ("nan", "bin", dict(HILO, **_learner("voting", 2)),
                     ("trees",)),
    "feature2_hilo": ("nan", "bin", dict(HILO, **_learner("feature", 2)),
                      ("trees",)),
    "data_feature4_hilo": ("nan", "bin", dict(HILO, **_learner(
        "data_feature", 4)), ("trees",)),
}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return run_grid(CASES, tmp_path_factory)


@pytest.mark.parametrize("name", grid_cases(CASES, "jax"))
def test_text_equals_jax(grid, name):
    port, jax, _ = grid
    assert port[name]["text"] == str(jax[name]["text"])


@pytest.mark.parametrize("name", grid_cases(CASES, "serial"))
def test_text_equals_serial(grid, name):
    port, _, _ = grid
    assert port[name]["text"] == port[name]["serial"]


@pytest.mark.parametrize("name", grid_cases(CASES, "trees"))
def test_float_trees_match_jax(grid, name):
    check_trees_match(grid, CASES, name)
