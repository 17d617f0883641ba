"""Guards of lightgbm_tpu_torch: what it imports, where it runs, what it
refuses, and the two ways a model carries over from lightgbm_tpu."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.predict import pack_trees as j_pack_trees
from lightgbm_tpu_torch.convert import booster_from_arrays

from .test_torch_util import binary_data

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = {"device_type": "cpu", "verbosity": -1}
SMALL = {"objective": "binary", "num_leaves": 7, "max_bin": 15,
         "min_data_in_leaf": 10, "tpu_pack_bins": False}


def _port_sources():
    files = sorted((ROOT / "lightgbm_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    top = module.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "lightgbm_tpu"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_training_without_cuda_raises_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    X, y = binary_data(n=300, f=3)
    for extra in ({}, {"device_type": "gpu"}, {"device": "cuda"},
                  {"device_type": "tpu"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            tlgb.train(dict(SMALL, **extra), tlgb.Dataset(X, label=y),
                       num_boost_round=1)
    # the alias `device` selects the CPU like device_type does
    b = tlgb.train(dict(SMALL, device="cpu"), tlgb.Dataset(X, label=y),
                   num_boost_round=1)
    assert b.num_trees() == 1


OUT_OF_SLICE = [
    {"boosting": "dart"}, {"boosting": "goss"},
    {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
    {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"pos_bagging_fraction": 0.5, "bagging_freq": 1},
    {"feature_fraction": 0.5}, {"feature_fraction_bynode": 0.5},
    {"monotone_constraints": [1, 0, 0]},
    {"cegb_penalty_split": 0.1},
    {"cegb_penalty_feature_coupled": [1.0, 0.0, 0.0]},
    {"forcedsplits_filename": "splits.json"},
    {"tpu_sparse_threshold": 0.5, "enable_bundle": False},
    {"tpu_stream_mode": "streamed"},
    {"deterministic": True},
    {"tpu_hist_precision": "int8"}, {"tpu_hist_precision": "int16"},
    {"tpu_hist_precision": "f64"},
    {"tpu_hist_impl": "fused"}, {"tpu_hist_impl": "pallas"},
    {"tpu_partition_impl": "gather"},
    {"tree_learner": "data", "num_machines": 2},
    {"objective": "multiclass", "num_class": 3},
    {"objective": "lambdarank"},
    {"categorical_feature": "0"},
    {"tpu_pack_bins": True},
]


@pytest.mark.parametrize("extra", OUT_OF_SLICE, ids=lambda d: ",".join(d))
def test_out_of_slice_parameters_raise(extra):
    X, y = binary_data(n=300, f=3, seed=1)
    if extra.get("objective") == "multiclass":
        y = np.arange(300) % 3
    params = dict(SMALL, **CPU, **extra)
    name = next(iter(extra))
    with pytest.raises(NotImplementedError, match=name.split("_")[0]):
        tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=1)


def test_more_than_256_bins_raise():
    X, y = binary_data(n=3000, f=2, seed=2)
    params = dict(SMALL, **CPU, max_bin=1000, min_data_in_bin=1)
    with pytest.raises(NotImplementedError, match="max_bin"):
        tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=1)


def test_sparse_features_refuse_bundling():
    # EFB is not ported: data the JAX package bundles is refused by name;
    # enable_bundle=false trains
    rng = np.random.default_rng(4)
    X = np.zeros((400, 5))
    rows = np.flatnonzero(rng.random(400) < 0.4)
    # 0/1 features, at most one of them nonzero per row: no conflicts,
    # so they fit one column beside the dense feature's 15 bins
    X[rows, rng.integers(0, 4, rows.size)] = 1.0
    X[:, 4] = rng.normal(size=400)
    y = (rng.random(400) < 0.5).astype(float)
    bj = jlgb.train(dict(SMALL, verbosity=-1), jlgb.Dataset(X, label=y), 1,
                    keep_training_booster=True)
    assert bj._driver.learner.bundle_plan is not None
    with pytest.raises(NotImplementedError, match="enable_bundle"):
        tlgb.train(dict(SMALL, **CPU), tlgb.Dataset(X, label=y), 1)
    b = tlgb.train(dict(SMALL, **CPU, enable_bundle=False),
                   tlgb.Dataset(X, label=y), 1)
    assert b.num_trees() == 1


@pytest.fixture(scope="module")
def jax_booster():
    X, y = binary_data(n=1500, f=5, seed=3)
    b = jlgb.train(dict(SMALL, verbosity=-1), jlgb.Dataset(X, label=y),
                   num_boost_round=4, keep_training_booster=True)
    return X, b


def test_convert_packed_tables_predict_like_jax(jax_booster):
    X, bj = jax_booster
    drv = bj._driver
    drv._materialize()
    td = drv.learner.td
    tables, _ = j_pack_trees(drv.models)
    used = td.used_feature_idx
    ms = [td.mappers[c] for c in used]
    bt = booster_from_arrays(
        tables, [m.bin_upper_bound for m in ms], [m.num_bin for m in ms],
        [m.default_bin for m in ms], [int(m.missing_type) for m in ms],
        used_feature_idx=used, num_total_features=X.shape[1],
        objective=drv.objective.to_model_string(), params=CPU)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)


def test_port_model_text_loads_in_the_jax_package():
    X, y = binary_data(n=1500, f=5, seed=5)
    bt = tlgb.train(dict(SMALL, **CPU), tlgb.Dataset(X, label=y),
                    num_boost_round=4)
    bj = jlgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(bj.predict(X), bt.predict(X), rtol=0,
                               atol=1e-6)


def test_jax_model_text_loads_in_the_port(jax_booster):
    X, bj = jax_booster
    bt = tlgb.Booster(model_str=bj.model_to_string(), params=CPU)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-6)
