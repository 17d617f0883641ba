"""The Booster surface and model I/O of lightgbm_tpu_torch against
lightgbm_tpu, and pandas frames.

int8 regression with the leaf refit off (exact gradients, integer
histograms) on 2,000 rows x 6 features with NaNs, 63 bins, 15 leaves,
8 iterations, `tpu_hist_impl=xla` on both sides; the JAX package trains
in one process compiled without FMA (job "boosting", kinds
"booster_io" and "zoo" of tests/test_torch_util.py), the port on the
CPU, both through the same functions.

- `save_model` files, `dump_model` JSON, `feature_importance` (split and
  gain), `trees_to_dataframe` and the text after `shuffle_models` equal
  the JAX package's;
- a model saved by either package loads in the other and predicts equal
  raw scores (the JAX side on its device predict);
- pickles, copies and deep copies predict alike, with their attributes;
  `model_from_string`, `get_leaf_output`, `get_split_value_histogram`,
  `feature_name`, `num_feature`, `num_model_per_iteration`;
- a multiclass forest carried over as arrays (`booster_from_arrays`,
  k from the objective's num_class) predicts as the JAX package does;
- a numeric DataFrame trains to the JAX package's text (its column names
  as feature names, `pandas_categorical:[]`) and predicts as its array;
  a category column trains and writes its table, object columns are
  refused as the JAX package refuses them;
- the methods that wait on later slices raise by name; `refit` refits
  as the JAX package's; `save_checkpoint` and `resume_from_checkpoint`
  round-trip a bundle through the other package.
"""

import copy
import io
import json
import pickle

import numpy as np
import pandas as pd
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.predict import pack_trees as j_pack_trees
from lightgbm_tpu_torch.convert import booster_from_arrays

from .test_torch_util import booster_io_run, start_jax_nofma, zoo_run

N = 2000
CPU = {"device_type": "cpu"}
PARAMS = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 5, "verbosity": -1, "tpu_block_rows": 512,
          "tpu_hist_impl": "xla", "tpu_hist_precision": "int8",
          "tpu_quant_refit_leaves": False}
COLUMNS = ["age", "income", "x2", "score", "d", "e"]


def _data():
    rng = np.random.default_rng(23)
    X = rng.normal(size=(N, 6))
    X[rng.random(X.shape) < 0.03] = np.nan
    Xn = np.nan_to_num(X)
    y = Xn[:, 0] - 0.7 * Xn[:, 3] * Xn[:, 1] + 0.3 * rng.normal(size=N)
    return X, y


def _norm(text):
    import re

    return re.sub(r"^\[device_type: [^\]]*\]$", "[device_type: -]", text,
                  flags=re.M)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's results, the JAX package's), the port's model loaded
    and predicted in the JAX process and the JAX model in the port."""
    X, y = _data()
    tmp = tmp_path_factory.mktemp("booster_io")
    port = booster_io_run(tlgb, X, y, {"params": dict(PARAMS, **CPU),
                                       "rounds": 8}, str(tmp))
    port_text = tlgb.train(dict(PARAMS, **CPU), tlgb.Dataset(X, label=y),
                           8).model_to_string()
    frame = zoo_run(tlgb, X, y, {"params": dict(PARAMS, **CPU),
                                 "rounds": 4, "frame": COLUMNS})
    runs = [{"kind": "booster_io", "params": PARAMS, "rounds": 8,
             "load": port_text},
            {"kind": "zoo", "params": PARAMS, "rounds": 4,
             "frame": COLUMNS}]
    got = start_jax_nofma("boosting", {"X": X, "y_regression": y},
                          {"runs": runs}, tmp)()
    ref = {k[2:]: v for k, v in got.items() if k.startswith("0_")}
    ref["frame"] = {k[2:]: v for k, v in got.items() if k.startswith("1_")}
    port["frame_run"] = frame
    port["text"] = port_text
    return port, ref


def test_saved_file_equal(both):
    port, ref = both
    assert _norm(port["saved"]) == _norm(str(ref["saved"]))
    assert port["saved"].endswith("\npandas_categorical:null\n")


def test_dump_model_equal(both):
    port, ref = both
    got, want = json.loads(port["dump"]), json.loads(str(ref["dump"]))
    assert got == want
    assert len(got["tree_info"]) == 8


@pytest.mark.parametrize("kind", ["split", "gain"])
def test_feature_importance_equal(both, kind):
    port, ref = both
    assert port[kind].dtype == ref[kind].dtype == np.float64
    np.testing.assert_array_equal(port[kind], ref[kind])
    assert port[kind].sum() > 0


def test_trees_to_dataframe_equal(both):
    port, ref = both
    got = pd.read_json(io.StringIO(port["trees_frame"]))
    want = pd.read_json(io.StringIO(str(ref["trees_frame"])))
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 8 * (2 * 15 - 1)


def test_shuffle_models_equal(both):
    port, ref = both
    assert _norm(port["shuffled"]) == _norm(str(ref["shuffled"]))


def test_jax_model_loads_in_the_port(both, tmp_path):
    X, _ = _data()
    _, ref = both
    path = tmp_path / "jax_model.txt"
    path.write_text(str(ref["saved"]))
    bt = tlgb.Booster(model_file=str(path), params=CPU)
    np.testing.assert_array_equal(bt.predict(X, raw_score=True), ref["raw"])


def test_port_model_loads_in_the_jax_package(both):
    port, ref = both
    np.testing.assert_array_equal(ref["loaded_raw"], port["raw"])


@pytest.mark.parametrize("how", ["pickle", "copy", "deepcopy"])
def test_copies_predict_alike(both, how):
    X, _ = _data()
    port, _ = both
    b = tlgb.Booster(model_str=port["text"], params=CPU)
    b.set_attr(note="kept")
    b.best_iteration = 6
    other = {"pickle": lambda o: pickle.loads(pickle.dumps(o)),
             "copy": copy.copy, "deepcopy": copy.deepcopy}[how](b)
    assert other is not b and other._driver is not b._driver
    assert other.attr("note") == "kept" and other.best_iteration == 6
    np.testing.assert_array_equal(other.predict(X), b.predict(X))
    assert other.model_to_string() == b.model_to_string()


def test_introspection(both):
    X, _ = _data()
    port, ref = both
    b = tlgb.Booster(model_str=port["text"], params=CPU)
    bj = jlgb.Booster(model_str=str(ref["saved"]))
    assert b.feature_name() == bj.feature_name() == [
        f"Column_{i}" for i in range(6)]
    assert b.num_feature() == 6 and b.num_model_per_iteration() == 1
    assert b.get_leaf_output(3, 5) == bj.get_leaf_output(3, 5)
    hist_t, edges_t = b.get_split_value_histogram(0, bins=5)
    hist_j, edges_j = bj.get_split_value_histogram(0, bins=5)
    np.testing.assert_array_equal(hist_t, hist_j)
    np.testing.assert_array_equal(edges_t, edges_j)
    pd.testing.assert_frame_equal(
        b.get_split_value_histogram("Column_0", xgboost_style=True),
        bj.get_split_value_histogram("Column_0", xgboost_style=True))
    b.set_attr(a="1", b="2").set_attr(a=None)
    assert (b.attr("a"), b.attr("b")) == (None, "2")
    with pytest.raises(ValueError):
        b.set_attr(c=3)
    empty = tlgb.Booster(model_str=port["text"], params=CPU)
    empty.model_from_string(str(ref["saved"]))
    np.testing.assert_array_equal(empty.predict(X, raw_score=True),
                                  ref["raw"])


def test_multiclass_arrays_predict_like_jax():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(900, 4))
    y = np.digitize(X[:, 0] + 0.5 * rng.normal(size=900), [-0.5, 0.5])
    params = dict(PARAMS, objective="multiclass", num_class=3,
                  num_leaves=7, tpu_hist_precision="hilo")
    bj = jlgb.train(params, jlgb.Dataset(X, label=y), 6,
                    keep_training_booster=True)
    drv = bj._driver
    drv._materialize()
    td = drv.learner.td
    tables, _ = j_pack_trees(drv.models)
    ms = [td.mappers[c] for c in td.used_feature_idx]
    bt = booster_from_arrays(
        tables, [m.bin_upper_bound for m in ms], [m.num_bin for m in ms],
        [m.default_bin for m in ms], [int(m.missing_type) for m in ms],
        used_feature_idx=td.used_feature_idx, num_total_features=4,
        objective=drv.objective.to_model_string(), params=CPU)
    want = bj.predict(X, raw_score=True, tpu_predict_device="true")
    got = bt.predict(X, raw_score=True)
    assert got.shape == want.shape == (900, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(bt.predict(X), bj.predict(
        X, tpu_predict_device="true"), rtol=0, atol=1e-7)


def test_numeric_frame_text_equal(both):
    port, ref = both
    got, want = port["frame_run"]["text"], str(ref["frame"]["text"])
    assert _norm(got) == _norm(want)
    assert "\nfeature_names=age income x2 score d e\n" in got
    assert got.endswith("\npandas_categorical:[]\n")
    np.testing.assert_array_equal(port["frame_run"]["raw"],
                                  ref["frame"]["raw"])


def test_frame_predicts_as_its_array():
    X, y = _data()
    df = pd.DataFrame(X, columns=["a", "b", "c", "d", "e", "f"])
    b = tlgb.train(dict(PARAMS, **CPU), tlgb.Dataset(df, label=y), 3)
    assert b.feature_name() == list(df.columns)
    np.testing.assert_array_equal(b.predict(df), b.predict(X))


def test_category_and_object_columns_refused():
    """Object columns are refused as the JAX package refuses them; a
    category column trains (as a categorical feature) and writes its
    category table as the model's pandas_categorical line."""
    X, y = _data()
    df = pd.DataFrame(X[:, :3], columns=["a", "b", "c"])
    cat = df.assign(c=pd.Categorical(np.arange(N) % 4))
    b = tlgb.train(dict(PARAMS, **CPU), tlgb.Dataset(cat, label=y), 1)
    assert b.pandas_categorical == [[0, 1, 2, 3]]
    assert b.model_to_string().endswith(
        "\npandas_categorical:[[0, 1, 2, 3]]\n")
    obj = df.assign(c=np.where(np.arange(N) % 2, "x", "y"))
    with pytest.raises(ValueError, match="non-numeric"):
        tlgb.train(dict(PARAMS, **CPU), tlgb.Dataset(obj, label=y), 1)


@pytest.mark.parametrize("method,args", [
    ("refit", ()), ("save_checkpoint", ("ckpt",)),
    ("resume_from_checkpoint", ("ckpt",)), ("set_network", ("a,b",)),
    ("free_network", ())])
def test_unported_methods_raise_by_name(both, method, args, tmp_path):
    """The network methods, once refused, record and forget the network
    params as the JAX package's do (a list under num_machines=1 joins no
    group); refit, once refused, refits as the JAX package's refit
    (regression:
    the same text, leaf values bit for bit); the checkpoint methods, once
    refused, round-trip: a bundle one package saves, the other resumes
    to the same trees."""
    port, _ = both
    b = tlgb.Booster(model_str=port["text"], params=CPU)
    if method in ("save_checkpoint", "resume_from_checkpoint"):
        X, y = _data()
        pkgs = [(tlgb, dict(PARAMS, **CPU)), (jlgb, dict(PARAMS))]
        if method == "resume_from_checkpoint":
            pkgs.reverse()
        (src, ps), (dst, pd_) = pkgs
        saver = src.Booster(params=ps, train_set=src.Dataset(X, label=y))
        saver.update()
        saver.update()
        path = saver.save_checkpoint(str(tmp_path / args[0]))
        assert path.endswith("ckpt-00000002")
        fresh = dst.Booster(params=pd_, train_set=dst.Dataset(X, label=y))
        assert getattr(fresh, "resume_from_checkpoint")(
            str(tmp_path / args[0])) == 2
        text = saver.model_to_string()
        assert _trees(fresh.model_to_string()) == _trees(text)
        return
    if method != "refit":
        j = jlgb.Booster(model_str=port["text"])
        for booster in (b, j):
            if method == "free_network":
                booster.set_network("a,b")
            assert getattr(booster, method)(*args) is booster
        keys = ("machines", "local_listen_port", "num_machines")
        assert {k: b.params.get(k) for k in keys} == \
            {k: j.params.get(k) for k in keys}
        assert ("machines" in b.params) == (method == "set_network")
        return
    X, y = _data()
    y2 = y[::-1] * 0.5
    got = b.refit(X, y2, decay_rate=0.8)
    want = jlgb.Booster(model_str=port["text"]).refit(X, y2, decay_rate=0.8)
    assert _norm(got.model_to_string()) == _norm(want.model_to_string())
    assert got.model_to_string() != port["text"]


def _trees(text):
    """The tree blocks of a model text."""
    return text.split("\ntree_sizes=")[1].split("\nend of trees")[0]
