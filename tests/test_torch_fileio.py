"""File ingest, the binary cache, the rest of the Dataset surface and
predict from files and binned datasets: lightgbm_tpu_torch against
lightgbm_tpu.

Seeded data: 600 rows of five normal columns (5% NaN in columns 0-3;
column 2 also rounded to six integer codes, column 4 with many exact
zeros) and a regression label, written to CSV (with and without a
header, the label first or last, by index or by `name:`), TSV and
LibSVM files in a temporary directory, with `.weight`, `.init` and
`.query` side-car files.  The JAX package runs in one process compiled
without FMA (tests/test_torch_util.py: job "fileio"), started before the
port's runs, which work beside it; both run the same script,
`fileio_run`.

- the parser: load_text_file's arrays, names and side-cars equal for
  every format and label spec;
- one-pass ingest: bins, mappers and metadata equal, and the int8 model
  text byte-identical, for CSV, TSV and LibSVM, and with the
  categorical_feature, ignore_column and forcedbins_filename parameters;
- two-round ingest: mappers and bins equal at 600 rows with
  bin_construct_sample_cnt=200, in one chunk and in chunks of 150 rows;
  the int8 text byte-identical;
- the binary cache crosses packages: each package loads the other's
  `.bin`, with equal bins, mappers and metadata, and trains the same
  text;
- the Dataset surface: the setters (text after them), getters,
  get_ref_chain, set_reference, get_data of a subset of a subset, and
  add_features_from (merged bins and text);
- predict from a file (with and without the label column: the JAX
  package's device predict of the labelled file) and from a constructed
  Dataset: raw scores equal to the JAX package's device predict; the
  two ValueErrors word for word.
"""

import json
import shutil

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.io.dataset import TrainingData

from .test_torch_util import fileio_run, start_jax_nofma

N = 600
F = 5
REG = {"objective": "regression", "num_leaves": 7, "max_bin": 31,
       "min_data_in_leaf": 5, "verbosity": -1, "tpu_hist_precision": "int8",
       "tpu_hist_impl": "xla", "tpu_quant_refit_leaves": False}
ROUNDS = 3
FORCED_BINS = [{"feature": 0, "bin_upper_bound": [-1.0, -0.5, 0.5, 1.0]},
               {"feature": 1, "bin_upper_bound": [0.25]}]


def _data():
    rng = np.random.default_rng(17)
    X = rng.normal(size=(N, F))
    X[:, 2] = np.floor(np.abs(X[:, 2]) * 3.0)
    X[:, 4] = np.where(rng.random(N) < 0.6, 0.0, X[:, 4])
    X[:, :4][rng.random((N, 4)) < 0.05] = np.nan
    Xn = np.nan_to_num(X)
    y = Xn[:, 0] * 2.0 - Xn[:, 1] + (Xn[:, 2] == 1) + 0.3 * rng.normal(
        size=N)
    w = rng.random(N) + 0.5
    return X, y, w


def _write(d, X, y, w):
    """The data files and side-cars; returns name -> path."""
    files = {}

    def csv(name, cols, header=None, delim=","):
        path = d / name
        np.savetxt(path, cols, delimiter=delim, fmt="%.9g",
                   header=header or "", comments="")
        # np.savetxt writes "nan"; the parsers read it as missing
        files[name] = str(path)
        return path

    names = ",".join(f"f{i}" for i in range(F))
    base = csv("base.csv", np.column_stack([y, X]), "label," + names)
    np.savetxt(str(base) + ".weight", w, fmt="%.9g")
    np.savetxt(str(base) + ".init", w * 0.2, fmt="%.9g")
    csv("nohead.csv", np.column_stack([y, X]))
    csv("base.tsv", np.column_stack([y, X]), delim="\t")
    csv("last.csv", np.column_stack([X, y]), names + ",target")
    csv("idx.csv", np.column_stack([X[:, :2], y, X[:, 2:]]))
    csv("nolabel.csv", X)
    q = csv("query.csv", np.column_stack([y, X]))
    np.savetxt(str(q) + ".query", [200, 250, 150], fmt="%d")
    # LibSVM: no NaN, zeros left out
    X0 = np.nan_to_num(X)
    with open(d / "base.svm", "w") as f:
        for yi, row in zip(y, X0):
            toks = [f"{j}:{v:.9g}" for j, v in enumerate(row) if v != 0.0]
            f.write(" ".join([f"{yi:.9g}"] + toks) + "\n")
    files["base.svm"] = str(d / "base.svm")
    with open(d / "forced.json", "w") as f:
        json.dump(FORCED_BINS, f)
    files["forced.json"] = str(d / "forced.json")
    # the caches: one each package writes, one each loads
    for name in ("jaxcopy.csv", "portcopy.csv"):
        shutil.copy(base, d / name)
        files[name] = str(d / name)
    return files


def _runs(files):
    """(name, run) of every case, the same for both packages."""
    fz = files
    parse = [("parse_" + tag, {"kind": "parse", "path": fz[name], **kw})
             for tag, name, kw in (
                 ("header", "base.csv", {}),
                 ("nohead", "nohead.csv", {}),
                 ("tsv", "base.tsv", {}),
                 ("libsvm", "base.svm", {}),
                 ("by_name", "last.csv", {"label_column": "name:target"}),
                 ("by_index", "idx.csv", {"label_column": "2"}),
                 ("query", "query.csv", {}))]
    # the file without its label column: the port reads every column as
    # a feature (the JAX package's reload still drops the first column,
    # ROADMAP §C), so both of its runs are held to the labelled file's
    predict = [(fz["base.csv"], {}), (fz["nolabel.csv"], {}),
               (fz["nolabel.csv"], {"predict_disable_shape_check": True})]
    spec = dict(REG, categorical_feature="2", ignore_column="4",
                forcedbins_filename=fz["forced.json"])
    train = [
        ("csv", {"path": fz["base.csv"], "params": REG,
                 "predict": predict}),
        ("tsv", {"path": fz["base.tsv"], "params": REG}),
        ("libsvm", {"path": fz["base.svm"], "params": REG}),
        ("spec", {"path": fz["nohead.csv"], "params": spec}),
        ("two_round", {"path": fz["base.csv"],
                       "params": dict(REG, two_round=True,
                                      bin_construct_sample_cnt=200)}),
        ("jax_writes", {"path": fz["jaxcopy.csv"],
                        "params": dict(REG, save_binary=True)}),
        ("jax_reads", {"path": fz["portcopy.csv"], "params": REG}),
    ]
    runs = parse + [(k, dict(r, kind="train", rounds=ROUNDS))
                    for k, r in train]
    runs.append(("chunks", {"kind": "chunks", "path": fz["base.csv"],
                            "chunk_rows": 150,
                            "params": dict(REG,
                                           bin_construct_sample_cnt=200)}))
    surface = dict(REG, feature_contri=[1.0, 0.5, 1.0, 2.0, 1.0],
                   monotone_constraints=[1, 0, 0, -1, 0])
    for kind, params in (("surface", surface), ("merge", REG),
                         ("predict", REG)):
        runs.append((kind, {"kind": kind, "params": params,
                            "rounds": ROUNDS}))
    return runs


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("fileio")
    X, y, w = _data()
    files = _write(d, X, y, w)
    # the port's cache is written before the JAX process reads it
    port_ds = tlgb.Dataset(files["portcopy.csv"],
                           params=dict(REG, device_type="cpu")).construct()
    port_ds.save_binary(files["portcopy.csv"] + ".bin")
    runs = _runs(files)
    wait = start_jax_nofma("fileio", {"X": X, "y": y, "w": w},
                           {"runs": [r for _, r in runs]}, d)
    inp = {"X": X, "y": y, "w": w}
    port = {}
    for name, run in runs:
        if name != "jax_writes":
            port[name] = fileio_run(tlgb, run, inp)
    got = wait()
    ref = {name: {k.split("_", 1)[1]: v for k, v in got.items()
                  if k.split("_", 1)[0] == str(c)}
           for c, (name, _) in enumerate(runs)}
    # the JAX package's cache, loaded by the port once it is written
    port["jax_writes"] = fileio_run(tlgb, dict(runs)["jax_writes"], inp)
    return port, ref, files


def _text(t):
    return str(t).replace("[device_type: cpu]", "[device_type: tpu]")


PARSE = ["parse_header", "parse_nohead", "parse_tsv", "parse_libsvm",
         "parse_by_name", "parse_by_index", "parse_query"]


@pytest.mark.parametrize("case", PARSE)
def test_parser_matches(both, case):
    port, ref, _ = both
    a, b = port[case], ref[case]
    assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(a["X"], b["X"])
    np.testing.assert_array_equal(a["y"], b["y"])
    assert a["names"] == str(b["names"])
    for k in ("weight", "group", "init"):
        if k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_parser_reads_sidecars_and_header(both):
    port, _, _ = both
    assert json.loads(port["parse_header"]["names"]) == [
        f"f{i}" for i in range(F)]
    assert json.loads(port["parse_nohead"]["names"]) == [
        f"Column_{i}" for i in range(F)]
    assert "weight" in port["parse_header"] and "init" in port[
        "parse_header"]
    np.testing.assert_array_equal(port["parse_query"]["group"],
                                  [200, 250, 150])
    np.testing.assert_array_equal(port["parse_by_name"]["y"],
                                  port["parse_header"]["y"])


def test_parser_reads_a_file_without_its_label(both):
    """label_column=None (the port's predict reload): every column of a
    file without a label is a feature, and the features equal the JAX
    parser's of the labelled file."""
    _, ref, files = both
    X, y, _, _, _, names = tparser.load_text_file(files["nolabel.csv"],
                                                  label_column=None)
    assert y is None
    assert names == [f"Column_{i}" for i in range(F)]
    np.testing.assert_array_equal(X, ref["parse_header"]["X"])


TRAIN = ["csv", "tsv", "libsvm", "spec", "two_round", "jax_reads"]


@pytest.mark.parametrize("case", TRAIN)
def test_file_ingest_matches(both, case):
    port, ref, _ = both
    a, b = port[case], ref[case]
    np.testing.assert_array_equal(a["bins"], b["bins"])
    assert a["mappers"] == str(b["mappers"])
    assert a["names"] == str(b["names"])
    np.testing.assert_array_equal(a["used"], b["used"])
    for k in ("label", "weight", "init_score", "query_boundaries"):
        assert (k in a) == (k in b), k
        if k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert _text(a["text"]) == str(b["text"])


def test_file_parameters_take_effect(both):
    port, _, _ = both
    spec = json.loads(port["spec"]["mappers"])
    assert spec[2]["bin_type"] != json.loads(port["csv"]["mappers"])[2][
        "bin_type"]
    assert list(port["spec"]["used"]) == [0, 1, 2, 3]
    ub0 = spec[0]["bin_upper_bound"]
    for bound in FORCED_BINS[0]["bin_upper_bound"]:
        assert bound in ub0
    assert "weight" in port["csv"] and "init_score" in port["csv"]


def test_two_round_chunks_match(both):
    port, ref, _ = both
    a, b = port["chunks"], ref["chunks"]
    np.testing.assert_array_equal(a["bins"], b["bins"])
    assert a["mappers"] == str(b["mappers"])
    # the reservoir's draws depend on the chunks: four chunks sample
    # other rows than one
    assert a["mappers"] != port["two_round"]["mappers"]


def test_two_round_falls_back_only_for_libsvm(both, monkeypatch):
    """two_round takes the streaming loader (marked in ingest_s) on a
    CSV file and the one-pass load on LibSVM, which it cannot stream; any
    other error of the streaming loader reaches the caller."""
    from lightgbm_tpu_torch.ops import binning

    _, _, files = both
    p = dict(REG, device_type="cpu", two_round=True,
             bin_construct_sample_cnt=200)
    inner = tlgb.Dataset(files["base.csv"], params=p).construct()._inner
    assert inner.ingest_s["two_round"] == 1.0
    inner = tlgb.Dataset(files["base.svm"], params=p).construct()._inner
    assert "two_round" not in inner.ingest_s and "parse" in inner.ingest_s

    def broken(*args, **kwargs):
        raise ValueError("rows binned / rows announced")
    monkeypatch.setattr(binning, "bin_chunks_t", broken)
    with pytest.raises(ValueError, match="rows announced"):
        tlgb.Dataset(files["base.csv"], params=p).construct()


def test_binary_cache_crosses_packages(both):
    port, ref, files = both
    # the JAX package's cache, loaded by the port (and the port's by the
    # JAX package: case jax_reads, above)
    a, b = port["jax_writes"], ref["jax_writes"]
    assert sorted(a) == sorted(b)
    for k in ("bins", "used", "label"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["mappers"] == str(b["mappers"])
    assert _text(a["text"]) == str(b["text"])
    # the cache took the place of the parse
    ds = tlgb.Dataset(files["jaxcopy.csv"], params={"device_type": "cpu"})
    assert "binary" in ds.construct()._inner.ingest_s


def test_save_binary_round_trips(tmp_path):
    X, y, w = _data()
    ds = tlgb.Dataset(X, label=y, weight=w,
                      params=dict(REG, device_type="cpu")).construct()
    ds.save_binary(str(tmp_path / "d.bin"))
    back = TrainingData.from_binary(str(tmp_path / "d.bin"),
                                    tlgb.Config({"device_type": "cpu"}))
    np.testing.assert_array_equal(back.bins, ds._inner.bins)
    np.testing.assert_array_equal(back.metadata.weight,
                                  ds._inner.metadata.weight)
    assert json.dumps([m.to_dict() for m in back.mappers]) == json.dumps(
        [m.to_dict() for m in ds._inner.mappers])


def test_dataset_surface_matches(both):
    port, ref, _ = both
    a, b = port["surface"], ref["surface"]
    for k in ("weight", "init", "penalty", "mono", "subsub_data"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["num_feature"] == b["num_feature"] == F
    assert a["chain"] == b["chain"] == 2
    assert a["reference_error"] == str(b["reference_error"])
    assert a["same_mappers"] and bool(b["same_mappers"])
    assert _text(a["text"]) == str(b["text"])


def test_add_features_from_matches(both):
    port, ref, _ = both
    a, b = port["merge"], ref["merge"]
    np.testing.assert_array_equal(a["bins"], b["bins"])
    np.testing.assert_array_equal(a["used"], b["used"])
    assert a["num_feature"] == b["num_feature"] == F
    assert a["names"] == str(b["names"])
    assert _text(a["text"]) == str(b["text"])


def test_predict_from_files_matches(both):
    """A file with its label column, and the same feature columns without
    it (with and without the shape check), give the JAX package's device
    predict of the labelled file."""
    port, ref, _ = both
    a, b = port["csv"], ref["csv"]
    for i in (0, 1, 2):
        assert f"error_{i}" not in a, a.get(f"error_{i}")
        np.testing.assert_array_equal(a[f"raw_{i}"], b["raw_0"])


def test_predict_from_dataset_matches(both):
    port, ref, _ = both
    a, b = port["predict"], ref["predict"]
    np.testing.assert_array_equal(a["raw"], b["raw"])
    np.testing.assert_array_equal(a["raw"], a["raw_rows"])
    assert a["foreign_error"] == str(b["foreign_error"])
    assert a["pred_leaf_error"] == str(b["pred_leaf_error"])


def test_version_and_methods_exist():
    import lightgbm_tpu as jlgb

    assert tlgb.__version__ == jlgb.__version__
    for name in ("save_binary", "set_reference", "set_feature_name",
                 "set_label", "set_weight", "set_init_score", "get_weight",
                 "get_init_score", "get_data", "get_feature_penalty",
                 "get_monotone_constraints", "get_ref_chain",
                 "num_feature", "add_features_from"):
        assert callable(getattr(tlgb.Dataset, name)), name
    assert callable(tparser.load_text_file)
