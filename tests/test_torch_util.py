"""Shared helpers of the lightgbm_tpu_torch parity tests (no tests here)."""

import numpy as np


def cuda_device():
    """The first CUDA device, or skip (decided inside the test)."""
    import pytest
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda", 0)


def binary_data(n=2000, f=6, seed=0, nan_frac=0.05, zero_frac=0.0):
    """Seeded dense numeric binary data with NaNs (and exact zeros)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    if zero_frac:
        X[rng.random((n, f)) < zero_frac] = 0.0
    X[rng.random((n, f)) < nan_frac] = np.nan
    w = rng.normal(size=f)
    Xn = np.nan_to_num(X)
    logit = (Xn[:, :3] ** 2).sum(1) * 0.3 + Xn @ w * 0.5 - 0.9
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y



def fused_case(seed, F, n, B, K, precision, dead=(), l1=0.0, l2=0.0,
               mds=0.0, min_data=5.0, bag=0.0, bins=None, root=False,
               mono=False):
    """Seeded numpy operands of the grow megakernel (B2): quantized
    stats, leaf ids, K slots (some dead), parent histograms, the ctx rows
    with both sibling choices and consistent child totals, mixed missing
    types and bin counts, a penalized and a masked feature.  With bag > 0
    (bagged operands) about that share of the rows has zero stats and
    of the features is masked, drawn from a generator of their own.
    The bins are uint8 up to 256 bins and int32 (wide) above; `bins`
    ([F, n]) replaces the random ones.  root: every row in slot 0 (the
    root call).  mono: monotone constraints on half of the features (+1
    on every fourth from 0, -1 on every fourth from 2) and finite output
    bounds on two thirds of the children, a tenth of the child's own
    output either side of it (they bind on most splits) or from its
    output up; the last third keeps +-1e30.
    Returns (dict of arrays, split_kw)."""
    import torch

    from lightgbm_tpu_torch.ops import histogram as TH

    rng = np.random.default_rng(seed)
    q = TH.quant_limit(precision, n)
    leaves = 3 * K
    slots = rng.permutation(leaves)[:K].astype(np.int32)
    slots[list(dead)] = -1
    mask = np.ones(n, np.int64)
    mask[-50:] = 0
    bag_rng = np.random.default_rng(seed + 1000)
    if bag:
        mask[bag_rng.random(n) < bag] = 0
    stats = np.stack([rng.integers(-q, q + 1, size=n) * mask,
                      rng.integers(0, q + 1, size=n) * mask,
                      mask]).astype(np.dtype(precision))
    drawn = rng.integers(0, B, size=(F, n))
    bins = (drawn if bins is None else np.asarray(bins)).astype(
        np.uint8 if B <= 256 else np.int32)
    leaf = rng.integers(0, leaves, size=n).astype(np.int32)
    if root:
        leaf[:] = slots[0]
    small = TH._unpack_hist(TH.hist_batched_plain(
        torch.from_numpy(bins), torch.from_numpy(stats),
        torch.from_numpy(leaf), torch.from_numpy(slots), B)
        .permute(3, 2, 0, 1), precision).numpy()
    parent = (small * 2 + rng.integers(0, 50, size=small.shape)
              ).astype(np.int32)
    C = 2 * K
    scales = np.array([0.013, 0.007, 1.0], np.float32)
    ctx = np.zeros((C + 1, 8), np.float32)
    for j in range(C):
        use_small = bool(rng.random() < 0.5)
        hs = small[j % K] if use_small else parent[j % K] - small[j % K]
        tot = hs[0].sum(0).astype(np.float32) * scales
        ctx[j, :6] = [tot[0], tot[1], tot[2], -1e30, 1e30, float(use_small)]
    ctx[C, :3] = scales
    num_bin = rng.integers(2, B + 1, size=F).astype(np.int32)
    meta_i = np.zeros((F, 8), np.int32)
    meta_i[:, 0] = num_bin
    meta_i[:, 1] = np.arange(F) % 3
    meta_i[:, 2] = [rng.integers(0, nb) for nb in num_bin]
    meta_f = np.zeros((F, 8), np.float32)
    meta_f[:, 0] = 1.0
    meta_f[:, 1] = 1.0
    meta_f[F // 2, 0] = 0.5
    meta_f[F - 1, 1] = 0.0
    if bag:
        meta_f[bag_rng.random(F) < bag, 1] = 0.0
    if mono:
        meta_i[:, 3] = np.where(np.arange(F) % 4 == 0, 1,
                                np.where(np.arange(F) % 4 == 2, -1, 0))
        out = -ctx[:C, 0] / np.maximum(ctx[:C, 1], np.float32(1e-3))
        band = np.maximum(np.float32(0.1) * np.abs(out), np.float32(1e-6))
        j = np.arange(C)
        ctx[:C, 3] = np.where(j % 3 == 2, -1e30,
                              np.where(j % 3 == 0, out - band, out))
        ctx[:C, 4] = np.where(j % 3 == 0, out + band, 1e30)
    kw = dict(l1=l1, l2=l2, max_delta_step=mds, min_data_in_leaf=min_data,
              min_sum_hessian=1e-3, min_gain_to_split=0.0)
    return dict(bins=bins, stats=stats, leaf=leaf, slots=slots,
                parent=parent, ctx=ctx, meta_i=meta_i, meta_f=meta_f), kw


FUSED_KEYS = ("bins", "stats", "leaf", "slots", "parent", "ctx", "meta_i",
              "meta_f")


def fused_args(case, B, precision, device="cpu"):
    """The positional operands of ops/fused.py's functions."""
    import torch

    return tuple(torch.from_numpy(case[k]).to(device)
                 for k in FUSED_KEYS) + (B, precision)


def assert_trees_match(trees_j, trees_t, rtol=1e-5):
    """Float-histogram trees of the two packages: the same structure,
    thresholds and leaf counts; leaf values within rtol of the tree's
    largest |value| (they are differences of f32 row sums, rounded in
    another order; tests/test_torch_slice.py:test_trees_equal)."""
    assert len(trees_t) == len(trees_j)
    for i, (a, b) in enumerate(zip(trees_j, trees_t)):
        assert b.num_leaves == a.num_leaves, i
        ni, nl = a.num_leaves - 1, a.num_leaves
        for name in ("split_feature", "threshold_in_bin", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:ni],
                                          getattr(a, name)[:ni],
                                          err_msg=f"tree {i} {name}")
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
        ref = np.asarray(a.leaf_value[:nl], np.float64)
        err = np.abs(np.asarray(b.leaf_value[:nl]) - ref).max()
        assert err <= rtol * np.abs(ref).max(), (i, err)


# ---- the JAX package compiled without fused multiply-add ------------------
#
# XLA:CPU contracts f32 a*b+c inside its fusions into single-rounding FMA
# instructions wherever the host has them (its LLVM target allows FP op
# fusion), so the jitted JAX package rounds some products once where its
# own op-by-op evaluation, the port's plain twins and the port's CUDA
# kernels round twice.  The bitwise parity tests therefore run the JAX side
# in a subprocess compiled for an x86 ISA without FMA
# (--xla_cpu_max_isa=AVX): the same program, every f32 op rounded on its
# own.  XLA's other rewrite that reaches the results, a division by a
# constant turned into a product with its f32 reciprocal, is reproduced by
# the port itself (ops/grower.py).  This module imports torch and pytest
# lazily, so that process loads JAX alone.
#
#     python -m tests.test_torch_util JOB IN.npz OUT.npz
# runs JOB ("fused", "grow" or "train") in such a process.

NOFMA_FLAGS = "--xla_cpu_max_isa=AVX"


def run_jax_nofma(job, arrays, spec, tmp_path):
    """Run `job` of this module in a JAX process compiled without FMA;
    `arrays` (name -> numpy array) and the JSON-able `spec` go in, a dict
    of numpy arrays comes back."""
    return start_jax_nofma(job, arrays, spec, tmp_path)()


def start_jax_nofma(job, arrays, spec, tmp_path):
    """run_jax_nofma without the wait: the process starts, and calling
    the returned function waits for it and returns its arrays, so a test
    can run the port meanwhile."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    src, dst = tmp_path / f"{job}_in.npz", tmp_path / f"{job}_out.npz"
    np.savez(src, __spec__=np.array(json.dumps(spec)), **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=NOFMA_FLAGS)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_util", job, str(src),
         str(dst)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def result():
        try:
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-4000:]
        with np.load(dst) as out:
            return {k: out[k] for k in out.files}
    return result


def _job_fused(inp, spec):
    """lightgbm_tpu's fused_hist_scan (interpret mode) on each case."""
    import jax.numpy as jnp
    from lightgbm_tpu.ops.fused import fused_hist_scan

    out = {}
    for c, case in enumerate(spec["cases"]):
        a = {k: inp[f"{c}_{k}"] for k in ("bins", "stats", "leaf", "slots",
                                          "parent", "ctx", "meta_i",
                                          "meta_f")}
        F, n = a["bins"].shape
        nb, blk = case["nb"], n // case["nb"]
        hist, rec = fused_hist_scan(
            jnp.asarray(a["bins"].reshape(F, nb, blk).transpose(1, 0, 2)),
            jnp.asarray(a["stats"].reshape(3, nb, blk)),
            jnp.asarray(a["leaf"].reshape(nb, blk)),
            jnp.asarray(a["slots"]), jnp.asarray(a["parent"]),
            jnp.asarray(a["ctx"]), jnp.asarray(a["meta_i"]),
            jnp.asarray(a["meta_f"]), case["B"], case["precision"],
            split_kw=case["split_kw"])
        out[f"{c}_hist"], out[f"{c}_rec"] = np.asarray(hist), np.asarray(rec)
    return out


def _job_grow(inp, spec):
    """lightgbm_tpu's jitted grower, one program per precision; the
    rounding mode and the leaf refit ride its traced mode flags."""
    import jax.numpy as jnp
    from lightgbm_tpu.ops import grower as JG

    meta = {k: jnp.asarray(inp["meta_" + k]) for k in spec["meta_keys"]}
    out = {}
    for c, run in enumerate(spec["runs"]):
        p = JG.GrowerParams(**run["params"])
        grow = JG.make_grower(JG.canonical_params(p), inp["bins"].shape[0])
        m = dict(meta, mode_flags=jnp.asarray(JG.mode_flags_np(
            p.quant_round, p.quant_refit)))
        res = grow(jnp.asarray(inp["bins"]), jnp.asarray(inp["grad"]),
                   jnp.asarray(inp["hess"]), jnp.asarray(inp["mask"]),
                   jnp.asarray(inp["fmask"]), m, jnp.asarray(inp["key"]))
        for k in ("records", "leaf_ids", "leaf_output"):
            out[f"{c}_{k}"] = np.asarray(res[k])
    return out


def _job_train(inp, spec):
    """lgb.train of lightgbm_tpu: each run's model text and raw scores."""
    import lightgbm_tpu as lgb

    out = {}
    for c, params in enumerate(spec["runs"]):
        y = inp["y_" + params.pop("label")]
        b = lgb.train(params, lgb.Dataset(inp["X"], label=y,
                                          params={"max_bin":
                                                  params["max_bin"]}),
                      num_boost_round=spec["rounds"])
        out[f"{c}_text"] = np.array(b.model_to_string())
        out[f"{c}_raw"] = np.asarray(b.predict(inp["X"], raw_score=True))
        out[f"{c}_key"] = np.asarray(b._driver._key)
        out[f"{c}_bag_key"] = np.asarray(b._driver._bag_key)
        # the jitted bin-space forest walk (f32 sums over trees) of the
        # first `it` iterations
        for it in spec.get("device_predict_iterations", []):
            out[f"{c}_device_raw_{it}"] = np.asarray(b.predict(
                inp["X"], raw_score=True, num_iteration=it,
                tpu_predict_device="true"))
    return out


# ---- training runs with validation sets, callbacks and custom objectives ---
#
# One driver for both packages: `train_valid_run(lgb, ...)` takes either
# module, so the port (in process) and the JAX package (in the no-FMA
# process, job "train_valid") run the very same script.


def fobj_l2(scores, train_set):
    """Custom L2 gradients on the host (numpy): scores [1, n] f64."""
    s = scores.reshape(-1)
    return s - train_set.get_label(), np.ones_like(s)


def fobj_logloss(scores, train_set):
    """Custom binary logloss gradients on the host (numpy)."""
    s = scores.reshape(-1)
    p = 1.0 / (1.0 + np.exp(-s))
    return p - train_set.get_label(), p * (1.0 - p)


def fobj_zero(scores, train_set):
    """No gradient at all: the first tree cannot split."""
    s = scores.reshape(-1)
    return np.zeros_like(s), np.ones_like(s)


def feval_mae(preds, data):
    return "mae", float(np.mean(np.abs(preds - data.get_label()))), False


FOBJS = {"l2": fobj_l2, "logloss": fobj_logloss, "zero": fobj_zero}
FEVALS = {"mae": feval_mae}


def train_valid_run(lgb, X, y, run):
    """lgb.train of `lgb` with the run's validation layout, custom
    functions and callbacks.  run: params, n_train (the rows before it
    train, the rest validate), rounds, and optionally valid ("valid",
    "train+valid" or "none"), fobj, feval, early_stopping_rounds,
    learning_rates, verbose_eval, callbacks (a list of names).  Returns
    a dict of the model text at the default (best) iteration and in
    full, the evals_result, best_iteration, best_score, the raw scores
    of the validation rows and the printed log."""
    import contextlib
    import io
    import json

    p = dict(run["params"])
    n = run["n_train"]
    train = lgb.Dataset(X[:n], label=y[:n], params={"max_bin":
                                                    p["max_bin"]})
    valid = lgb.Dataset(X[n:], label=y[n:], reference=train)
    layout = run.get("valid", "valid")
    sets, names = {"valid": ([valid], ["valid"]),
                   "train+valid": ([train, valid], ["train", "valid"]),
                   "none": (None, None)}[layout]
    evals = {}
    cbs = []
    for name in run.get("callbacks", []):
        if name == "record":
            cbs.append(lgb.callback.record_evaluation(evals))
        elif name == "log":
            cbs.append(lgb.callback.log_evaluation(2))
        elif name == "early_stopping":
            cbs.append(lgb.callback.early_stopping(3, verbose=True))
        elif name == "reset_lr":
            cbs.append(lgb.callback.reset_parameter(
                learning_rate=lambda i: 0.6 * 0.97 ** i))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        b = lgb.train(p, train, num_boost_round=run["rounds"],
                      valid_sets=sets, valid_names=names,
                      fobj=FOBJS.get(run.get("fobj")),
                      feval=FEVALS.get(run.get("feval")),
                      callbacks=cbs or None,
                      early_stopping_rounds=run.get("early_stopping_rounds"),
                      learning_rates=run.get("learning_rates"),
                      verbose_eval=run.get("verbose_eval", False),
                      evals_result=None if "record" in run.get(
                          "callbacks", []) else evals)
    return {"text": b.model_to_string(),
            "full_text": b.model_to_string(num_iteration=-1),
            "evals": json.dumps(evals),
            "best_iteration": b.best_iteration,
            "best_score": json.dumps(b.best_score),
            "raw": np.asarray(b.predict(X[n:], raw_score=True)),
            "log": out.getvalue()}


def _job_train_valid(inp, spec):
    import lightgbm_tpu as lgb

    out = {}
    for c, run in enumerate(spec["runs"]):
        res = train_valid_run(lgb, inp["X"], inp["y_" + run["label"]], run)
        for k, v in res.items():
            out[f"{c}_{k}"] = np.asarray(v)
    return out


def goss_kept_jax(lgb, X, y, params, rounds):
    """The live rows of the JAX step's row mask at each of `rounds`
    trees: the learner's grower wrapped before the step is built, the
    mask's sum sent to the host from inside the compiled step."""
    import jax

    b = lgb.Booster(params=dict(params), train_set=lgb.Dataset(
        X, label=y, params={"max_bin": params["max_bin"]}))
    drv = b._driver
    grow = drv.learner.grow
    kept = []

    def spy(bins_t, g, h, mask, *rest):
        jax.debug.callback(lambda m: kept.append(float(np.sum(m))), mask)
        return grow(bins_t, g, h, mask, *rest)

    drv.learner.grow = spy
    drv._maybe_make_train_step()
    for _ in range(rounds):
        b.update()
    jax.effects_barrier()
    return np.asarray(kept)


def cv_run(lgb, X, y, run):
    """lgb.cv of `lgb` on a dataset binned with the run's max_bin (and
    the run's query sizes, `group`, and categorical columns, `cat`, where
    it has them):
    (the result dict without the boosters as JSON, each fold booster's
    raw scores of X or None)."""
    import json

    p = dict(run["params"])
    res = lgb.cv(p, lgb.Dataset(X, label=y, group=run.get("group"),
                                categorical_feature=run.get("cat", "auto"),
                                params={"max_bin": p["max_bin"]}),
                 num_boost_round=run["rounds"], nfold=run["nfold"],
                 stratified=run.get("stratified", True),
                 shuffle=run.get("shuffle", True), seed=run.get("seed", 0),
                 early_stopping_rounds=run.get("early_stopping_rounds"),
                 return_cvbooster=run.get("return_cvbooster", False))
    boosters = res.pop("cvbooster", None)
    raw = None
    if boosters is not None:
        kw = {} if lgb.__name__ == "lightgbm_tpu_torch" else {
            "tpu_predict_device": "true"}
        raw = np.stack(boosters.predict(X, raw_score=True, **kw))
    return json.dumps(res), raw


def zoo_run(lgb, X, y, run):
    """lgb.train of `lgb` with one objective of the zoo.  run: params,
    rounds, and optionally group (the query sizes of all rows), weight
    (a name of the inputs), n_train (the rows before it train, the rest
    validate, on query bounds), early_stopping_rounds, frame (column
    names: the rows go in as a pandas DataFrame) and predict_iterations.
    Returns the model text, the raw scores of X (the JAX package's on its
    device path), the evals_result, the best iteration and the raw
    scores at each of predict_iterations."""
    import json

    p = dict(run["params"])
    kw = {} if lgb.__name__ == "lightgbm_tpu_torch" else {
        "tpu_predict_device": "true"}
    group = run.get("group")
    w = run.get("weight")
    n = run.get("n_train", len(y))
    rows = X
    if run.get("frame"):
        import pandas as pd

        rows = pd.DataFrame(X, columns=run["frame"])
    g_tr = g_va = None
    if group is not None:
        # the split moves up to the next query bound
        bounds = np.concatenate([[0], np.cumsum(group)])
        q = int(np.searchsorted(bounds, n))
        n = int(bounds[q])
        g_tr, g_va = list(group[:q]), list(group[q:])
    train = lgb.Dataset(rows[:n], label=y[:n], group=g_tr,
                        weight=None if w is None else w[:n],
                        params={"max_bin": p["max_bin"]})
    evals = {}
    valid = []
    if n < len(y):
        valid = [lgb.Dataset(rows[n:], label=y[n:], group=g_va,
                             weight=None if w is None else w[n:],
                             reference=train)]
    b = lgb.train(p, train, num_boost_round=run["rounds"],
                  valid_sets=valid or None, evals_result=evals,
                  early_stopping_rounds=run.get("early_stopping_rounds"),
                  verbose_eval=False)
    out = {"text": b.model_to_string(),
           "raw": np.asarray(b.predict(rows, raw_score=True, **kw)),
           "evals": json.dumps(evals),
           "best_iteration": b.best_iteration}
    for it in run.get("predict_iterations", []):
        out[f"raw_{it}"] = np.asarray(b.predict(rows, raw_score=True,
                                                num_iteration=it, **kw))
    return out


def booster_io_run(lgb, X, y, run, tmp):
    """The model surface of one trained booster of `lgb`: its saved file,
    dump_model JSON, both feature importances, trees_to_dataframe (as
    JSON), the text after shuffle_models, and the raw scores of a model
    text `run["load"]` loaded and predicted (the JAX package's on its
    device path)."""
    import json
    import os

    kw = {} if lgb.__name__ == "lightgbm_tpu_torch" else {
        "tpu_predict_device": "true"}
    p = dict(run["params"])
    b = lgb.train(p, lgb.Dataset(X, label=y, params={"max_bin":
                                                     p["max_bin"]}),
                  num_boost_round=run["rounds"], keep_training_booster=True)
    path = os.path.join(tmp, f"{lgb.__name__}.txt")
    b.save_model(path)
    with open(path) as f:
        saved = f.read()
    out = {"saved": saved,
           "dump": json.dumps(b.dump_model()),
           "split": b.feature_importance("split"),
           "gain": b.feature_importance("gain"),
           "trees_frame": b.trees_to_dataframe().to_json(),
           "raw": np.asarray(b.predict(X, raw_score=True, **kw))}
    b.shuffle_models(1, 4)
    out["shuffled"] = b.model_to_string()
    if run.get("load"):
        other = lgb.Booster(model_str=run["load"], **(
            {"params": {"device_type": "cpu"}}
            if lgb.__name__ == "lightgbm_tpu_torch" else {}))
        out["loaded_raw"] = np.asarray(other.predict(X, raw_score=True,
                                                     **kw))
    return out


# ---- categorical features --------------------------------------------------


def cat_frame(X, cat):
    """X as a DataFrame whose `cat` columns are pandas categoricals of
    strings ("k<code>"; NaN and negative codes missing), the other
    columns numeric."""
    import pandas as pd

    cols = {}
    for j in range(X.shape[1]):
        v = X[:, j]
        if j in cat:
            ok = ~np.isnan(v) & (v >= 0)
            names = np.array([f"k{int(c)}" if o else None
                              for c, o in zip(np.nan_to_num(v), ok)],
                             dtype=object)
            cols[f"f{j}"] = pd.Categorical(names)
        else:
            cols[f"f{j}"] = v
    return pd.DataFrame(cols)


def cat_run(lgb, X, y, run):
    """lgb.train of `lgb` with categorical features.  run: params, rounds,
    cat (the categorical column indices), and optionally n_train (the
    rows before it train, the rest validate with reference= the training
    set), frame (the rows go in as `cat_frame`, the categorical columns
    as pandas categories), probe (the name of an input of rows to
    predict) and load (a model text to load and predict X with).
    Returns the model text, the raw scores of X (the JAX package's on its
    device path), dump_model's JSON, trees_to_dataframe as JSON, the
    evals_result and the raw scores of the probe rows and of the loaded
    model."""
    import json

    p = dict(run["params"])
    jax_side = lgb.__name__ != "lightgbm_tpu_torch"
    kw = {"tpu_predict_device": "true"} if jax_side else {}
    rows = cat_frame(X, run["cat"]) if run.get("frame") else X
    n = run.get("n_train", len(y))
    train = lgb.Dataset(rows[:n], label=y[:n],
                        categorical_feature=("auto" if run.get("frame")
                                             else list(run["cat"])),
                        params={"max_bin": p["max_bin"]})
    evals = {}
    valid = []
    if n < len(y):
        valid = [lgb.Dataset(rows[n:], label=y[n:], reference=train)]
    b = lgb.train(p, train, num_boost_round=run["rounds"],
                  valid_sets=valid or None, evals_result=evals,
                  verbose_eval=False, keep_training_booster=True)
    out = {"text": b.model_to_string(),
           "raw": np.asarray(b.predict(rows, raw_score=True, **kw)),
           "dump": json.dumps(b.dump_model()),
           "trees_frame": b.trees_to_dataframe().to_json(),
           "evals": json.dumps(evals)}
    if run.get("probe") is not None:
        out["probe_raw"] = np.asarray(b.predict(
            run["probe"], raw_score=True, **kw))
    if run.get("load"):
        other = lgb.Booster(model_str=run["load"], **(
            {} if jax_side else {"params": {"device_type": "cpu"}}))
        out["loaded_raw"] = np.asarray(other.predict(X, raw_score=True,
                                                     **kw))
    return out


def _job_cat_split(inp, spec):
    """lightgbm_tpu's per_feature_best_split_categorical, jitted and
    vmapped over the children as its grower runs it, on each case."""
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.ops.split import per_feature_best_split_categorical

    out = {}
    for c, case in enumerate(spec["cases"]):
        a = {k: jnp.asarray(inp[f"{c}_{k}"]) for k in (
            "hist", "sum_g", "sum_h", "num_data", "num_bin",
            "missing_type", "penalty", "feature_mask")}
        kw = case["kw"]

        def one(h, sg, sh, nd, a=a, kw=kw):
            return per_feature_best_split_categorical(
                h, sg, sh, nd, a["num_bin"], a["missing_type"],
                a["penalty"], a["feature_mask"], **kw)

        res = jax.jit(jax.vmap(one))(a["hist"], a["sum_g"], a["sum_h"],
                                     a["num_data"])
        for k, v in res._asdict().items():
            out[f"{c}_{k}"] = np.asarray(v)
    return out


# ---- the sklearn wrappers ---------------------------------------------------


def sk_l2_obj(y_true, y_pred):
    """A custom objective of the wrapper's form: L2 gradients."""
    return y_pred - y_true, np.ones_like(y_true)


def sklearn_run(lgb, X, y, run):
    """One estimator of `lgb`'s sklearn wrapper fitted and predicted.
    run: est (the class name), kw (constructor arguments), and optionally
    labels ("str": y as "neg"/"pos" strings), group (query sizes), cat
    (categorical columns, passed to fit), frame (the rows as `cat_frame`
    of cat), n_train with early_stopping_rounds (the rows past it as
    eval_set) and fobj (sk_l2_obj as the objective).  Returns the model
    text, predict (and predict_proba, for a classifier) of the fitted
    rows, the best iteration and the evals_result."""
    import json

    kw = {} if lgb.__name__ == "lightgbm_tpu_torch" else {
        "tpu_predict_device": "true"}
    est = getattr(lgb, run["est"])(**run["kw"])
    if run.get("fobj"):
        est.set_params(objective=sk_l2_obj)
    labels = np.where(y > 0, "pos", "neg") if run.get("labels") else y
    rows = cat_frame(X, run["cat"]) if run.get("frame") else X
    n = run.get("n_train", len(y))
    fit = {}
    if run.get("group") is not None:
        fit["group"] = run["group"]
    if run.get("cat") and not run.get("frame"):
        fit["categorical_feature"] = list(run["cat"])
    if n < len(y):
        fit.update(eval_set=[(rows[n:], labels[n:])], eval_metric="l2",
                   early_stopping_rounds=run["early_stopping_rounds"])
    est.fit(rows[:n], labels[:n], **fit)
    out = {"text": est.booster_.model_to_string(),
           "pred": np.asarray(est.predict(rows[:n], **kw)),
           "best_iteration": est.best_iteration_,
           "evals": json.dumps(est.evals_result_)}
    if hasattr(est, "predict_proba"):
        out["proba"] = np.asarray(est.predict_proba(rows[:n], **kw))
    return out


def _job_sklearn(inp, spec):
    import lightgbm_tpu as lgb

    out = {}
    for c, run in enumerate(spec["runs"]):
        y = inp["y_" + run.get("label", "regression")]
        for k, v in sklearn_run(lgb, inp["X"], y, run).items():
            out[f"{c}_{k}"] = np.asarray(v)
    return out


def _job_boosting(inp, spec):
    """Runs of several kinds in one process: "train_valid"
    (train_valid_run), "goss_kept" (goss_kept_jax), "cv" (cv_run), "zoo"
    (zoo_run), "booster_io" (booster_io_run), "cat" (cat_run) and
    "load_predict" (a model text loaded and its raw scores of the rows of
    X from `start` on, on the device path unless `device` says
    otherwise)."""
    import lightgbm_tpu as lgb

    out = {}
    X = inp["X"]
    for c, run in enumerate(spec["runs"]):
        kind = run["kind"]
        y = inp["y_" + run.get("label", "regression")]
        if kind == "train_valid":
            for k, v in train_valid_run(lgb, X, y, run).items():
                out[f"{c}_{k}"] = np.asarray(v)
        elif kind == "goss_kept":
            out[f"{c}_kept"] = goss_kept_jax(lgb, X, y, run["params"],
                                             run["rounds"])
        elif kind == "cv":
            res, raw = cv_run(lgb, X, y, run)
            out[f"{c}_result"] = np.array(res)
            if raw is not None:
                out[f"{c}_raw"] = raw
        elif kind == "zoo":
            w = inp.get("w_" + run["weight"]) if run.get("weight") else None
            for k, v in zoo_run(lgb, X, y, dict(run, weight=w)).items():
                out[f"{c}_{k}"] = np.asarray(v)
        elif kind == "booster_io":
            import tempfile

            with tempfile.TemporaryDirectory() as tmp:
                for k, v in booster_io_run(lgb, X, y, run, tmp).items():
                    out[f"{c}_{k}"] = np.asarray(v)
        elif kind == "cat":
            run = dict(run, probe=inp.get(run.get("probe", ""), None))
            Xc = inp["X_" + run["data"]] if run.get("data", "base") != \
                "base" else X
            for k, v in cat_run(lgb, Xc, y, run).items():
                out[f"{c}_{k}"] = np.asarray(v)
        elif kind == "load_predict":
            b = lgb.Booster(model_str=run["text"])
            out[f"{c}_raw"] = np.asarray(b.predict(
                X[run.get("start", 0):], raw_score=True,
                tpu_predict_device=run.get("device", "true")))
    return out


# ---- sparse data and EFB bundles --------------------------------------------


def csr_arrays(name, X):
    """A scipy matrix as the npz arrays `csr_from` rebuilds it from."""
    X = X.tocsr()
    return {f"{name}_data": X.data, f"{name}_indices": X.indices,
            f"{name}_indptr": X.indptr, f"{name}_shape": np.array(X.shape)}


def csr_from(inp, name):
    import scipy.sparse as sp

    return sp.csr_matrix((inp[f"{name}_data"], inp[f"{name}_indices"],
                          inp[f"{name}_indptr"]),
                         shape=tuple(inp[f"{name}_shape"]))


def sparse_run(lgb, X, y, run):
    """lgb.train of `lgb` on the scipy matrix X.  run: params, rounds,
    and optionally csc (X goes in as CSC), cat (categorical column
    indices) and n_train (the rows before it train, the rest, CSR,
    validate with reference= the training set).  Returns the model
    text, the raw scores of X as CSR and densified (the JAX package's on
    its device path), the evals_result, the bundle plan's groups as JSON
    ("null": no plan) and the learner's bundle columns [G, n]."""
    import json

    p = dict(run["params"])
    jax_side = lgb.__name__ != "lightgbm_tpu_torch"
    kw = {"tpu_predict_device": "true"} if jax_side else {}
    n = run.get("n_train", X.shape[0])
    rows = X[:n].tocsc() if run.get("csc") else X[:n]
    train = lgb.Dataset(rows, label=y[:n],
                        categorical_feature=run.get("cat", "auto"),
                        params={"max_bin": p["max_bin"]})
    valid = []
    if n < X.shape[0]:
        valid = [lgb.Dataset(X[n:], label=y[n:], reference=train)]
    evals = {}
    b = lgb.train(p, train, num_boost_round=run["rounds"],
                  valid_sets=valid or None, evals_result=evals,
                  verbose_eval=False, keep_training_booster=True)
    learner = b._driver.learner
    plan = learner.bundle_plan
    G = learner.num_columns
    return {"text": b.model_to_string(),
            "raw": np.asarray(b.predict(X, raw_score=True, **kw)),
            "raw_dense": np.asarray(b.predict(X.toarray(), raw_score=True,
                                              **kw)),
            "evals": json.dumps(evals),
            "plan": json.dumps(None if plan is None else
                               [list(map(int, g)) for g in plan.groups]),
            "columns": np.asarray(learner.bins_t)[:G, :n]}


def _job_sparse(inp, spec):
    """Runs on a scipy matrix: kinds "train" (sparse_run), "cv"
    (cv_run), "sklearn" (sklearn_run, on the densified rows with
    "dense") and "load_predict" (a model text loaded and its raw scores
    of the matrix, on the device path)."""
    import lightgbm_tpu as lgb

    X = csr_from(inp, "X")
    out = {}
    for c, run in enumerate(spec["runs"]):
        kind = run["kind"]
        y = inp["y_" + run.get("label", "regression")]
        if kind == "train":
            res = sparse_run(lgb, X, y, run)
        elif kind == "cv":
            res, raw = cv_run(lgb, X, y, run)
            res = {"result": np.array(res)}
            if raw is not None:
                res["raw"] = raw
        elif kind == "sklearn":
            # "dense": the densified rows (the JAX wrapper's fit reads
            # np.asarray(X).shape[1], which a scipy matrix does not have)
            res = sklearn_run(lgb, X.toarray() if run.get("dense") else X,
                              y, run)
        elif kind == "load_predict":
            b = lgb.Booster(model_str=run["text"])
            res = {"raw": b.predict(X, raw_score=True,
                                    tpu_predict_device="true")}
        for k, v in res.items():
            out[f"{c}_{k}"] = np.asarray(v)
    return out


# ---- monotone constraints, CEGB, forced splits, deterministic=true ---------


def constraints_run(lgb, X, y, run):
    """lgb.train of `lgb` (kind "updates": a Booster and `rounds`
    update() calls) with monotone constraints, CEGB, forced splits or
    deterministic=true.  run: params, rounds, and optionally cat (the
    categorical columns).  Returns the model text, the raw scores of X
    (the JAX package's on its device path), whether the learner formed
    an EFB plan and, under CEGB, the learner's cross-tree state over the
    real features and rows (used [F], paid [F, n] as uint8); or, where
    training raises, the exception's class name and message."""
    p = dict(run["params"])
    jax_side = lgb.__name__ != "lightgbm_tpu_torch"
    kw = {"tpu_predict_device": "true"} if jax_side else {}
    train = lgb.Dataset(X, label=y,
                        categorical_feature=run.get("cat", "auto"),
                        params={"max_bin": p["max_bin"]})
    try:
        if run["kind"] == "updates":
            b = lgb.Booster(params=p, train_set=train)
            for _ in range(run["rounds"]):
                b.update()
        else:
            b = lgb.train(p, train, num_boost_round=run["rounds"],
                          keep_training_booster=True)
    except Exception as exc:  # noqa: BLE001 - the type is the result
        return {"error": type(exc).__name__, "message": str(exc)}
    learner = b._driver.learner
    out = {"text": b.model_to_string(),
           "raw": np.asarray(b.predict(X, raw_score=True, **kw)),
           "plan": learner.bundle_plan is not None}
    F, n = learner.num_features, X.shape[0]
    state = ((getattr(learner, "_cegb_used", None),
              getattr(learner, "_cegb_paid", None))
             if jax_side else (learner.meta.get("cegb_used"),
                               learner.meta.get("cegb_paid")))
    if state[0] is not None:
        out["used"] = np.asarray(state[0])[:F]
    if state[1] is not None:
        out["paid"] = np.asarray(state[1])[:F, :n].astype(np.uint8)
    return out


def _job_constraints(inp, spec):
    """Runs of kinds "train"/"updates" (constraints_run), "cv" (cv_run),
    "sklearn" (sklearn_run), "load" (a model text loaded and its raw
    scores of the rows, on the device path) and "orders" (jnp.cumsum
    over the last axis of the input orders_scan and jnp.sum over the
    bins of orders_sum, in f64) on the data set named by each run."""
    import lightgbm_tpu as lgb

    out = {}
    for c, run in enumerate(spec["runs"]):
        X = inp["X_" + run.get("data", "base")]
        y = inp[f"y_{run.get('data', 'base')}_{run.get('label', 'reg')}"]
        if run["kind"] == "cv":
            res, raw = cv_run(lgb, X, y, run)
            res = {"result": np.array(res)}
        elif run["kind"] == "sklearn":
            res = sklearn_run(lgb, X, y, run)
        elif run["kind"] == "orders":
            # XLA:CPU's f64 prefix sums and bin sums, in the x64 process
            import jax
            import jax.numpy as jnp

            jax.config.update("jax_enable_x64", True)
            res = {"cumsum": jax.jit(lambda a: jnp.cumsum(a, axis=-1))(
                       inp["orders_scan"]),
                   "sum": jax.jit(lambda a: jnp.sum(a, axis=-2))(
                       inp["orders_sum"])}
        elif run["kind"] == "load":
            res = {"raw": lgb.Booster(model_str=run["text"]).predict(
                X, raw_score=True, tpu_predict_device="true")}
        else:
            res = constraints_run(lgb, X, y, run)
        for k, v in res.items():
            out[f"{c}_{k}"] = np.asarray(v)
    return out


# ---- file ingest, the binary cache, the Dataset surface ----------------------


def _mapper_json(mappers):
    import json

    return json.dumps([m.to_dict() for m in mappers])


def fileio_run(lgb, run, inp):
    """One run of tests/test_torch_fileio.py with the package `lgb` (the
    port on the CPU, or the JAX package, whose raw scores come from its
    device path).  Kinds: "parse" (load_text_file's arrays and names),
    "chunks" (TrainingData._from_file_two_round at run["chunk_rows"]:
    bins and mappers), "train" (lgb.Dataset(run["path"]) trained: model
    text, bins, mappers, metadata and raw scores of run["predict"]'s
    files, each with its predict keywords, or the error it raises),
    "surface" (the Dataset setters and getters on the arrays of
    `inp`), "merge" (add_features_from), "predict" (predict of a Dataset
    built with reference=, and the errors of one built without it and
    of pred_leaf).  A run that raises returns the exception's class name
    and message."""
    import importlib
    import json

    jax_side = lgb.__name__ != "lightgbm_tpu_torch"
    kw = {"tpu_predict_device": "true"} if jax_side else {}
    p = dict(run.get("params", {}))
    if not jax_side:
        p["device_type"] = "cpu"
    kind = run["kind"]
    if kind == "parse":
        parser = importlib.import_module(lgb.__name__ + ".io.parser")
        X, y, w, g, init, names = parser.load_text_file(
            run["path"], label_column=run.get("label_column", ""),
            header=run.get("header"))
        out = {"X": X, "y": y, "names": json.dumps(names)}
        for k, v in (("weight", w), ("group", g), ("init", init)):
            if v is not None:
                out[k] = v
        return out
    if kind == "chunks":
        TD = importlib.import_module(lgb.__name__ + ".io.dataset") \
            .TrainingData
        td = TD._from_file_two_round(run["path"], lgb.Config(p), None,
                                     chunk_rows=run["chunk_rows"])
        return {"bins": np.asarray(td.bins), "mappers":
                _mapper_json(td.mappers)}

    def model(ds, valid=()):
        return lgb.train(p, ds, num_boost_round=run["rounds"],
                         keep_training_booster=True)

    def text_of(b):
        return np.array(b.model_to_string())

    if kind == "train":
        ds = lgb.Dataset(run["path"], params=p).construct()
        inner = ds._inner
        md = inner.metadata
        out = {"bins": np.asarray(inner.bins),
               "mappers": _mapper_json(inner.mappers),
               "names": json.dumps(inner.feature_names),
               "used": np.asarray(inner.used_feature_idx),
               "label": md.label}
        for k in ("weight", "init_score", "query_boundaries"):
            if getattr(md, k) is not None:
                out[k] = getattr(md, k)
        b = model(ds)
        out["text"] = text_of(b)
        for i, (path, pkw) in enumerate(run.get("predict", [])):
            try:
                out[f"raw_{i}"] = np.asarray(b.predict(
                    path, raw_score=True, **kw, **pkw))
            except Exception as exc:  # noqa: BLE001 - the type is the result
                out[f"error_{i}"] = f"{type(exc).__name__}: {exc}"
        return out
    X, y, w = inp["X"], inp["y"], inp["w"]
    if kind == "surface":
        ds = lgb.Dataset(X, label=np.zeros_like(y), params=p).construct()
        ds.set_label(y).set_weight(w).set_init_score(w * 0.1)
        ds.set_feature_name([f"c{i}" for i in range(X.shape[1])])
        valid = lgb.Dataset(X[:50], label=y[:50], reference=ds)
        sub = ds.subset(np.arange(0, len(y), 3))
        subsub = sub.subset(np.arange(0, 40, 2))
        out = {"weight": ds.get_weight(), "init": ds.get_init_score(),
               "num_feature": ds.num_feature(),
               "penalty": ds.get_feature_penalty(),
               "mono": ds.get_monotone_constraints(),
               "chain": len(valid.get_ref_chain()),
               "subsub_data": subsub.get_data()}
        try:
            unset = lgb.Dataset(X, label=y, params=p)
            unset.set_reference(ds)
            unset.construct()
            unset.set_reference(valid)
        except RuntimeError as exc:
            out["reference_error"] = str(exc)
        out["same_mappers"] = unset._inner.mappers is ds._inner.mappers
        out["text"] = text_of(model(ds))
        return out
    if kind == "merge":
        a = lgb.Dataset(X[:, :3], label=y, params=p).construct()
        b = lgb.Dataset(X[:, 3:], label=y, params=p).construct()
        a.add_features_from(b)
        return {"bins": np.asarray(a._inner.bins),
                "used": np.asarray(a._inner.used_feature_idx),
                "num_feature": a.num_feature(),
                "names": json.dumps(a._inner.feature_names),
                "text": text_of(model(a))}
    if kind == "predict":
        ds = lgb.Dataset(X, label=y, params=p)
        b = model(ds)
        valid = lgb.Dataset(X[::2], label=y[::2], reference=ds)
        out = {"raw": np.asarray(b.predict(valid, raw_score=True)),
               "raw_rows": np.asarray(b.predict(X[::2], raw_score=True,
                                                **kw))}
        for name, call in (
                ("foreign", lambda: b.predict(
                    lgb.Dataset(X[::2], label=y[::2], params=p))),
                ("pred_leaf", lambda: b.predict(valid, pred_leaf=True))):
            try:
                call()
            except ValueError as exc:
                out[f"{name}_error"] = str(exc)
        return out
    raise ValueError(f"unknown run kind {kind!r}")


def _job_fileio(inp, spec):
    """fileio_run of the JAX package for every run of the spec."""
    import lightgbm_tpu as lgb

    out = {}
    for c, run in enumerate(spec["runs"]):
        for k, v in fileio_run(lgb, run, inp).items():
            out[f"{c}_{k}"] = np.asarray(v)
    return out


# ---- sparse train-time storage (tpu_sparse_threshold) ----------------------


def sparse_storage_run(lgb, inp, run):
    """lgb.train of `lgb` on the arrays X_<data>, y_<data> (and w_<data>
    where run["weight"]) of `inp`; run: params, rounds, and optionally
    cat (the Dataset's categorical columns).  Returns the model text,
    the training predictions' raw scores (the JAX package's on its
    device path), whether the learner stored sparse features and how
    many; or, where training raises, the exception's class name and
    message."""
    jax_side = lgb.__name__ != "lightgbm_tpu_torch"
    kw = {"tpu_predict_device": "true"} if jax_side else {}
    p = dict(run["params"])
    if not jax_side:
        p["device_type"] = "cpu"
    data = run.get("data", "base")
    X, y = inp[f"X_{data}"], inp[f"y_{data}"]
    w = inp[f"w_{data}"] if run.get("weight") else None
    try:
        ds = lgb.Dataset(X, label=y, weight=w,
                         categorical_feature=run.get("cat", "auto"),
                         params={"max_bin": p["max_bin"]})
        b = lgb.train(p, ds, num_boost_round=run["rounds"],
                      keep_training_booster=True)
    except Exception as exc:  # noqa: BLE001 - the type is the result
        return {"error": type(exc).__name__, "message": str(exc)}
    learner = b._driver.learner
    if jax_side:
        sparse = getattr(learner, "_sparse_mask", None)
        count = 0 if sparse is None else int(np.sum(sparse))
    else:
        count = (0 if learner.sparse is None
                 else len(learner.sparse["sparse_idx"]))
    return {"text": b.model_to_string(), "sparse_features": count,
            "raw": np.asarray(b.predict(X, raw_score=True, **kw))}


def _job_sparse_storage(inp, spec):
    """sparse_storage_run of the JAX package for every run of the spec."""
    import lightgbm_tpu as lgb

    out = {}
    for c, run in enumerate(spec["runs"]):
        for k, v in sparse_storage_run(lgb, inp, run).items():
            out[f"{c}_{k}"] = np.asarray(v)
    return out


# ---- the model utilities (init_model, snapshots, rollback, reset, refit) ---


def strip_mapper_trailer(text):
    """A model text without its `tpu_bin_mappers:` line (as upstream
    LightGBM writes it): loaded, it predicts through the raw-value
    walker."""
    return "".join(line for line in text.splitlines(True)
                   if not line.startswith("tpu_bin_mappers:"))


def utilities_run(lgb, inp, run, tmp):
    """One training case of tests/test_torch_utilities.py, the same
    script for either package (the JAX package's in the no-FMA process,
    job "utilities"): the model texts, score states and predictions the
    test compares."""
    import os

    jax_side = lgb.__name__ != "lightgbm_tpu_torch"
    p = dict(run["params"], verbosity=-1)
    if not jax_side:
        p["device_type"] = "cpu"
    X, y = inp["X_" + run["data"]], inp["y_" + run["data"]]
    n_tr = run.get("n_train", len(y))
    kind = run["kind"]
    tag = f"{run['name']}_{'jax' if jax_side else 'port'}"

    def dataset(a, b, **kw):
        return lgb.Dataset(a, label=b, params={"max_bin": p["max_bin"]},
                           **kw)

    def scores(b):
        d = b._driver
        return ([np.asarray(d.train_scores.numpy())]
                + [np.asarray(v.numpy()) for v in d.valid_scores])

    if kind == "continue":
        init = lgb.train(p, dataset(X[:n_tr], y[:n_tr]), run["init_rounds"])
        src = init
        if run["from"] == "path":
            src = os.path.join(tmp, f"init_{tag}.txt")
            init.save_model(src)
        train = dataset(X[:n_tr], y[:n_tr])
        evals = {}
        b = lgb.train(p, train, run["rounds"],
                      valid_sets=[train.create_valid(X[n_tr:], y[n_tr:])],
                      valid_names=["v"], init_model=src, evals_result=evals,
                      verbose_eval=False, keep_training_booster=True)
        train_scores, valid_scores = scores(b)
        return {"init_text": init.model_to_string(),
                "text": b.model_to_string(), "train_scores": train_scores,
                "valid_scores": valid_scores,
                "curve": np.asarray(evals["v"]["l2"]),
                "iteration": b.current_iteration()}
    if kind == "snapshot":
        out = os.path.join(tmp, f"snap_{tag}.txt")
        b = lgb.train(dict(p, snapshot_freq=run["freq"], output_model=out),
                      dataset(X, y), run["rounds"])
        res = {"text": b.model_to_string()}
        for i in range(run["freq"], run["rounds"] + 1, run["freq"]):
            with open(f"{out}.snapshot_iter_{i}") as f:
                res[f"snapshot_{i}"] = f.read()
            res[f"text_{i}"] = b.model_to_string(num_iteration=i)
        return res
    if kind == "rollback":
        train = dataset(X[:n_tr], y[:n_tr])
        b = lgb.Booster(params=p, train_set=train)
        b.add_valid(train.create_valid(X[n_tr:], y[n_tr:]), "v")
        for _ in range(run["rounds"]):
            b.update()
        before = scores(b)
        b.update()
        b.rollback_one_iter()
        after = scores(b)
        res = {"before_train": before[0], "before_valid": before[1],
               "after_train": after[0], "after_valid": after[1],
               "iteration": b.current_iteration(),
               "text_rolled": b.model_to_string()}
        b.update()
        res["text_next"] = b.model_to_string()
        return res
    if kind == "reset":
        sched = {k: list(v) for k, v in run["schedule"].items()}
        b = lgb.train(p, dataset(X, y), run["rounds"],
                      callbacks=[lgb.reset_parameter(**sched)],
                      keep_training_booster=True)
        b.reset_parameter(dict(run["then"]))
        b.update()
        return {"text": b.model_to_string()}
    if kind == "refit":
        b = lgb.train(p, dataset(X[:n_tr], y[:n_tr]), run["rounds"])
        res = {"text": b.model_to_string()}
        for decay in run["decays"]:
            r = b.refit(X[n_tr:], y[n_tr:], decay_rate=decay)
            res[f"refit_{decay}"] = r.model_to_string()
        return res
    if kind == "sklearn":
        kw = dict(p)
        kw.pop("objective", None)
        m = lgb.LGBMRegressor(n_estimators=run["rounds"], **kw).fit(X, y)
        return {"leaf": m.predict(X, pred_leaf=True),
                "contrib": m.predict(X[:run["contrib_rows"]],
                                     pred_contrib=True),
                "text": m.booster_.model_to_string()}
    if kind == "cat_continue":
        def cat_set():
            return dataset(X, y, categorical_feature=run["cat"])

        init = lgb.train(p, cat_set(), run["init_rounds"])
        b = lgb.train(p, cat_set(), 0, init_model=init,
                      keep_training_booster=True)
        return {"text": init.model_to_string(),
                "train_scores": scores(b)[0],
                "init_raw": init.predict(X, raw_score=True,
                                         tpu_predict_device=False)}
    if kind == "walk":
        b = lgb.train(p, dataset(X, y, categorical_feature=run["cat"]),
                      run["rounds"])
        return {"text": b.model_to_string()}
    raise ValueError(f"unknown utilities case {kind!r}")


def _job_utilities(inp, spec):
    """utilities_run of the JAX package for every run of the spec."""
    import tempfile

    import lightgbm_tpu as lgb

    tmp = tempfile.mkdtemp()
    out = {}
    for c, run in enumerate(spec["runs"]):
        for k, v in utilities_run(lgb, inp, run, tmp).items():
            out[f"{c}_{k}"] = np.asarray(v)
    return out


def _job_shap(inp, spec):
    """lgb.train of the JAX package for every run of
    tests/test_torch_shap.py: each model's text, and its SHAP
    contributions and raw scores on the run's predict rows."""
    import lightgbm_tpu as lgb

    out = {}
    for c, run in enumerate(spec["runs"]):
        X, y = inp["X_" + run["data"]], inp["y_" + run["data"]]
        ds = lgb.Dataset(X, label=y, categorical_feature=run.get("cat",
                                                                 "auto"),
                         params={"max_bin": run["params"]["max_bin"]})
        b = lgb.train(dict(run["params"], verbosity=-1), ds,
                      num_boost_round=run["rounds"])
        Xp = inp["Xp_" + run["data"]]
        out[f"{c}_text"] = np.array(b.model_to_string())
        out[f"{c}_contrib"] = b.predict(Xp, pred_contrib=True)
        out[f"{c}_raw"] = b.predict(Xp, raw_score=True,
                                    tpu_predict_device=False)
    return out


def model_text(b) -> str:
    """A model text without its parameters block, which names each run's
    checkpoint directory and device; the trees and the trailers stay."""
    text = b.model_to_string(num_iteration=-1)
    head, rest = text.split("\nparameters:", 1)
    return head + rest.split("end of parameters", 1)[1]


def fault_run(lgb, inp, run, tmp):
    """One case of tests/test_torch_fault_tolerance.py or
    tests/test_torch_membudget.py, the same script for either package
    (the JAX package's in the no-FMA process, job "fault"): model texts,
    checkpoint bundles written into `tmp`, captured train states, guard
    and ladder outcomes.  `run["from_dir"]` names another package's
    bundle directory to resume from (copied first: a resume writes on)."""
    import importlib
    import json
    import os
    import shutil

    jax_side = lgb.__name__ != "lightgbm_tpu_torch"
    pkg = "jax" if jax_side else "port"
    faultline = importlib.import_module(lgb.__name__ + ".utils.faultline")
    p = dict(run["params"], verbosity=-1)
    if not jax_side:
        p["device_type"] = "cpu"
    X, y, Xv, yv = inp["X"], inp["y"], inp["Xv"], inp["yv"]
    rounds = run.get("rounds", 6)
    kind = run["kind"]

    def train(params, n, **kw):
        ds = lgb.Dataset(X, label=y, params={"max_bin": p["max_bin"]})
        return lgb.train(params, ds, n, valid_sets=[ds.create_valid(
            Xv, label=yv)], valid_names=["v"], verbose_eval=False,
            keep_training_booster=True, **kw)

    def booster(params):
        ds = lgb.Dataset(X, label=y, params={"max_bin": p["max_bin"]})
        return lgb.Booster(params=params, train_set=ds)

    if kind == "full":
        return {"text": model_text(train(p, rounds))}
    if kind == "interrupt":
        # a run cut after `at` rounds, its bundle kept at that iteration,
        # and the train state it captured there
        d = os.path.join(tmp, f"{run['name']}_{pkg}")
        b = train(dict(p, tpu_checkpoint_dir=d), run["at"])
        shutil.copytree(d, d + "_at")
        state, arrays = b._driver.capture_train_state()
        out = {"dir": d + "_at", "state": json.dumps(state, sort_keys=True)}
        out.update({f"arr:{k}": v for k, v in arrays.items()})
        return out
    if kind == "resume":
        src = run["from_dir"]
        d = os.path.join(tmp, f"{run['name']}_{pkg}_resumed")
        shutil.copytree(src, d)
        b = train(dict(p, tpu_checkpoint_dir=d), rounds, resume=True)
        return {"text": model_text(b)}
    if kind == "guard":
        b = booster(dict(p, tpu_guard_numerics="skip"))
        faultline.reset()
        faultline.arm("grow_step", action="poison", at=run["poison_at"])
        try:
            for _ in range(rounds):
                b.update()
        finally:
            faultline.reset()
        return {"text": model_text(b),
                "skips": b._driver._guard_skips_total,
                "iteration": b.current_iteration()}
    if kind == "oom":
        b = booster(p)
        faultline.reset()
        try:
            for it in range(rounds):
                if it == run["oom_at"]:
                    faultline.arm("device_alloc", action="oom",
                                  times=run["times"])
                b.update()
        finally:
            faultline.reset()
        return {"text": model_text(b),
                "steps": json.dumps(b._driver._mem_ladder.describe())}
    raise ValueError(f"unknown fault case {kind!r}")


def _job_fault(inp, spec):
    """fault_run of the JAX package for every run of the spec."""
    import lightgbm_tpu as lgb

    out = {}
    for c, run in enumerate(spec["runs"]):
        for k, v in fault_run(lgb, inp, run, spec["tmp"]).items():
            out[f"{c}_{k}"] = np.asarray(v)
    return out


if __name__ == "__main__":
    import json
    import sys

    job, src, dst = sys.argv[1:4]
    with np.load(src) as f:
        inp = {k: f[k] for k in f.files}
    spec = json.loads(str(inp.pop("__spec__")))
    result = {"fused": _job_fused, "grow": _job_grow,
              "train": _job_train, "train_valid": _job_train_valid,
              "boosting": _job_boosting, "cat_split": _job_cat_split,
              "sklearn": _job_sklearn, "sparse": _job_sparse,
              "constraints": _job_constraints,
              "fileio": _job_fileio,
              "sparse_storage": _job_sparse_storage,
              "utilities": _job_utilities, "shap": _job_shap,
              "fault": _job_fault}[job](
                  inp, spec)
    np.savez(dst, **result)
