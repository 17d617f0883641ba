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
               mds=0.0, min_data=5.0, bag=0.0, bins=None):
    """Seeded numpy operands of the grow megakernel (B2): quantized
    stats, leaf ids, K slots (some dead), parent histograms, the ctx rows
    with both sibling choices and consistent child totals, mixed missing
    types and bin counts, a penalized and a masked feature.  With bag > 0
    (bagged operands) about that share of the rows has zero stats and
    of the features is masked, drawn from a generator of their own.
    The bins are uint8 up to 256 bins and int32 (wide) above; `bins`
    ([F, n]) replaces the random ones.
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
    the run's query sizes, `group`, where it has them):
    (the result dict without the boosters as JSON, each fold booster's
    raw scores of X or None)."""
    import json

    p = dict(run["params"])
    res = lgb.cv(p, lgb.Dataset(X, label=y, group=run.get("group"),
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


def _job_boosting(inp, spec):
    """Runs of several kinds in one process: "train_valid"
    (train_valid_run), "goss_kept" (goss_kept_jax), "cv" (cv_run), "zoo"
    (zoo_run), "booster_io" (booster_io_run) and "load_predict" (a model text loaded and its raw scores of the rows
    of X from `start` on, on the device path)."""
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
        elif kind == "load_predict":
            b = lgb.Booster(model_str=run["text"])
            out[f"{c}_raw"] = np.asarray(b.predict(
                X[run.get("start", 0):], raw_score=True,
                tpu_predict_device="true"))
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
              "boosting": _job_boosting}[job](
                  inp, spec)
    np.savez(dst, **result)
