"""One rank of the two-process runs of tests/test_torch_multiprocess.py.

Started as ``python -c "from tests.torch_mp_worker import main; main()"
SPEC.json`` with LIGHTGBM_TPU_PROCESS_ID set; imports torch, numpy and
lightgbm_tpu_torch only (it asserts that JAX never loads), runs every
case of the spec in order on the CPU and writes one JSON result a rank
(``rank<k>.json``, rewritten after each case so a failed run shows how
far it got).  The cases, in order:

* ``network``: `Booster.set_network` joins the group (the rendezvous),
  a sharded train across the two processes, `free_network`;
* ``grid``: every learner of the spec over the full data on both ranks
  (on the spec's device, the CPU by default), with its launch counts;
* ``prepart``: `pre_partition` runs, each rank holding its own rows
  (distributed binning), their mappers and texts;
* ``metric_sync``: a partitioned validation set with early stopping;
* ``checkpoint``: a run that commits a checkpoint group;
* ``failure``: `host_drop` armed on rank 1; both ranks raise.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# tests/test_torch_util.py:model_text, bound in main() (that module
# imports numpy alone)
model_text = None

BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 5,
        "tpu_block_rows": 512, "tpu_hist_impl": "xla",
        "tpu_shape_buckets": 0, "verbosity": -1}
INT8 = dict(BASE, objective="regression", tpu_hist_precision="int8",
            tpu_quant_refit_leaves=False)
# the deadline of every collective of the workers, and of their group
# (wide: the tier-1 run loads the host with other test processes)
TIMEOUT_S = 120.0


def problem(n=4096, f=10, seed=7, nan=False):
    """The regression and binary problems of the grid (the data of
    tests/test_torch_parallel.py).  nan: 5% NaNs in every feature, for
    the float runs: without a missing value the two missing directions
    tie, and a float tie can flip default_left between the packages."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y_bin = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float64)
    y_reg = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    if nan:
        X = X.copy()
        X[np.random.default_rng(11).random(X.shape) < 0.05] = np.nan
    return X, y_bin, y_reg


def efb_problem(n=4096, seed=2):
    """Four dense features and eight exclusive one-hot ones, which EFB
    bundles (regression label)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    hot = np.eye(8)[rng.integers(0, 8, n)] * rng.integers(1, 4,
                                                          size=(n, 1))
    X = np.hstack([X, hot])
    y = X[:, 0] + 0.7 * X[:, 4] - X[:, 6] + 0.1 * rng.normal(size=n)
    return X, y, y


def grid_data(name):
    """(X, binary label, regression label) of a grid run by its name."""
    if "efb" in name:
        return efb_problem()
    return problem(nan=name.endswith("hilo"))


def valid_problem(n=2000, f=10, seed=9):
    """The binary problem of the metric-sync case: training rows and a
    validation set, each split between the ranks."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.7 * X[:, 1] - 0.4 * X[:, 2] * X[:, 3]
         + 0.8 * rng.normal(size=n) > 0).astype(np.float64)
    return X, y


def _train(lgb, params, X, y, rounds, **kw):
    return lgb.train(params, lgb.Dataset(X, label=y, params=params), rounds,
                     keep_training_booster=True, **kw)


def _case_network(lgb, spec, out):
    X, _, y = problem()
    seed = lgb.Booster(params=dict(BASE, device_type="cpu",
                                   tpu_collective_timeout_s=TIMEOUT_S),
                       train_set=lgb.Dataset(X[:200], label=y[:200]))
    t0 = time.perf_counter()
    assert seed.set_network(spec["machines"], num_machines=4) is seed
    rendezvous_s = time.perf_counter() - t0
    net = {k: seed.params[k] for k in ("machines", "num_machines")}
    p = dict(INT8, device_type="cpu", tree_learner="data", **net)
    text = model_text(_train(lgb, p, X, y, spec["rounds"]))
    seed.free_network()
    out["network"] = {"text": text, "rendezvous_s": rendezvous_s,
                      "freed": "machines" not in seed.params}


def _case_grid(lgb, spec, out):
    from lightgbm_tpu_torch.ops import kernels

    res = {}
    dev = spec.get("device", "cpu")
    for name, params in spec["grid"].items():
        p = dict(params, device_type=dev, machines=spec["machines"])
        X, yb, yr = grid_data(name)
        y = yb if p.get("objective") == "binary" else yr
        kernels.reset_launches()
        b = _train(lgb, p, X, y, spec["rounds"])
        lrn = b._driver.learner
        st = lrn._strategy_grow.last_stats
        res[name] = {"text": model_text(b),
                     "launches": dict(kernels.launches),
                     "bundled": lrn.bundle_plan is not None,
                     "full": b.model_to_string(num_iteration=-1),
                     "raw": b.predict(X, raw_score=True).tolist(),
                     "local_shards": lrn.topology.local_size,
                     "proc_collectives": st["proc_collectives"],
                     "proc_bytes": st["proc_bytes"]}
    out["grid"] = res


def _case_prepart(lgb, spec, out, rank):
    from lightgbm_tpu_torch.parallel import topology

    res = {}
    for name, cut in spec["prepart"].items():
        X, _, y = grid_data(name)
        p = dict(INT8, device_type="cpu", tree_learner="data",
                 num_machines=4, machines=spec["machines"],
                 pre_partition=True, **spec.get("prepart_params", {})
                 .get(name, {}))
        rows = slice(0, cut) if rank == 0 else slice(cut, len(y))
        ds = lgb.Dataset(X[rows], label=y[rows], params=p)
        b = lgb.train(p, ds, spec["rounds"], keep_training_booster=True)
        res[name] = {"text": model_text(b),
                     "bundled": b._driver.learner.bundle_plan is not None,
                     "mappers": [m.to_dict() for m in ds._inner.mappers],
                     "partitioned": topology.rows_partitioned(),
                     "rows": int(ds._inner.num_data)}
    out["prepart"] = res


def _case_metric_sync(lgb, spec, out, rank):
    X, y = valid_problem()
    Xv, yv = valid_problem(n=1200, seed=10)
    half, vhalf = len(y) // 2, 700
    rows = slice(0, half) if rank == 0 else slice(half, len(y))
    vrows = slice(0, vhalf) if rank == 0 else slice(vhalf, len(yv))
    p = dict(BASE, objective="binary", metric=["binary_logloss", "auc"],
             tpu_hist_precision="int8", device_type="cpu",
             tree_learner="data", num_machines=2,
             machines=spec["machines"], pre_partition=True,
             learning_rate=0.5, num_leaves=31, min_data_in_leaf=2)
    ds = lgb.Dataset(X[rows], label=y[rows], params=p)
    vs = lgb.Dataset(Xv[vrows], label=yv[vrows], reference=ds, params=p)
    ev = {}
    b = lgb.train(p, ds, 12, valid_sets=[vs], valid_names=["v"],
                  evals_result=ev, early_stopping_rounds=2,
                  keep_training_booster=True)
    n_iter = len(ev["v"]["auc"])
    raw = b.predict(Xv, raw_score=True, num_iteration=n_iter)
    prob = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1 - 1e-15)
    ll = float(-np.mean(np.where(yv > 0, np.log(prob), np.log(1 - prob))))
    order = np.argsort(raw, kind="stable")
    ranks = np.empty(len(raw))
    ranks[order] = np.arange(1, len(raw) + 1)
    pos = yv > 0
    auc = float((ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2)
                / (pos.sum() * (~pos).sum()))
    out["metric_sync"] = {"curve_ll": ev["v"]["binary_logloss"],
                          "curve_auc": ev["v"]["auc"],
                          "best_iter": int(b.best_iteration),
                          "n_iter": n_iter, "expected_ll": ll,
                          "expected_auc": auc}


def _case_checkpoint(lgb, spec, out):
    X, _, y = problem()
    p = dict(INT8, device_type="cpu", tree_learner="data", num_machines=4,
             machines=spec["machines"],
             tpu_checkpoint_dir=spec["ckpt_dir"])
    b = _train(lgb, p, X, y, spec["ckpt_rounds"])
    out["checkpoint"] = {"text": model_text(b)}


def _case_failure(lgb, spec, out):
    from lightgbm_tpu_torch.utils import faultline

    X, _, y = problem()
    p = dict(INT8, device_type="cpu", tree_learner="data", num_machines=4,
             machines=spec["machines"])
    # rank 1 drops at its third host-level collective from here
    faultline.arm("host_drop", action="raise", host=1, at=3)
    t0 = time.perf_counter()
    try:
        _train(lgb, p, X, y, spec["rounds"])
        out["failure"] = {"raised": None}
    except Exception as exc:  # noqa: BLE001 - reported to the test
        out["failure"] = {"raised": type(exc).__name__,
                          "message": str(exc)[:400],
                          "seconds": time.perf_counter() - t0}


def main() -> None:
    spec_path = sys.argv[1]
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["LIGHTGBM_TPU_PROCESS_ID"])
    sys.path.insert(0, spec["root"])
    import lightgbm_tpu_torch as lgb

    global model_text
    from tests.test_torch_util import model_text

    out = {"rank": rank}
    dst = os.path.join(spec["out"], f"rank{rank}.json")

    def flush():
        out["jax_loaded"] = any(m == "jax" or m.startswith("jax.")
                                or m.startswith("lightgbm_tpu.")
                                or m == "lightgbm_tpu"
                                for m in sys.modules)
        with open(dst + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(dst + ".tmp", dst)

    t0 = time.perf_counter()
    for case in spec["cases"]:
        t = time.perf_counter()
        if case == "network":
            _case_network(lgb, spec, out)
        elif case == "grid":
            _case_grid(lgb, spec, out)
        elif case == "prepart":
            _case_prepart(lgb, spec, out, rank)
        elif case == "metric_sync":
            _case_metric_sync(lgb, spec, out, rank)
        elif case == "checkpoint":
            _case_checkpoint(lgb, spec, out)
        elif case == "failure":
            _case_failure(lgb, spec, out)
        out.setdefault("seconds", {})[case] = time.perf_counter() - t
        flush()
    out["total_s"] = time.perf_counter() - t0
    flush()
    sys.stdout.flush()
    sys.stderr.flush()
    # the group is broken after the failure case: leave without tearing
    # it down
    os._exit(0)
