#!/usr/bin/env python3
"""The forest walk of one predict chunk, grouped against one pass, on the
card: time and the allocator's peak.

    python3 probes/predict_walk.py

`ops/predict.py:class_scores` walks the trees WALK_GROUP at a time
(ROADMAP §C7); before it walked every tree at once, making every [T,
rows] plane of a step together (`walk_step_bytes`: 131 bytes a row a
tree).  On a 65,536-row chunk of the Higgs-1M shape (`chip_smoke.py`'s
generator, seed 42) and forests of 10, 50, 250 and 1,000 trees (a
trained int8 booster of 250 trees, 255 leaves, its trees repeated past
250), one JSON line a forest: both walks' mean ms by CUDA events, each
walk's peak bytes above the chunk's bins and tables, the plan's
`forest_walk_bytes` and `walk_step_bytes` at the forest's tree count,
and whether the two give the same bits (they must).
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

ROWS = 65536
TRAIN_ROWS = 200_000
TRAINED = 250
FORESTS = (10, 50, 250, 1000)
REPS = 5


def main() -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this probe needs a "
                "card")
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import predict as P

    print(cs.smi_line(), flush=True)
    X, y = cs.make_data(TRAIN_ROWS, cs.N_FEAT)
    p = dict(cs.PARAMS, tpu_hist_precision="int8")
    b = lgb.train(p, lgb.Dataset(X, label=y, params=p), TRAINED,
                  keep_training_booster=True)
    drv = b._driver
    drv._materialize()
    models = list(drv.models)
    dev = drv.device
    meta = drv._pred_ctx.meta_dev(dev)
    bins_t = drv._pred_ctx.bin_rows_t(X[:ROWS], dev, {"chunk_bytes": 0})
    for T in FORESTS:
        trees = (models * (-(-T // len(models))))[:T]
        packed, depth = P.pack_trees(trees)
        tables = P.device_tables(packed, dev)

        def grouped():
            return P.class_scores(tables, bins_t, meta, 1, depth)

        def one_pass():
            vals = torch.gather(tables["leaf_value"], 1,
                                P.leaf_index(tables, bins_t, *meta, depth))
            return P.sum_trees(vals)[None]

        row = {"trees": T, "rows": ROWS, "depth": depth}
        outs = {}
        for name, fn in (("grouped", grouped), ("one_pass", one_pass)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            outs[name] = fn()
            torch.cuda.synchronize()
            row[f"{name}_peak_bytes"] = \
                torch.cuda.max_memory_allocated(dev) - base
            row[f"{name}_ms"] = cs.cuda_ms(fn, REPS)
        row["bitwise"] = bool(torch.equal(outs["grouped"], outs["one_pass"]))
        row["plan_forest_walk_bytes"] = P.forest_walk_bytes(
            T, 1, ROWS, bins_t.element_size())
        row["one_pass_walk_step_bytes"] = P.walk_step_bytes(
            T, ROWS, bins_t.element_size())
        print("walk " + json.dumps(row), flush=True)
        if not row["bitwise"]:
            cs.fail(f"the grouped walk of {T} trees differs from one pass")
        del outs, tables


if __name__ == "__main__":
    main()
