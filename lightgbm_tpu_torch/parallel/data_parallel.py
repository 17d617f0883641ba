"""Data-parallel tree growth: row shards and a histogram aggregation over
the row axes.

The port of `lightgbm_tpu/parallel/data_parallel.py`.  The reference
DataParallelTreeLearner (src/treelearner/data_parallel_tree_learner.cpp:
149-163) reduce-scatters its histograms so that each machine owns a
feature block, then syncs the best split; `tpu_hist_agg=scatter` is that
form, and `psum` gives every shard the whole aggregate, so that each runs
the identical search.  Kept as a thin alias of the 'data' strategy of
`parallel/strategies.py`, so callers of this name run the learner's own
path.
"""

from __future__ import annotations

from ..ops.grower import GrowerParams
from .strategies import make_strategy_grower
from .topology import Topology


def make_data_parallel_grower(params: GrowerParams, topology: Topology):
    """The whole-tree grower sharded over the row axes: row vectors in,
    the leaf ids of the row shards put back together in row order out
    (`StrategyGrower`)."""
    return make_strategy_grower(params, "data", topology)
