"""The parallel tree learners over the (hosts, data, feature) grid, in one
process (the port of `lightgbm_tpu/parallel/`)."""
from .mesh import shard_rows
from .data_parallel import make_data_parallel_grower
from .strategies import (make_strategy_grower, resolve_tree_learner,
                         bins_sharding, rows_sharding)
