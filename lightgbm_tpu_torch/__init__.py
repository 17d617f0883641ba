"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one, with the same module layout and the
same parameters: `lgb.train(params, Dataset(X, y), num_boost_round)` then
`booster.predict(X)`.  Entry points run on the first CUDA device unless
the params say `device_type="cpu"`; without CUDA and without that, they
raise.  The hot kernels are hand-written CUDA C++ for Hopper
(`csrc/`), built with `nvcc` at first use.  This package never imports
JAX or lightgbm_tpu.
"""

from .basic import Dataset
from .booster import Booster
from .config import Config
from .engine import train

__all__ = ["Booster", "Config", "Dataset", "train"]
