"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one, with the same module layout and the
same parameters: `lgb.train(params, Dataset(X, y), num_boost_round)` then
`booster.predict(X)`, with every objective and metric of the JAX package
(multiclass, and ranking on query groups, included), validation sets,
callbacks, early stopping, custom objectives and metrics, bagging,
feature_fraction and feature_fraction_bynode, the boosting modes gbdt,
goss, dart and rf, `lgb.cv`, categorical features (by index or name, and
pandas `category` columns), the booster's model files, dumps and
importances, the scikit-learn wrappers (`LGBMRegressor`,
`LGBMClassifier`, `LGBMRanker`), CSV/TSV/LibSVM files with two-round
loading and the binary cache, and sparse train-time storage
(`tpu_sparse_threshold`).  Entry points run on the first CUDA
device unless the params say `device_type="cpu"`; without CUDA and
without that, they raise.  The hot kernels are hand-written CUDA C++ for Hopper
(`csrc/`), built with `nvcc` at first use.  This package never imports
JAX or lightgbm_tpu.
"""

from . import callback
from .version import __version__
from .basic import Dataset
from .booster import Booster
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       print_evaluation, record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .utils.log import LightGBMError

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "LightGBMError", "callback", "early_stopping", "log_evaluation",
           "print_evaluation", "record_evaluation", "reset_parameter",
           "cv", "train", "__version__"]

try:  # the sklearn wrappers, as the JAX package exports them
    from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
    __all__ += ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]
except ImportError:  # pragma: no cover
    pass
