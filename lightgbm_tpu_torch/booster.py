"""The `Booster` front end (reference basic.py Booster).

The port of `lightgbm_tpu/booster.py:Booster`: update (with custom
gradients), validation sets and evaluation, `best_iteration`/
`best_score` (predict and model text default to the best iteration),
`reset_parameter` of any parameter, `rollback_one_iter`, `free_dataset`,
predict (`[n]`, or `[n, k]` for multiclass; `pred_leaf`, `pred_contrib`,
`pred_early_stop*` and `tpu_predict_device=false` through the
raw-value walker), `refit`, and the model surface: model text
and files in both directions (`model_to_string`, `save_model`,
`model_from_string`, `Booster(model_file=/model_str=)`, with the
`pandas_categorical:` line), `dump_model`, `trees_to_dataframe`,
`feature_importance`, `feature_name`, `num_feature`, predict on
DataFrames whose `category` columns remap through the model's
`pandas_categorical` tables,
`num_model_per_iteration`, `get_leaf_output`,
`get_split_value_histogram`, `attr`/`set_attr`, `shuffle_models`, and
copies and pickles through the model text.  The boosting driver follows
`boosting` (gbdt, goss, dart, rf: `models.create_boosting`).

Refused by name until their items are ported: checkpoints
(`save_checkpoint`, `resume_from_checkpoint`) and the network
(`set_network`, `free_network`).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .config import Config, canonical_name, parse_tristate, resolve_device


def _split_pandas_categorical(text: str):
    """(model text, pandas_categorical): the Python layer's last line of
    a saved model (lightgbm_tpu/booster.py:_split_pandas_categorical),
    so both packages' files interchange."""
    marker = "\npandas_categorical:"
    pos = text.rfind(marker)
    if pos < 0:
        return text, None
    payload = text[pos + len(marker):].split("\n", 1)[0].strip()
    try:
        pc = json.loads(payload) if payload else None
    except json.JSONDecodeError as exc:
        raise ValueError(
            f"corrupt pandas_categorical line in model: {payload[:80]!r}"
        ) from exc
    return text[:pos] + "\n", pc


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to lightgbm_tpu_torch "
                              "yet")


class Booster:
    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set=None, model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        from .basic import Dataset
        from .models import create_boosting
        from .models.gbdt import GBDT

        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._valid_names: List[str] = []
        self._train_data_name = "training"
        self._train_set = None
        self.pandas_categorical = None
        self._attr: Dict[str, str] = {}
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("train_set must be a Dataset")
            if train_set._inner is None:
                # training-level params that shape the dataset (max_bin,
                # device_type, ...) apply before the lazy construction
                train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            self._train_set = train_set
            cfg = Config(self.params)
            self._driver = create_boosting(cfg)
            self._driver.init(cfg, train_set._inner)
            self.pandas_categorical = train_set.pandas_categorical
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            model_str, self.pandas_categorical = \
                _split_pandas_categorical(model_str)
            self._driver = GBDT.from_model_string(
                model_str, resolve_device(Config(self.params)))
        else:
            raise ValueError("need train_set, model_file or model_str")

    @classmethod
    def _from_driver(cls, driver) -> "Booster":
        self = cls.__new__(cls)
        self.params = {}
        self.best_iteration = -1
        self.best_score = {}
        self._valid_names = []
        self._train_data_name = "training"
        self._train_set = None
        self.pandas_categorical = None
        self._attr = {}
        self._driver = driver
        return self

    # -- copies and pickles go through the model text (booster.py:101-130)
    def __copy__(self) -> "Booster":
        return self.__deepcopy__(None)

    def __deepcopy__(self, _memo) -> "Booster":
        out = Booster(params=self.params,
                      model_str=self.model_to_string(num_iteration=-1))
        out.best_iteration = self.best_iteration
        out._attr = dict(self._attr)
        return out

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_train_set", None)
        state.pop("_driver", None)
        state["_model_str"] = self.model_to_string(num_iteration=-1)
        return state

    def __setstate__(self, state):
        from .models.gbdt import GBDT

        model_str = state.pop("_model_str", None)
        self.__dict__.update(state)
        self._train_set = None
        self._driver = None
        if model_str is not None:
            model_str, pc = _split_pandas_categorical(model_str)
            self._driver = GBDT.from_model_string(
                model_str, resolve_device(Config(self.params)))
            if self.pandas_categorical is None:
                self.pandas_categorical = pc

    # -- attributes (reference basic.py Booster.attr/set_attr) ----------
    def attr(self, key: str) -> Optional[str]:
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        for key, value in kwargs.items():
            if value is None:
                self._attr.pop(key, None)
            elif isinstance(value, str):
                self._attr[key] = value
            else:
                raise ValueError("Only string values are accepted")
        return self

    # ------------------------------------------------------------------
    def add_valid(self, data, name: str) -> "Booster":
        data.construct()
        self._driver.add_valid(data._inner, name)
        self._valid_names.append(name)
        return self

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True once no further splits occur.
        fobj(scores [k, n] f64, train_set) -> (grad, hess) gives custom
        gradients, which train through the sync path."""
        if train_set is not None and train_set is not self._train_set:
            raise NotImplementedError(
                "update(train_set=...) with another dataset is not ported "
                "to lightgbm_tpu_torch yet")
        if fobj is None:
            return self._driver.train_one_iter()
        grad, hess = fobj(self._driver.current_score_for_fobj(),
                          self._train_set)
        return self._driver.train_one_iter(np.asarray(grad, np.float32),
                                           np.asarray(hess, np.float32))

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration (GBDT.rollback_one_iter; RF undoes its
        running average)."""
        self._driver.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self._driver.current_iteration()

    def num_trees(self) -> int:
        return self._driver.num_total_model()

    def num_model_per_iteration(self) -> int:
        return self._driver.num_tree_per_iteration

    def eval_train(self, feval=None) -> List[Tuple]:
        return self._driver.eval("training", -1, feval=feval)

    def eval_valid(self, feval=None) -> List[Tuple]:
        out: List[Tuple] = []
        for i, name in enumerate(self._valid_names):
            out.extend(self._driver.eval(name, i, feval=feval))
        return out

    def eval(self, data, name: str, feval=None) -> List[Tuple]:
        """Metrics on a dataset built with reference=the training set,
        without registering it as a validation set."""
        data.construct()
        return self._driver.eval_for_data(data._inner, name, feval=feval)

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Take new parameters between iterations: the learner and the
        train step are rebuilt from them (GBDT.reset_config)."""
        self.params.update(params)
        self._driver.reset_config(Config(self.params))
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def free_dataset(self) -> "Booster":
        """Drop the training and validation data (reference
        basic.py:1808): the model stays usable for predict and model
        text, further update()/eval calls need data and fail."""
        self._driver.free_dataset()
        self._train_set = None
        return self

    # ------------------------------------------------------------------
    def _default_iteration(self, num_iteration: Optional[int]) -> int:
        if num_iteration is None:
            return self.best_iteration if self.best_iteration >= 0 else -1
        return int(num_iteration)

    # the keywords of the JAX package's predict
    _PREDICT_KEYWORDS = ("predict_disable_shape_check", "tpu_predict_device",
                         "pred_early_stop", "pred_early_stop_freq",
                         "pred_early_stop_margin")

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """[n] outputs, or [n, k] for multiclass; `raw_score` skips the
        objective's output conversion.  `data` may be the path of a text
        file (the label column dropped where the file has one), or a
        constructed `Dataset` binned with reference= the training set,
        whose bins are walked as they are (`GBDT.predict_binned`).  A
        DataFrame's `category` columns
        map onto the training codes through the model's
        `pandas_categorical` tables; a scipy sparse matrix is densified
        65,536 rows at a time (`_predict_sparse_chunked`).  The columns
        must be the model's (`predict_disable_shape_check`, a parameter
        or a keyword, pads missing trailing ones with NaN and drops extra
        ones, as lightgbm_tpu/booster.py:predict does).  `pred_leaf`:
        [n, T] int32 leaf indices; `pred_contrib`: SHAP contributions,
        [n, F+1] or [n, k*(F+1)].  Keywords: `predict_disable_shape_check`,
        `tpu_predict_device` (over the booster's parameter, then the model
        text's: `false` takes the raw-value walker, `auto`/`true` the
        bin-space device walk where the model has its mappers) and
        `pred_early_stop` with `pred_early_stop_freq` and
        `pred_early_stop_margin` (the raw-value walker); other keywords
        raise by name."""
        from .basic import Dataset, _to_2d_array
        from .io.dataset import _is_scipy_sparse

        if isinstance(data, Dataset) and (
                pred_leaf or pred_contrib or kwargs.get("pred_early_stop")):
            raise ValueError("pred_leaf/pred_contrib/pred_early_stop "
                             "need raw data, not a Dataset (they run "
                             "on the native walker)")
        self._check_predict_kwargs(kwargs)
        it = self._default_iteration(num_iteration)
        if isinstance(data, Dataset):
            if self._host_predict(kwargs):
                raise TypeError(
                    "Cannot use Dataset instance for prediction on the "
                    "native path; pass raw data, or enable the device "
                    "predictor (device='tpu' with tpu_predict_device "
                    "not 'false')")
            # the dataset's bins, walked where they lie: no binning pass
            data.construct()
            return self._driver.predict_binned(data._inner, it,
                                               raw_score=raw_score)
        if _is_scipy_sparse(data):
            return self._predict_sparse_chunked(data, it, raw_score,
                                                pred_leaf, pred_contrib,
                                                kwargs)
        if isinstance(data, str):
            from .io.parser import load_text_file

            cfg = Config(self.params)
            X = load_text_file(data, label_column=cfg.label_column,
                               header=True if cfg.header else None)[0]
            # a file without a label column: read again with every
            # column a feature
            if X.shape[1] == self.num_feature() - 1:
                X = load_text_file(data, label_column=None,
                                   header=True if cfg.header else None)[0]
        else:
            X = _to_2d_array(data, self.pandas_categorical)
        n_feat = self.num_feature()
        if X.ndim == 2 and X.shape[1] != n_feat:
            self._check_predict_shape(X.shape[1], kwargs)
            if X.shape[1] < n_feat:
                # absent trailing features predict as missing
                X = np.concatenate([X, np.full(
                    (X.shape[0], n_feat - X.shape[1]), np.nan)], axis=1)
            else:
                X = X[:, :n_feat]
        return self._predict_rows(X, it, raw_score, pred_leaf, pred_contrib,
                                  kwargs)

    def _predict_rows(self, X, num_iteration: int, raw_score: bool,
                      pred_leaf: bool, pred_contrib: bool, kwargs):
        """GBDT.predict of raw rows with the keywords read."""
        return self._driver.predict(
            X, num_iteration, raw_score=raw_score, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib,
            pred_early_stop=bool(kwargs.get("pred_early_stop", False)),
            pred_early_stop_freq=int(kwargs.get("pred_early_stop_freq", 10)),
            pred_early_stop_margin=float(
                kwargs.get("pred_early_stop_margin", 10.0)),
            host=self._host_predict(kwargs))

    def _host_predict(self, kwargs) -> bool:
        """tpu_predict_device=false: the keyword, else this booster's
        parameter, else the model's (its training parameters, or its
        model text's)."""
        if "tpu_predict_device" in kwargs:
            return parse_tristate(kwargs["tpu_predict_device"]) == "false"
        given = [v for k, v in self.params.items()
                 if canonical_name(str(k)) == "tpu_predict_device"]
        if given:
            return parse_tristate(given[-1]) == "false"
        return self._driver.host_predict()

    def _check_predict_kwargs(self, kwargs) -> None:
        """Refuse by name a keyword predict does not read (see predict)."""
        for key in kwargs:
            if key not in self._PREDICT_KEYWORDS:
                raise NotImplementedError(
                    f"predict({key}=...) is not ported to lightgbm_tpu_torch "
                    "yet")

    def _check_predict_shape(self, ncols: int, kwargs) -> None:
        """Raise on a feature-count mismatch unless
        predict_disable_shape_check (the keyword over the parameter) is
        set (lightgbm_tpu/booster.py:_check_predict_shape, its message
        word for word)."""
        from .config import _parse_bool
        from .utils.log import LightGBMError

        if _parse_bool(kwargs.get(
                "predict_disable_shape_check",
                Config(self.params).predict_disable_shape_check)):
            return
        raise LightGBMError(
            f"The number of features in data ({ncols}) is not the same as "
            f"it was in training data ({self.num_feature()}).\n"
            "You can set ``predict_disable_shape_check=true`` to discard "
            "this error, but please be aware what you are doing.")

    def _predict_sparse_chunked(self, data, num_iteration: int,
                                raw_score: bool, pred_leaf: bool,
                                pred_contrib: bool, kwargs,
                                chunk_rows: int = 65536) -> np.ndarray:
        """Predict a scipy sparse matrix in dense row chunks
        (lightgbm_tpu/booster.py:_predict_sparse_chunked): every output
        is n-first, so the chunks concatenate on axis 0, and the host
        holds one [chunk_rows, F] f64 block at a time, never the whole
        densified matrix.  Extra columns are dropped while the matrix is
        sparse; missing ones are NaN in each chunk."""
        n_feat = self.num_feature()
        if data.shape[1] != n_feat:
            self._check_predict_shape(data.shape[1], kwargs)
        rows = data.tocsr()
        if rows.shape[1] > n_feat:
            rows = rows[:, :n_feat]
        outs = []
        for lo in range(0, max(rows.shape[0], 1), chunk_rows):
            chunk = np.asarray(rows[lo:lo + chunk_rows].todense(),
                               dtype=np.float64)
            if chunk.shape[1] < n_feat:
                chunk = np.concatenate([chunk, np.full(
                    (chunk.shape[0], n_feat - chunk.shape[1]), np.nan)],
                    axis=1)
            outs.append(self._predict_rows(chunk, num_iteration, raw_score,
                                           pred_leaf, pred_contrib, kwargs))
        return np.concatenate(outs, axis=0)

    # -- model text ------------------------------------------------------
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        """The model text, ending, as the JAX package's and the reference
        package's do, with the Python layer's `pandas_categorical:` line
        (`null` for non-pandas training data)."""
        return self._driver.save_model_to_string(
            self._default_iteration(num_iteration),
            start_iteration) + "\npandas_categorical:" \
            + json.dumps(self.pandas_categorical) + "\n"

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration))
        return self

    def model_from_string(self, model_str: str, verbose: bool = True
                          ) -> "Booster":
        """Replace this booster's model in place from a model string."""
        from .models.gbdt import GBDT

        model_str, self.pandas_categorical = \
            _split_pandas_categorical(model_str)
        self._driver = GBDT.from_model_string(
            model_str, resolve_device(Config(self.params)))
        self._train_set = None
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict:
        """The model as JSON-able dicts (gbdt.py:dump_model)."""
        return self._driver.dump_model(self._default_iteration(num_iteration),
                                       start_iteration)

    # -- introspection ---------------------------------------------------
    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Splits ("split") or summed gains ("gain") per feature."""
        return self._driver.feature_importance(importance_type)

    def feature_name(self) -> List[str]:
        return list(self._driver.feature_names)

    def num_feature(self) -> int:
        return self._driver.max_feature_idx + 1

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        self._driver._materialize()
        return float(self._driver.models[tree_id].leaf_value[leaf_id])

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        self._driver.shuffle_models(start_iteration, end_iteration)
        return self

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """Histogram of this feature's split thresholds over all trees
        (lightgbm_tpu/booster.py:364)."""
        model = self.dump_model()
        feature_names = model["feature_names"]

        def want(split_feature) -> bool:
            if isinstance(feature, str):
                return (feature_names is not None
                        and feature_names[split_feature] == feature)
            return split_feature == feature

        values: List[float] = []

        def walk(node):
            if "split_index" in node:
                if want(node["split_feature"]):
                    if node["decision_type"] == "==":
                        raise ValueError(
                            "cannot compute a split value histogram for a "
                            "categorical feature")
                    values.append(float(node["threshold"]))
                walk(node["left_child"])
                walk(node["right_child"])

        for t in model["tree_info"]:
            walk(t["tree_structure"])
        if bins is None or (isinstance(bins, int)
                            and bins > len(set(values))
                            and xgboost_style):
            bins = max(len(set(values)), 1)
        hist, edges = np.histogram(values, bins=bins)
        if not xgboost_style:
            return hist, edges
        import pandas as pd

        mask = hist != 0
        return pd.DataFrame(np.column_stack([edges[1:][mask], hist[mask]]),
                            columns=["SplitValue", "Count"])

    def trees_to_dataframe(self):
        """Every tree's nodes as one pandas DataFrame
        (lightgbm_tpu/booster.py:408, the same columns)."""
        import pandas as pd

        if self.num_trees() == 0:
            raise ValueError("no trees to parse")
        model = self.dump_model()
        feature_names = model["feature_names"]
        rows: List[Dict[str, Any]] = []

        def node_index(node, ti):
            if "split_index" in node:
                return f"{ti}-S{node['split_index']}"
            return f"{ti}-L{node.get('leaf_index', 0)}"

        def walk(node, ti, depth, parent):
            is_split = "split_index" in node
            row = {"tree_index": ti, "node_depth": depth,
                   "node_index": node_index(node, ti), "left_child": None,
                   "right_child": None, "parent_index": parent,
                   "split_feature": None, "split_gain": None,
                   "threshold": None, "decision_type": None,
                   "missing_direction": None, "missing_type": None,
                   "value": None, "weight": None, "count": None}
            if is_split:
                f = node["split_feature"]
                row.update(
                    left_child=node_index(node["left_child"], ti),
                    right_child=node_index(node["right_child"], ti),
                    split_feature=(feature_names[f] if feature_names
                                   else f),
                    split_gain=node["split_gain"],
                    threshold=node["threshold"],
                    decision_type=node["decision_type"],
                    missing_direction=("left" if node["default_left"]
                                       else "right"),
                    missing_type=node["missing_type"],
                    value=node["internal_value"],
                    weight=node["internal_weight"],
                    count=node["internal_count"])
            else:
                row.update(value=node["leaf_value"],
                           weight=node.get("leaf_weight"),
                           count=node.get("leaf_count"))
            rows.append(row)
            if is_split:
                me = row["node_index"]
                walk(node["left_child"], ti, depth + 1, me)
                walk(node["right_child"], ti, depth + 1, me)

        for t in model["tree_info"]:
            walk(t["tree_structure"], t["tree_index"], 1, None)
        return pd.DataFrame(rows)

    def refit(self, data, label, decay_rate: float = 0.9) -> "Booster":
        """A new Booster with every tree's leaf values refit on `data`
        (lightgbm_tpu/booster.py:473-486, GBDT.refit)."""
        from .basic import _to_2d_array

        X = _to_2d_array(data, self.pandas_categorical)
        out = Booster(model_str=self._driver.save_model_to_string(),
                      params=self.params)
        out.pandas_categorical = self.pandas_categorical
        out._driver.refit(X, np.asarray(label), decay_rate,
                          config=Config(self.params) if self.params else None)
        return out

    # -- refused by name until their items are ported --------------------
    def save_checkpoint(self, directory: str, keep: int = 3) -> str:
        _not_ported("Booster.save_checkpoint")

    def resume_from_checkpoint(self, directory: str) -> Optional[int]:
        _not_ported("Booster.resume_from_checkpoint")

    def set_network(self, machines: str, local_listen_port: int = 12400,
                    listen_time_out: int = 120, num_machines: int = 1
                    ) -> "Booster":
        _not_ported("Booster.set_network")

    def free_network(self) -> "Booster":
        _not_ported("Booster.free_network")
