"""DART boosting (reference src/boosting/dart.hpp).

The port of `lightgbm_tpu/models/dart.py`.  Each iteration drops a
random subset of the earlier trees (weighted by tree weight unless
uniform_drop; the numpy generator of drop_seed, in the JAX package's
draw order), takes the objective's gradients on the scores without them,
grows the new tree with shrinkage lr/(1+k) (lr/(lr+k) in
xgboost_dart_mode), then scales the dropped trees by k/(k+1) (k/(k+lr))
and adds them back (dart.hpp:58-139 DroppingTrees, :97 Normalize).

The drop and the restore walk the listed trees over the binned train and
validation sets on the device, summed per row in f64 in list order and
cast to f32 once (`GBDT._score_trees_binned`), as the JAX package's
binned walker sums them.  Gradients and growth take the sync step.

`rollback_one_iter` is GBDT's, as in the JAX package: it undoes no
drop or normalization.  The atomic-iteration rollback's hooks
(`_snapshot_extra`, `_restore_extra`) and the checkpoint hooks of the
JAX class are not ported.  With an init model, the drop set indexes the
trees after its iterations (dart.py:80-88, 121).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .gbdt import GBDT


class DART(GBDT):
    def init(self, config, train_data) -> None:
        super().init(config, train_data)
        self._drop_rng = np.random.default_rng(int(config.drop_seed))
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self._drop_idx: List[int] = []

    def _make_train_step(self) -> None:
        # the drop set changes the scores every iteration: the sync step
        self._step = None

    def reset_config(self, config) -> None:
        super().reset_config(config)
        self._drop_rng = np.random.default_rng(int(config.drop_seed))
        self.sum_weight = 0.0

    # ------------------------------------------------------------------
    def _apply_iters_to_scores(self, iters, sign: float) -> None:
        """Add sign * the listed iterations' trees to every score vector:
        one walk of the whole set per class and dataset."""
        if not iters:
            return
        K = self.num_tree_per_iteration
        for k in range(K):
            trees = [self.models[i * K + k] for i in iters
                     if self.models[i * K + k].num_leaves > 1]
            if not trees:
                continue
            scales = [sign] * len(trees)
            self.train_scores.add(k, self._score_trees_binned(
                self.train_data.bins_t, trees, scales))
            for vs, vd in zip(self.valid_scores, self.valid_sets):
                vs.add(k, self._score_trees_binned(vd.bins_t, trees, scales))

    def _dropping_trees(self) -> None:
        """Select the dropped trees and take them out of the scores
        (dart.hpp:97-139)."""
        cfg = self.config
        self._drop_idx = []
        if self._drop_rng.random() >= float(cfg.skip_drop):
            drop_rate = float(cfg.drop_rate)
            max_drop = int(cfg.max_drop)
            if not cfg.uniform_drop:
                if self.sum_weight > 0:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if max_drop > 0:
                        drop_rate = min(drop_rate,
                                        max_drop * inv_avg / self.sum_weight)
                    for i in range(self.iter_):
                        if self._drop_rng.random() < \
                                drop_rate * self.tree_weight[i] * inv_avg:
                            self._drop_idx.append(
                                self.num_init_iteration + i)
                            if max_drop > 0 \
                                    and len(self._drop_idx) >= max_drop:
                                break
            else:
                if max_drop > 0 and self.iter_ > 0:
                    drop_rate = min(drop_rate, max_drop / float(self.iter_))
                for i in range(self.iter_):
                    if self._drop_rng.random() < drop_rate:
                        self._drop_idx.append(self.num_init_iteration + i)
                        if max_drop > 0 and len(self._drop_idx) >= max_drop:
                            break
        self._apply_iters_to_scores(self._drop_idx, -1.0)
        k = float(len(self._drop_idx))
        lr = float(cfg.learning_rate)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = lr / (1.0 + k)
        else:
            self.shrinkage_rate = lr if not self._drop_idx else lr / (lr + k)

    def _normalize(self) -> None:
        """Scale the dropped trees and add them back (dart.hpp:152-196)."""
        cfg = self.config
        k = float(len(self._drop_idx))
        if k == 0:
            return
        lr = float(cfg.learning_rate)
        scale = k / (k + 1.0) if not cfg.xgboost_dart_mode else k / (k + lr)
        K = self.num_tree_per_iteration
        for i in self._drop_idx:
            for c in range(K):
                self.models[i * K + c].apply_shrinkage(scale)
            if not cfg.uniform_drop:
                j = i - self.num_init_iteration
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[j] / (k + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[j] / (k + lr)
                self.tree_weight[j] *= scale
        # leaf values changed in place: the cached device forest is stale
        self._invalidate_tables()
        self._apply_iters_to_scores(self._drop_idx, 1.0)

    def _train_one_iter_impl(self, grad, hess) -> bool:
        self._materialize()
        self._dropping_trees()
        if self._train_one_iter_sync(grad, hess):
            # stalled: the dropped trees go back unscaled, so the scores
            # stay those of the unchanged model
            self._apply_iters_to_scores(self._drop_idx, 1.0)
            self._drop_idx = []
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False
