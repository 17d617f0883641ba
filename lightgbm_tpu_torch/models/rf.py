"""Random forest mode (reference src/boosting/rf.hpp).

The port of `lightgbm_tpu/models/rf.py`: bagging is required, there is
no shrinkage, the gradients are computed once, from the constant
boost-from-average scores (rf.hpp:84-103), and the train and validation
scores are the running average of the trees' outputs, each step in f32:
times the iteration count, plus the new tree's binned output, times
1/(count+1) (rf.hpp:146-149).  Predict divides the sum over trees by
their count, and the model text carries the bare `average_output` line.

`rollback_one_iter` undoes the running average of the last iteration
(rf.py:125-149).  The atomic iteration needs no hook of its own: the
running average lives in the score buffers, which the snapshot holds.
"""

from __future__ import annotations

import numpy as np
import torch

from .gbdt import GBDT, K_EPSILON
from .tree import Tree


class RF(GBDT):
    def init(self, config, train_data) -> None:
        if not (int(config.bagging_freq) > 0
                and 0.0 < float(config.bagging_fraction) < 1.0):
            raise ValueError(
                "random forest requires bagging "
                "(bagging_freq > 0 and bagging_fraction in (0, 1))")
        if not 0.0 < float(config.feature_fraction) <= 1.0:
            raise ValueError("feature_fraction must be in (0, 1] for RF")
        super().init(config, train_data)
        if self.objective is None:
            raise ValueError("RF mode does not support custom objectives")
        self.average_output = True
        self.shrinkage_rate = 1.0
        # the gradients of the constant init scores, once, on the device
        K = self.num_tree_per_iteration
        self._rf_init_scores = np.zeros(K)
        if self.config.boost_from_average:
            for k in range(K):
                self._rf_init_scores[k] = self.objective.boost_from_score(k)
        init = torch.as_tensor(np.repeat(
            self._rf_init_scores[:, None], train_data.num_data,
            axis=1).astype(np.float32), device=self.device)
        g, h = self.objective.get_gradients(init)
        self._rf_grad, self._rf_hess = g.reshape(K, -1), h.reshape(K, -1)

    def _make_train_step(self) -> None:
        # the running average updates the scores: the sync step
        self._step = None

    def _train_one_iter_impl(self, grad, hess) -> bool:
        if grad is not None or hess is not None:
            raise ValueError("RF mode does not support custom gradients")
        mask = self.bagging_mask(self.iter_)
        K = self.num_tree_per_iteration
        it = self.iter_ + self.num_init_iteration
        for k in range(K):
            need = self.objective.class_need_train(k)
            tree = None
            if need:
                tree, leaf_ids, _ = self.learner.train(
                    self._rf_grad[k], self._rf_hess[k], mask)
                self.grower_syncs += self.learner.last_syncs
            if tree is not None and tree.num_leaves > 1:
                init = self._rf_init_scores[k]
                if self.objective.needs_renew:
                    # the percentile refit against the constant init
                    # scores (rf.py:87-94)
                    leaf_np = leaf_ids.cpu().numpy()
                    mask_np = (np.ones(len(leaf_np), bool) if mask is None
                               else mask.cpu().numpy()[:len(leaf_np)] > 0)
                    self.objective.renew_tree_output(
                        tree, np.full(self.train_data.num_data, init),
                        leaf_np, mask_np)
                if abs(init) > K_EPSILON:
                    tree.add_bias(init)
                self._update_average_score(tree, k, it)
            else:
                tree = Tree(2)
                if len(self.models) < K:
                    output = (self.objective.boost_from_score(k)
                              if not need else self._rf_init_scores[k])
                    tree.as_constant_tree(output)
                    self._update_average_score(tree, k, it)
            self.models.append(tree)
        self.iter_ += 1
        return False

    def _update_average_score(self, tree: Tree, class_id: int, it: int
                              ) -> None:
        """score = (score * it + tree's f32 output) * 1/(it + 1) on the
        train and every validation set, the tree walked in bin space."""
        for state, data in self._score_sets():
            state.multiply(class_id, float(it))
            state.add(class_id, self._tree_values(tree, data))
            state.multiply(class_id, 1.0 / (it + 1))

    def rollback_one_iter(self) -> None:
        """The last iteration's trees out of the model, and out of the
        running averages: score = (score * (it + 1) - tree's f32 output) *
        1/it, with it the iterations before it (rf.py:125-149)."""
        self._materialize()
        self._invalidate_tables()
        if self.iter_ <= 0:
            return
        K = self.num_tree_per_iteration
        it = self.iter_ + self.num_init_iteration - 1
        for k in range(K):
            tree = self.models.pop()
            k_id = K - 1 - k
            if it < 0:
                continue
            for state, data in self._score_sets():
                state.multiply(k_id, float(it + 1))
                state.add(k_id, -self._tree_values(tree, data))
                if it > 0:
                    state.multiply(k_id, 1.0 / it)
        self.iter_ -= 1
