"""GOSS: gradient-based one-side sampling (reference src/boosting/goss.hpp).

The port of `lightgbm_tpu/models/goss.py`.  After a warm-up of
1/learning_rate iterations (goss.hpp:144), each tree keeps the top_rate
share of the rows by |g*h|, keeps each other row with probability
other_rate/(1-top_rate) and upscales those rows' grad/hess by
(1-top_rate)/other_rate.  The sampling runs inside the fused device step
(`TreeLearner.make_train_step`), as in the JAX package: a sort on the
card for the threshold, the hashed uniforms of the bagging key for the
draw.

Custom gradients (`fobj`) take the base class's sync step unsampled, as
the JAX package's GOSS does.  Objectives that take the sync step (the
ranking objectives, the percentile family) sample on the host
(`_goss_host`, lightgbm_tpu/models/goss.py:45-66): the top rows by the
sum over classes of |g*h|, then exactly other_rate of the rest from a
numpy generator of bagging_seed, upscaled.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.predict import upload
from .gbdt import GBDT


class GOSS(GBDT):
    def init(self, config, train_data) -> None:
        top_rate = float(config.top_rate)
        other_rate = float(config.other_rate)
        if top_rate + other_rate > 1.0:
            raise ValueError("top_rate + other_rate must be <= 1.0 for GOSS")
        if top_rate <= 0.0 or other_rate <= 0.0:
            raise ValueError("top_rate and other_rate must be > 0 for GOSS")
        if int(config.bagging_freq) > 0 \
                and float(config.bagging_fraction) != 1.0:
            raise ValueError("Cannot use bagging in GOSS")
        lr = float(config.learning_rate)
        self._goss_cfg = {"top_rate": top_rate, "other_rate": other_rate,
                          "warmup": int(1.0 / lr) if lr > 0 else 0}
        super().init(config, train_data)
        self._goss_rng = np.random.default_rng(int(config.bagging_seed))

    def _goss_host(self, grad: np.ndarray, hess: np.ndarray):
        """GOSS of the sync step on the host: grad/hess [k, n] numpy ->
        (grad', hess', row mask f32 [n])."""
        n = grad.shape[1]
        gh = np.abs(grad * hess).sum(axis=0)
        top_k = max(1, int(n * self._goss_cfg["top_rate"]))
        other_k = max(1, int(n * self._goss_cfg["other_rate"]))
        thr = np.partition(gh, n - top_k)[n - top_k]
        keep_top = gh >= thr
        rest = np.flatnonzero(~keep_top)
        sampled = self._goss_rng.choice(
            rest, size=min(other_k, len(rest)), replace=False)
        multiply = (n - top_k) / other_k
        mask = keep_top.copy()
        mask[sampled] = True
        grad = grad.copy()
        hess = hess.copy()
        grad[:, sampled] *= multiply
        hess[:, sampled] *= multiply
        return grad, hess, mask.astype(np.float32)

    def _sync_rows(self, grad, hess, given: bool):
        """Given gradients train unsampled; the objective's are sampled on
        the host once the warm-up is over (goss.py:68-84)."""
        if given:
            return super()._sync_rows(grad, hess, given)
        if self.iter_ < self._goss_cfg["warmup"]:
            return grad, hess, None
        g, h, mask = self._goss_host(grad.cpu().numpy(), hess.cpu().numpy())
        return (torch.as_tensor(g, device=self.device),
                torch.as_tensor(h, device=self.device),
                upload(mask, self.device))
