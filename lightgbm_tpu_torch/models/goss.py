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
the JAX package's GOSS does.  The JAX package's host sampler
(`GOSS._goss_host`), which only objectives that renew leaf outputs
reach, is not ported: such objectives are refused, and the sync path
without given gradients raises here.
"""

from __future__ import annotations

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

    def _train_one_iter_sync(self, grad=None, hess=None) -> bool:
        if grad is None:
            raise NotImplementedError(
                "GOSS on the sync step without given gradients (the host "
                "sampler of objectives that renew leaf outputs) is not "
                "ported to lightgbm_tpu_torch yet")
        return super()._train_one_iter_sync(grad, hess)
