"""Shared helpers of the lightgbm_tpu_torch parity tests (no tests here)."""

import numpy as np
import pytest
import torch


def cuda_device():
    """The first CUDA device, or skip (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda", 0)


def binary_data(n=2000, f=6, seed=0, nan_frac=0.05, zero_frac=0.0):
    """Seeded dense numeric binary data with NaNs (and exact zeros)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    if zero_frac:
        X[rng.random((n, f)) < zero_frac] = 0.0
    X[rng.random((n, f)) < nan_frac] = np.nan
    w = rng.normal(size=f)
    Xn = np.nan_to_num(X)
    logit = (Xn[:, :3] ** 2).sum(1) * 0.3 + Xn @ w * 0.5 - 0.9
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y
