"""The package version: the JAX package's (lightgbm_tpu/version.py)."""

__version__ = "0.1.0"
