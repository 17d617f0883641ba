"""Boosting drivers; `create_boosting` picks one by `boosting`."""

from .gbdt import GBDT


def create_boosting(config) -> GBDT:
    """The boosting factory (reference src/boosting/boosting.cpp:35-68)."""
    from .dart import DART
    from .goss import GOSS
    from .rf import RF

    t = config.boosting
    if t == "gbdt":
        return GBDT()
    if t == "dart":
        return DART()
    if t == "goss":
        return GOSS()
    if t in ("rf", "random_forest"):
        return RF()
    raise ValueError(f"unknown boosting type {t!r}")
