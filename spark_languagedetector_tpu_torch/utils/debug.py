"""Numerical guard at trust boundaries: a NaN/Inf weight would silently win
or lose every argmax comparison, so profiles refuse non-finite weights."""

from __future__ import annotations

import numpy as np


def assert_finite(arr, what: str) -> None:
    """Raise ValueError naming the artifact if ``arr`` has NaN/Inf."""
    a = np.asarray(arr)
    if a.size and not np.isfinite(a).all():
        bad = int(a.size - np.isfinite(a).sum())
        raise ValueError(
            f"{what} contains {bad} non-finite value(s) (NaN/Inf) — "
            "refusing to build a model from corrupt weights"
        )
