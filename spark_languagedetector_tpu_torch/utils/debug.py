"""Numerical sanitizers: a NaN or Inf weight silently wins or loses every
argmax comparison.

Port of ``spark_languagedetector_tpu.utils.debug``:

* :func:`assert_finite`: a cheap explicit guard, used at trust boundaries
  (a profile refuses non-finite weights). A tensor is checked on its own
  device, so a check on the card copies one flag back, not the tensor.
* :func:`nan_checks`: a scoped switch. The JAX package's turns on
  ``jax_debug_nans``; torch has no counterpart for a forward pass (anomaly
  mode covers backward only), so the port checks its artifacts instead:
  under the switch, every weight table a runner uploads, every weight
  table a device fit finalizes and every score batch a runner fetches goes
  through :func:`assert_finite` on its device, and a non-finite value
  raises ``ValueError`` naming the artifact. The switch is process-wide,
  like the JAX flag; the prior setting is restored when the scope ends.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

_NAN_CHECKS = False


@contextmanager
def nan_checks(enabled: bool = True):
    """Check every weight table and fetched score batch for NaN/Inf inside
    the block (see the module docstring). Restores the prior setting."""
    global _NAN_CHECKS
    prev = _NAN_CHECKS
    _NAN_CHECKS = bool(enabled)
    try:
        yield
    finally:
        _NAN_CHECKS = prev


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS


def assert_finite(arr, what: str) -> None:
    """Raise ValueError naming the artifact if ``arr`` has NaN/Inf. A torch
    tensor is checked on its device; anything else as a numpy array."""
    import torch

    if isinstance(arr, torch.Tensor):
        if not arr.is_floating_point() or arr.numel() == 0:
            return
        finite = torch.isfinite(arr)
        if bool(finite.all()):
            return
        bad = int(arr.numel() - int(finite.sum()))
    else:
        a = np.asarray(arr)
        if not a.size or np.isfinite(a).all():
            return
        bad = int(a.size - np.isfinite(a).sum())
    raise ValueError(f"{what} contains {bad} non-finite value(s) (NaN/Inf)")


def check_finite(tensors, what: str) -> None:
    """:func:`assert_finite` on each tensor, only under :func:`nan_checks`."""
    if not _NAN_CHECKS:
        return
    for t in tensors:
        if t is not None:
            assert_finite(t, what)
