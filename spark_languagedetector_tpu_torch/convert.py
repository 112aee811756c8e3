"""Carry a fitted profile across from the JAX package.

The JAX package's ``GramProfile`` is plain host state — a vocab spec, the
language order, sorted gram ids and a weight matrix — so it crosses as numpy
arrays and needs no import of that package here::

    p = jax_model.profile
    model = model_from_arrays(
        p.spec.mode, p.spec.gram_lengths, p.spec.hash_bits, p.spec.hash_scheme,
        p.languages, p.ids, p.weights, device="cuda",
    )

Both packages then score the same profile with the same semantics. A fitted
calibration crosses as its plain dict (``jax_model.calibration.to_dict()``,
floats and JSON only) through ``calibration=``, so a JAX-calibrated model
segments identically in the port. An exact
profile with gram lengths 4..5 crosses the same way: its runner rebuilds the
cuckoo table, the bucket table and the dense n <= 2 sub-table from the ids
and weights, bit-identical to the JAX runner's (same seed streams).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .models.estimator import LanguageDetectorModel
from .models.profile import GramProfile
from .ops.vocab import VocabSpec
from .segment.calibrate import Calibration


def profile_from_arrays(
    mode: str,
    gram_lengths: Sequence[int],
    hash_bits: int,
    hash_scheme: str,
    languages: Sequence[str],
    ids,
    weights,
) -> GramProfile:
    """The port's :class:`GramProfile` from a profile's fields as arrays
    (the usual checks apply: ascending ids in range, finite weights)."""
    spec = VocabSpec(
        mode, tuple(gram_lengths), hash_bits=int(hash_bits), hash_scheme=hash_scheme
    )
    return GramProfile(
        spec=spec,
        languages=tuple(languages),
        ids=np.asarray(ids, dtype=np.int64),
        weights=np.asarray(weights),
    )


def model_from_arrays(
    mode: str,
    gram_lengths: Sequence[int],
    hash_bits: int,
    hash_scheme: str,
    languages: Sequence[str],
    ids,
    weights,
    *,
    device: str | None = None,
    calibration: dict | None = None,
) -> LanguageDetectorModel:
    """:func:`profile_from_arrays` wrapped in a :class:`LanguageDetectorModel`
    that runs on ``device`` (None ⇒ the CUDA card). ``calibration`` is the
    ``Calibration.to_dict()`` state of a calibrated model, or None."""
    model = LanguageDetectorModel(
        profile_from_arrays(
            mode, gram_lengths, hash_bits, hash_scheme, languages, ids, weights
        ),
        device=device,
    )
    if calibration is not None:
        model.calibration = Calibration.from_dict(calibration)
    return model
