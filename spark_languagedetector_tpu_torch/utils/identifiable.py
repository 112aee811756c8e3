"""Unique identifiers for pipeline stages: every estimator/model instance
carries a ``uid`` of the form ``<prefix>_<hex>`` (the reference's
``Identifiable.randomUID``)."""

from __future__ import annotations

import uuid


def random_uid(prefix: str) -> str:
    """Return a fresh uid like ``LanguageDetector_1a2b3c4d5e6f``."""
    return f"{prefix}_{uuid.uuid4().hex[:12]}"


class Identifiable:
    """Mixin giving an object an immutable ``uid``."""

    def __init__(self, uid: str | None = None, *, uid_prefix: str | None = None):
        if uid is None:
            uid = random_uid(uid_prefix or type(self).__name__)
        self._uid = uid

    @property
    def uid(self) -> str:
        return self._uid

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(uid={self._uid!r})"
