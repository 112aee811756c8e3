"""LRU residency accounting for the model zoo.

Port of ``spark_languagedetector_tpu.zoo.residency``. Which tenants are
resident, how many device-table bytes each holds, and which least recently
used tenants to page out when a load pushes the zoo past its byte or model
budget (``LANGDETECT_ZOO_RESIDENT_BYTES`` / ``_MODELS``; unset: unlimited).

Policy only: the zoo supplies ``evictable`` (never a tenant whose registry
holds a lease or whose batcher has queued or in-flight rows) and ``evict``
(the teardown). When every candidate is busy the zoo runs over budget until
the next admit, logged. A single tenant larger than the byte budget is
admitted all the same. Occupancy is the ``langdetect_zoo_resident_bytes``
and ``langdetect_zoo_resident_models`` gauges; each page-out counts
``zoo/evictions``.

Not thread-safe on its own: the zoo calls it under its control-plane lock.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable

from ..exec import config as exec_config
from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("zoo.residency")


class ResidencyManager:
    """Resident tenants → table bytes in LRU order, under two budgets."""

    def __init__(self, *, max_bytes: int | None = None, max_models: int | None = None):
        mb = exec_config.resolve("zoo_resident_bytes", max_bytes)
        mm = exec_config.resolve("zoo_resident_models", max_models)
        self.max_bytes = None if mb is None else int(mb)
        self.max_models = None if mm is None else int(mm)
        self._resident: OrderedDict[str, int] = OrderedDict()

    @property
    def bytes(self) -> int:
        return sum(self._resident.values())

    @property
    def models(self) -> int:
        return len(self._resident)

    def resident(self) -> dict[str, int]:
        """{tenant: table bytes}, least recently used first."""
        return dict(self._resident)

    def is_resident(self, name: str) -> bool:
        return name in self._resident

    def touch(self, name: str) -> None:
        """Mark a resident tenant most recently used."""
        if name in self._resident:
            self._resident.move_to_end(name)

    def drop(self, name: str) -> None:
        """Forget a tenant the zoo tore down itself."""
        if self._resident.pop(name, None) is not None:
            self._gauges()

    def _over_budget(self) -> bool:
        if self.max_models is not None and self.models > self.max_models:
            return True
        return self.max_bytes is not None and self.bytes > self.max_bytes

    def admit(
        self,
        name: str,
        nbytes: int,
        *,
        evictable: Callable[[str], bool],
        evict: Callable[[str], None],
    ) -> list[str]:
        """Record ``name`` resident at ``nbytes`` (most recently used), then
        page out least recently used evictable tenants, never ``name``
        itself, while over either budget. Returns the evicted names in
        order."""
        self._resident.pop(name, None)
        self._resident[name] = int(nbytes)
        evicted: list[str] = []
        while self._over_budget():
            victim = next(
                (n for n in self._resident if n != name and n not in evicted and evictable(n)),
                None,
            )
            if victim is None:
                log_event(
                    _log, "zoo.residency.over_budget", tenant=name,
                    resident_bytes=self.bytes, resident_models=self.models,
                    max_bytes=self.max_bytes, max_models=self.max_models,
                )
                break
            evict(victim)
            del self._resident[victim]
            evicted.append(victim)
            REGISTRY.incr("zoo/evictions")
            log_event(
                _log, "zoo.residency.evicted", tenant=victim, for_=name,
                resident_bytes=self.bytes, resident_models=self.models,
            )
        self._gauges()
        return evicted

    def _gauges(self) -> None:
        REGISTRY.set_gauge("langdetect_zoo_resident_bytes", float(self.bytes))
        REGISTRY.set_gauge("langdetect_zoo_resident_models", float(self.models))

    def describe(self) -> dict:
        return {
            "resident_models": self.models,
            "resident_bytes": self.bytes,
            "max_models": self.max_models,
            "max_bytes": self.max_bytes,
            "lru": list(self._resident),
        }
