"""Query-of-death quarantine for the fleet router.

Port of ``spark_languagedetector_tpu.serve.quarantine``. A query of death
is a request whose content crashes whatever replica serves it; plain
failover would replay it onto every replica in turn. The router records a
content signature per dispatch (:func:`signature_of`: FNV-1a over the
document texts, the same value in every process and in both packages), and
a dispatch that coincides with a replica's death charges one death to that
signature. At ``K`` deaths (``LANGDETECT_QUARANTINE_DEATHS``) the signature
is quarantined: the router answers it with :class:`QueryQuarantined` (a
``ValueError``, HTTP 422) before any dispatch, and writes the request to a
serve-level :class:`~..resilience.dlq.DeadLetterQueue`. A poison request
can kill at most K replicas.

Both table operations pass the ``fleet/quarantine`` fault site and degrade
open: a failed lookup answers "not quarantined", a failed death record
drops that observation. The suspect and quarantined maps are bounded by
``LANGDETECT_QUARANTINE_MAX_ENTRIES``, oldest first.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Sequence

from ..exec import config as exec_config
from ..resilience import faults
from ..resilience.dlq import DeadLetterQueue
from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("serve.quarantine")

_U64 = (1 << 64) - 1
_FNV_PRIME = 0x100000001B3


class QueryQuarantined(ValueError):
    """The request's content signature is quarantined. A ``ValueError``, so
    no serving layer retries it; the HTTP fronts answer 422 with the
    signature (to find it in the serve DLQ)."""

    def __init__(self, signature: str, deaths: int):
        super().__init__(
            f"request signature {signature} is quarantined after {deaths} "
            "correlated replica death(s); see the serve DLQ"
        )
        self.signature = signature
        self.deaths = deaths


def signature_of(texts: Sequence[str]) -> str:
    """Order-sensitive content signature of one request: each text's FNV-1a
    and its length folded into a 64-bit FNV-1a, as 16 hex digits."""
    h = 0xCBF29CE484222325
    for t in texts:
        h = ((h ^ faults._fnv1a(t)) * _FNV_PRIME) & _U64
        h = ((h ^ len(t)) * _FNV_PRIME) & _U64
    return f"{h:016x}"


def _preview(texts: Sequence[str]) -> list[str]:
    return [t[:80] for t in texts[:4]]


class QuarantineTable:
    """Signature → correlated deaths, and the quarantined set. Thread-safe.

    :meth:`note_dispatch` remembers the last signature routed to each
    replica, so a death reported out of band (:meth:`replica_died`, without
    the request) still charges the right signature. ``deaths <= 0``
    disables the table: nothing is suspected or refused (the setting for
    drills that kill replicas under a small repeating text set).
    """

    def __init__(
        self,
        deaths: int | None = None,
        max_entries: int | None = None,
        *,
        dlq: DeadLetterQueue | None = None,
        dlq_path: str | None = None,
        name: str = "fleet",
    ):
        self.deaths_threshold = int(exec_config.resolve("quarantine_deaths", deaths))
        self.max_entries = max(1, int(exec_config.resolve("quarantine_max_entries", max_entries)))
        if dlq is None:
            dlq = DeadLetterQueue(exec_config.resolve("quarantine_dlq_path", dlq_path))
        self.dlq = dlq
        self.name = name
        self._lock = threading.Lock()
        self._suspects: OrderedDict[str, dict] = OrderedDict()
        self._quarantined: OrderedDict[str, dict] = OrderedDict()
        self._last_sig: dict[str, tuple[str, list]] = {}

    @property
    def enabled(self) -> bool:
        return self.deaths_threshold >= 1

    def _fault_gate(self, event: str, sig: str) -> bool:
        """Pass the ``fleet/quarantine`` site; False (logged) when a fault
        fires, so the caller degrades open."""
        try:
            faults.inject("fleet/quarantine")
        except Exception as e:
            log_event(_log, event, signature=sig, error=repr(e))
            return False
        return True

    def check(self, sig: str) -> bool:
        """Is ``sig`` quarantined? False under an injected fault."""
        if not self.enabled or not self._fault_gate("quarantine.check_degraded", sig):
            return False
        with self._lock:
            return sig in self._quarantined

    def note_dispatch(self, replica: str, sig: str, texts: Sequence[str]) -> None:
        """Remember the signature just routed to ``replica``."""
        if not self.enabled:
            return
        with self._lock:
            self._last_sig[replica] = (sig, _preview(texts))

    def record_death(
        self,
        sig: str,
        *,
        replica: str | None = None,
        source: str = "router",
        texts: Sequence[str] | None = None,
    ) -> bool:
        """Charge one correlated replica death to ``sig``; True when this
        death quarantined it. Dropped (False) under an injected fault."""
        if not self.enabled or not self._fault_gate("quarantine.record_degraded", sig):
            return False
        preview = _preview(texts) if texts is not None else None
        with self._lock:
            if replica is not None:
                # One death, one charge: the router's mid-flight charge and
                # an out-of-band report of the same death must not both
                # count. The next dispatch to the replica re-arms it.
                self._last_sig.pop(replica, None)
            if sig in self._quarantined:
                self._quarantined[sig]["deaths"] += 1
                return False
            rec = self._suspects.pop(sig, None) or {
                "deaths": 0, "replicas": [], "preview": preview,
            }
            self._suspects[sig] = rec  # most recent death last (LRU order)
            rec["deaths"] += 1
            if replica is not None:
                rec["replicas"].append(f"{source}:{replica}")
            if preview is not None:
                rec["preview"] = preview
            deaths = rec["deaths"]
            newly = deaths >= self.deaths_threshold
            if newly:
                del self._suspects[sig]
                self._quarantined[sig] = rec
            for table in (self._suspects, self._quarantined):
                while len(table) > self.max_entries:
                    table.popitem(last=False)
            quarantined_n = len(self._quarantined)
            row = {
                "signature": sig,
                "preview": rec["preview"],
                "replicas": list(rec["replicas"]),
                "deaths": deaths,
            }
        log_event(
            _log, "quarantine.death", signature=sig, replica=replica, source=source,
            deaths=deaths, quarantined=newly,
        )
        if newly:
            REGISTRY.incr("fleet/quarantined_signatures")
            REGISTRY.set_gauge(
                "langdetect_fleet_quarantined", float(quarantined_n), table=self.name
            )
            self.dlq.put(batch=0, row_index=deaths, row=row, error="query_of_death")
        return newly

    def replica_died(self, replica: str, *, source: str = "supervisor") -> bool:
        """An out-of-band death report: charge the signature last routed to
        ``replica``, if any."""
        with self._lock:
            last = self._last_sig.get(replica)
        if last is None:
            return False
        sig, preview = last
        return self.record_death(sig, replica=replica, source=source, texts=preview)

    def describe(self) -> dict:
        """The table's state, for ``/varz`` and the storm checks."""
        with self._lock:
            return {
                "name": self.name,
                "enabled": self.enabled,
                "deaths_threshold": self.deaths_threshold,
                "suspects": len(self._suspects),
                "quarantined": sorted(self._quarantined),
                "dlq_rows": len(self.dlq),
            }
