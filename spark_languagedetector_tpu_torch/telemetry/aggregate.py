"""Process identity and the fleet's telemetry collector.

Port of ``spark_languagedetector_tpu.telemetry.aggregate``:

  * :func:`process_identity` is the block a serving front end stamps onto
    every response and onto its ``/telemetryz`` scrape, and
    :func:`install_process_identity` names this process (replica, pid,
    platform) once. The platform is the serving device's type, ``"gpu"``
    for a CUDA device and ``"cpu"`` otherwise.
  * :func:`merge_snapshots` folds ``mergeable_snapshot`` dicts into one
    view: counters summed exactly, histogram sketches merged, gauges kept
    per replica under a ``replica`` label.
  * :class:`FleetCollector` records each replica's ``/telemetryz`` scrape
    (the ``fleet/scrape`` fault site fires in :meth:`FleetCollector.scrape`)
    and folds a member's last scrape into a retained per-name base when it
    leaves or its pid changes, so fleet counters stay monotone across
    replica generations. Its own health is ``fleet/agg_scrapes``,
    ``fleet/agg_scrape_failures`` and the ``langdetect_fleet_scrape_age_s``
    gauge.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

import torch

from ..resilience import faults
from .registry import REGISTRY, Histogram, Registry

# Version of the ``/telemetryz`` wire form; a scrape of another version is
# refused and counted as a failure, never merged.
SNAPSHOT_SCHEMA = 1


def process_identity(registry: Registry | None = None) -> dict:
    """This process's identity block (replica/pid/platform when installed
    with :func:`install_process_identity`; a bare pid otherwise)."""
    reg = REGISTRY if registry is None else registry
    if reg.identity:
        return dict(reg.identity)
    return {"pid": os.getpid()}


def install_process_identity(
    registry: Registry | None = None,
    *,
    replica: str,
    device,
) -> dict:
    """Stamp (replica, pid, platform) into ``registry.identity``; the
    platform is ``"gpu"`` for a CUDA serving ``device``, else the device's
    type (``"cpu"``)."""
    reg = REGISTRY if registry is None else registry
    kind = torch.device(device).type
    reg.identity.update(
        replica=str(replica),
        pid=os.getpid(),
        platform="gpu" if kind == "cuda" else kind,
    )
    return dict(reg.identity)


def _label_str(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    for k, v in (extra or {}).items():
        merged.setdefault(k, v)
    return ",".join(f"{k}={v}" for k, v in sorted(merged.items()))


def merge_snapshots(snaps: list[tuple[str, dict]]) -> dict:
    """Fold ``(member name, mergeable_snapshot)`` pairs into one view.

    Counters sum exactly; histograms merge into one sketch per name
    (count, sum, min and max exact; percentiles from the merged
    reservoir); gauges are not summed: each series keeps its value under
    its member's ``replica`` label."""
    counters: dict[str, float] = {}
    hists: dict[str, Histogram] = {}
    gauges: dict[str, dict[str, float]] = {}
    for name, snap in snaps:
        for cname, val in (snap.get("counters") or {}).items():
            if isinstance(val, (int, float)):
                counters[cname] = counters.get(cname, 0) + val
        for hname, state in (snap.get("histograms") or {}).items():
            if isinstance(state, dict):
                hists.setdefault(hname, Histogram()).merge(state)
        extra = {"replica": (snap.get("identity") or {}).get("replica", name)}
        for gname, series in (snap.get("gauges") or {}).items():
            out = gauges.setdefault(gname, {})
            for pair in series or ():
                try:
                    labels, val = pair
                except (TypeError, ValueError):
                    continue
                if isinstance(val, (int, float)) and isinstance(labels, dict):
                    out[_label_str(labels, extra)] = float(val)
    return {"counters": counters, "histograms": hists, "gauges": gauges}


class FleetCollector:
    """Scrape accumulator with terminal-scrape retention.

    The coordinator's own registry is an implicit member (``local_name``),
    read live when aggregating. Replicas are fed through :meth:`scrape`
    (or :meth:`record` with a snapshot in hand); :meth:`retire` folds a
    member's last scrape into its retained base, and a pid change between
    two scrapes folds the dead generation on its own.
    """

    def __init__(self, *, registry: Registry | None = None, local_name: str = "router"):
        self.registry = REGISTRY if registry is None else registry
        self.local_name = local_name
        self._lock = threading.Lock()
        # name -> {"snap": mergeable snapshot, "pid": int | None, "at": monotonic s}
        self._live: dict[str, dict] = {}
        # name -> {"counters", "histograms": {name: Histogram}, "identity", "generations"}
        self._retained: dict[str, dict] = {}
        self.scrapes = 0
        self.scrape_failures = 0

    def scrape(self, name: str, fetch: Callable[[], dict]) -> bool:
        """Fetch one member's ``/telemetryz`` through ``fetch`` and record
        it; any failure (the ``fleet/scrape`` fault site included) is
        counted and contained."""
        try:
            faults.inject("fleet/scrape")
            snap = fetch()
            if not isinstance(snap, dict) or snap.get("schema") != SNAPSHOT_SCHEMA:
                got = snap.get("schema") if isinstance(snap, dict) else snap
                raise ValueError(f"bad /telemetryz schema from {name!r}: {got!r}")
        except Exception:
            self.note_failure(name)
            return False
        self.record(name, snap)
        return True

    def record(self, name: str, snap: dict) -> None:
        """Accept one snapshot; a pid change against the member's previous
        scrape folds the dead generation into the retained base first."""
        pid = (snap.get("identity") or {}).get("pid")
        with self._lock:
            prev = self._live.get(name)
            if prev is not None and prev.get("pid") is not None and pid != prev["pid"]:
                self._fold_locked(name, prev["snap"])
            self._live[name] = {"snap": snap, "pid": pid, "at": time.monotonic()}
            self.scrapes += 1
        self.registry.incr("fleet/agg_scrapes")

    def note_failure(self, name: str) -> None:
        with self._lock:
            self.scrape_failures += 1
        self.registry.incr("fleet/agg_scrape_failures")

    def retire(self, name: str) -> None:
        """Fold the member's last scrape into its retained base (it left
        the fleet). Idempotent; a name never scraped is a no-op."""
        with self._lock:
            entry = self._live.pop(name, None)
            if entry is not None:
                self._fold_locked(name, entry["snap"])

    def _fold_locked(self, name: str, snap: dict) -> None:
        base = self._retained.setdefault(
            name, {"counters": {}, "histograms": {}, "identity": {}, "generations": 0}
        )
        for cname, val in (snap.get("counters") or {}).items():
            if isinstance(val, (int, float)):
                base["counters"][cname] = base["counters"].get(cname, 0) + val
        for hname, state in (snap.get("histograms") or {}).items():
            if isinstance(state, dict):
                base["histograms"].setdefault(hname, Histogram()).merge(state)
        base["identity"] = dict(snap.get("identity") or {})
        base["generations"] += 1

    def _member_snaps_locked(self) -> list[tuple[str, dict]]:
        out: list[tuple[str, dict]] = [
            (name, {
                "counters": dict(base["counters"]),
                "histograms": {h: hist.state() for h, hist in base["histograms"].items()},
                "gauges": {},  # a gone generation's gauges are stale
                "identity": dict(base["identity"]),
            })
            for name, base in self._retained.items()
        ]
        out.extend((name, entry["snap"]) for name, entry in self._live.items())
        return out

    def aggregate(self) -> dict:
        """The fleet-wide view: live members, retained scrapes and the
        coordinator's own registry through :func:`merge_snapshots`, with
        histograms as display snapshots."""
        with self._lock:
            snaps = self._member_snaps_locked()
        snaps.append((self.local_name, self.registry.mergeable_snapshot()))
        merged = merge_snapshots(snaps)
        merged["histograms"] = {name: h.snapshot() for name, h in merged["histograms"].items()}
        merged["members"] = self.members()
        merged["scrapes"] = self.scrapes
        merged["scrape_failures"] = self.scrape_failures
        return merged

    def counter(self, name: str, *, include_local: bool = True) -> float:
        """One aggregate counter: retained bases, each live member's last
        scrape and (``include_local``) the coordinator's live value."""
        total = 0.0
        with self._lock:
            for base in self._retained.values():
                total += base["counters"].get(name, 0)
            for entry in self._live.values():
                val = (entry["snap"].get("counters") or {}).get(name, 0)
                if isinstance(val, (int, float)):
                    total += val
        if include_local:
            total += self.registry.counters.get(name, 0)
        return total

    def per_replica(self) -> dict[str, dict]:
        """Per-member views (identity, state, counters); a member that left
        keeps its folded counters under ``state: "retired"``, a restarted
        one adds them to its live generation's."""
        out: dict[str, dict] = {}
        with self._lock:
            for name, base in self._retained.items():
                out[name] = {
                    "state": "retired",
                    "identity": dict(base["identity"]),
                    "generations": base["generations"],
                    "counters": dict(base["counters"]),
                }
            for name, entry in self._live.items():
                snap = entry["snap"]
                prev = out.pop(name, None)
                counters = dict(snap.get("counters") or {})
                generations = 1
                if prev is not None:
                    for cname, val in prev["counters"].items():
                        counters[cname] = counters.get(cname, 0) + val
                    generations += prev["generations"]
                out[name] = {
                    "state": "live",
                    "identity": dict(snap.get("identity") or {}),
                    "generations": generations,
                    "counters": counters,
                    "scrape_ts": snap.get("ts"),
                }
        return out

    def members(self) -> dict[str, dict]:
        """Identity and state of every member, without counters."""
        now = time.monotonic()
        out: dict[str, dict] = {}
        with self._lock:
            for name, base in self._retained.items():
                out[name] = {
                    "state": "retired",
                    "identity": dict(base["identity"]),
                    "generations": base["generations"],
                }
            for name, entry in self._live.items():
                info = out.get(name) or {"generations": 0}
                out[name] = {
                    "state": "live",
                    "identity": dict(entry["snap"].get("identity") or {}),
                    "generations": info.get("generations", 0) + 1,
                    "age_s": round(now - entry["at"], 3),
                }
        return out

    def freshness_s(self) -> float:
        """Age of the stalest live member's scrape (0.0 with none), also set
        as the ``langdetect_fleet_scrape_age_s`` gauge."""
        now = time.monotonic()
        with self._lock:
            ages = [now - entry["at"] for entry in self._live.values()]
        age = max(ages) if ages else 0.0
        self.registry.set_gauge("langdetect_fleet_scrape_age_s", age)
        return age
