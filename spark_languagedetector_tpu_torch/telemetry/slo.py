"""Declared SLOs evaluated as multi-window burn rates over the fleet
aggregate.

Port of ``spark_languagedetector_tpu.telemetry.slo``: the same objectives,
windows, verdicts and ``slo/*`` names, so one aggregate sequence gives the
same status dicts in both packages. The collector
(:class:`~.aggregate.FleetCollector`) gives one merged, monotone view of
the fleet; this module turns that stream into three objectives:

  * **availability**: 1 - shed rate. Fleet sheds (``fleet/shed_requests``)
    plus replica sheds (``serve/shed_requests``) over admitted traffic,
    differenced per evaluation so the burn reflects current traffic;
  * **latency_p99**: the p99 of the router's ``fleet/request_s`` against a
    declared target, judged only over windows with new completions;
  * **freshness**: the stalest member's scrape age
    (``langdetect_fleet_scrape_age_s``) against a bound, so a collector
    that stops scraping burns instead of reporting a stale, healthy view.

A burn rate is error-budget consumption speed: the windowed error (or
violation) fraction over the budget 1 - target. An alert fires only when
both the short and the long window burn at ``burn_threshold`` or more,
and clears when the short window recovers. Time is whatever ``now=`` the
caller passes to :meth:`SloEvaluator.ingest` (``time.monotonic`` when
None), so a drill moves it without sleeping.

Every evaluation observes the worst burn into the ``slo/burn_rate``
histogram and sets ``langdetect_slo_burn_rate{objective=...}``; alert
transitions count ``slo/alerts``. The router front's ``/healthz`` carries
:meth:`SloEvaluator.status` and its reasons
(:class:`~..serve.router.RouterServer` ``slo=``).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .registry import REGISTRY, Registry

# The telemetry names every objective reads. Each must be emitted
# somewhere: a renamed one would evaluate its objective against zeros.
SLO_INPUT_COUNTERS = (
    "fleet/requests",
    "fleet/shed_requests",
    "serve/shed_requests",
)
SLO_INPUT_HISTOGRAMS = ("fleet/request_s",)
SLO_INPUT_GAUGES = ("langdetect_fleet_scrape_age_s",)


class Objective:
    """One declared objective: a name, a target, and how to read it.

    ``kind`` picks the evaluation: ``"availability"`` (good/total ratio
    from counter deltas), ``"latency_p99"`` (aggregate p99 seconds vs
    ``threshold``), ``"freshness"`` (gauge seconds vs ``threshold``).
    ``target`` is the success-ratio objective (0.99 = 1% error budget);
    the budget ``1 − target`` also scales the threshold objectives'
    violation burn, so one ``burn_threshold`` means the same thing for
    every objective.
    """

    __slots__ = ("name", "kind", "target", "threshold")

    def __init__(
        self,
        name: str,
        kind: str,
        *,
        target: float = 0.99,
        threshold: float | None = None,
    ):
        if kind not in ("availability", "latency_p99", "freshness"):
            raise ValueError(f"unknown objective kind {kind!r}")
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if kind != "availability" and (
            threshold is None or threshold <= 0
        ):
            raise ValueError(
                f"objective {name!r} ({kind}) needs a positive threshold"
            )
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.threshold = None if threshold is None else float(threshold)

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def describe(self) -> dict:
        return {
            "kind": self.kind,
            "target": self.target,
            "threshold": self.threshold,
        }


def default_objectives(
    *,
    latency_p99_ms: float = 250.0,
    availability_target: float = 0.99,
    freshness_s: float = 10.0,
) -> tuple[Objective, ...]:
    """The serving fleet's declared objectives: availability, the router's
    request p99 and the collector's scrape freshness."""
    return (
        Objective(
            "availability", "availability", target=availability_target
        ),
        Objective(
            "latency_p99", "latency_p99",
            target=availability_target, threshold=latency_p99_ms / 1e3,
        ),
        Objective(
            "freshness", "freshness",
            target=availability_target, threshold=freshness_s,
        ),
    )


class SloEvaluator:
    """Feed :meth:`ingest` one fleet aggregate per collector round; read
    :meth:`status`/:meth:`burning` anywhere. Thread-safe (one thread
    ingests while the fleet ``/healthz`` reads)."""

    def __init__(
        self,
        objectives: tuple[Objective, ...] | None = None,
        *,
        registry: Registry | None = None,
        short_window_s: float = 30.0,
        long_window_s: float = 120.0,
        burn_threshold: float = 1.0,
    ):
        if short_window_s <= 0 or long_window_s < short_window_s:
            raise ValueError(
                "windows must satisfy 0 < short_window_s <= long_window_s "
                f"(got {short_window_s}, {long_window_s})"
            )
        self.objectives = (
            default_objectives() if objectives is None else tuple(objectives)
        )
        self.registry = REGISTRY if registry is None else registry
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.burn_threshold = float(burn_threshold)
        self._lock = threading.Lock()
        # Per objective: deque of (ts, bad, total) window samples. For
        # availability bad/total are counter DELTAS; for the threshold
        # objectives each evaluation is one sample (bad ∈ {0, 1}).
        self._samples: dict[str, deque] = {
            o.name: deque() for o in self.objectives
        }
        self._alerting: dict[str, bool] = {
            o.name: False for o in self.objectives
        }
        self._last: dict[str, dict] = {}
        self._seen_counters: dict[str, float] = {}

    # ---------------------------------------------------------- ingestion ---
    def _counter_delta(self, counters: dict, name: str) -> float:
        val = counters.get(name, 0)
        val = float(val) if isinstance(val, (int, float)) else 0.0
        seen = self._seen_counters.get(name, 0.0)
        # The aggregate is monotone by construction (terminal retention in
        # the collector); clamp anyway so a collector reset can never
        # manufacture negative traffic.
        delta = val - seen if val >= seen else val
        self._seen_counters[name] = val
        return delta

    def ingest(self, aggregate: dict, *, now: float | None = None) -> dict:
        """Evaluate every objective against one merged aggregate (the
        :meth:`~.aggregate.FleetCollector.aggregate` form: counters,
        histogram snapshots, gauges). Returns :meth:`status`."""
        ts = time.monotonic() if now is None else float(now)
        counters = aggregate.get("counters") or {}
        hists = aggregate.get("histograms") or {}
        gauges = aggregate.get("gauges") or {}
        with self._lock:
            worst = 0.0
            for obj in self.objectives:
                bad, total = self._measure(obj, counters, hists, gauges)
                window = self._samples[obj.name]
                window.append((ts, bad, total))
                cutoff = ts - self.long_window_s
                while window and window[0][0] < cutoff:
                    window.popleft()
                burn_short = self._burn(obj, window, ts - self.short_window_s)
                burn_long = self._burn(obj, window, cutoff)
                was = self._alerting[obj.name]
                if was:
                    alerting = burn_short >= self.burn_threshold
                else:
                    alerting = (
                        burn_short >= self.burn_threshold
                        and burn_long >= self.burn_threshold
                    )
                if alerting and not was:
                    self.registry.incr("slo/alerts")
                self._alerting[obj.name] = alerting
                self._last[obj.name] = {
                    **obj.describe(),
                    "burn_short": round(burn_short, 4),
                    "burn_long": round(burn_long, 4),
                    "alerting": alerting,
                }
                worst = max(worst, burn_short)
                self.registry.set_gauge(
                    "langdetect_slo_burn_rate", burn_short,
                    objective=obj.name,
                )
        self.registry.observe("slo/burn_rate", worst)
        return self.status()

    def _measure(
        self, obj: Objective, counters: dict, hists: dict, gauges: dict
    ) -> tuple[float, float]:
        """One evaluation's (bad, total) sample for an objective."""
        if obj.kind == "availability":
            sheds = sum(
                self._counter_delta(counters, name)
                for name in ("fleet/shed_requests", "serve/shed_requests")
            )
            served = self._counter_delta(counters, "fleet/requests")
            return sheds, served + sheds
        if obj.kind == "latency_p99":
            # The merged sketch is cumulative, so its p99 carries fleet
            # HISTORY — a verdict is recorded only when this window saw
            # new completions. Otherwise one slow burst would burn the
            # objective forever (and pin any pressure signal read from it high
            # through dead silence); with no new evidence the old bad
            # samples age out of the short window and the alert clears.
            snap = hists.get("fleet/request_s") or {}
            count = snap.get("count")
            count = float(count) if isinstance(count, (int, float)) else 0.0
            seen = self._seen_counters.get("hist:fleet/request_s", 0.0)
            fresh = count - seen if count >= seen else count
            self._seen_counters["hist:fleet/request_s"] = count
            if fresh <= 0:
                return 0.0, 0.0
            p99 = snap.get("p99")
            bad = (
                1.0 if isinstance(p99, (int, float))
                and p99 > obj.threshold else 0.0
            )
            return bad, 1.0
        # freshness: the aggregate's flat gauge form keys label strings;
        # the scrape-age series is unlabelled at source, so any value of
        # the series counts (max across label sets is the stalest view).
        series = gauges.get("langdetect_fleet_scrape_age_s") or {}
        ages = [
            v for v in series.values() if isinstance(v, (int, float))
        ]
        bad = 1.0 if ages and max(ages) > obj.threshold else 0.0
        return bad, 1.0

    def _burn(self, obj: Objective, window, cutoff: float) -> float:
        bad = total = 0.0
        for ts, b, t in window:
            if ts >= cutoff:
                bad += b
                total += t
        if total <= 0:
            return 0.0
        return (bad / total) / obj.budget

    # ------------------------------------------------------------- status ---
    def status(self) -> dict:
        with self._lock:
            objectives = {
                o.name: dict(
                    self._last.get(o.name)
                    or {**o.describe(), "burn_short": 0.0,
                        "burn_long": 0.0, "alerting": False}
                )
                for o in self.objectives
            }
        reasons = [
            f"slo_{name}_burn" for name, st in objectives.items()
            if st["alerting"]
        ]
        return {
            "burning": bool(reasons),
            "reasons": reasons,
            "burn_threshold": self.burn_threshold,
            "short_window_s": self.short_window_s,
            "long_window_s": self.long_window_s,
            "objectives": objectives,
        }

    def burning(self) -> bool:
        with self._lock:
            return any(self._alerting.values())

    def reasons(self) -> list[str]:
        return self.status()["reasons"]
