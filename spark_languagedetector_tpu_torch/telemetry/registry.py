"""The metric registry: counters, histograms, gauges, span aggregates.

Port of ``spark_languagedetector_tpu.telemetry.registry``, whole: the same
names and the same deterministic reservoir, so a capture of the port reads
like one of the JAX package.

One coherent, process-global store behind the whole telemetry subsystem.
All writes take the registry lock — producers are per-batch (runner
dispatch, streaming engine, fit loop), never per-row, so the lock cost
stays invisible next to the work it measures (the same cost model as
``utils.metrics``). The registry itself imports no device library and does no
I/O: sinks attached via :meth:`Registry.add_sink` receive span/snapshot
events, and the Prometheus writer renders :meth:`Registry.snapshot`.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import Any

# Reservoir size: 512 float samples bound every histogram at ~4KB while
# keeping p99 meaningful for the per-batch populations we record (a bench
# pass is 10s-100s of batches; a long stream is sampled uniformly).
DEFAULT_RESERVOIR = 512


class Histogram:
    """Streaming distribution: exact count/sum/min/max + uniform reservoir.

    The reservoir uses Algorithm R with a deterministic LCG (no dependence
    on process-global random state), so two runs over the same sequence
    report identical percentiles — bench artifacts stay diffable.
    Thread-safety is the owning registry's job; standalone use from several
    threads needs external locking.
    """

    __slots__ = ("count", "total", "min", "max", "_res", "_cap", "_lcg")

    def __init__(self, reservoir_size: int = DEFAULT_RESERVOIR):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._res: list[float] = []
        self._cap = reservoir_size
        self._lcg = 0x9E3779B9

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if len(self._res) < self._cap:
            self._res.append(value)
        else:
            self._lcg = (self._lcg * 1103515245 + 12345) & 0x7FFFFFFF
            j = self._lcg % self.count
            if j < self._cap:
                self._res[j] = value

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the reservoir; nan when empty."""
        if not self._res:
            return math.nan
        ordered = sorted(self._res)
        rank = min(len(ordered) - 1, max(0, math.ceil(p / 100.0 * len(ordered)) - 1))
        return ordered[rank]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    # ------------------------------------------------------------ merging ----
    def state(self) -> dict:
        """JSON-safe mergeable form: exact count/sum/min/max + the raw
        reservoir samples. This is what ``/telemetryz`` puts on the wire —
        :meth:`merge` on the far side reconstitutes a fleet-wide sketch
        (count/sum/min/max stay exact; percentiles are reservoir-
        approximate, same as locally)."""
        out: dict = {
            "count": self.count,
            "sum": self.total,
            "reservoir": list(self._res),
        }
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
        return out

    @classmethod
    def from_state(cls, state: dict, reservoir_size: int = DEFAULT_RESERVOIR):
        h = cls(reservoir_size)
        h.merge(state)
        return h

    @staticmethod
    def _thin(samples: list[float], keep: int) -> list[float]:
        # Deterministic uniform thinning (evenly spaced picks over the
        # sample order): two merges of the same scrapes yield the same
        # reservoir, so fleet-aggregate percentiles stay diffable run to
        # run — the same property the per-process LCG reservoir has.
        if keep >= len(samples):
            return list(samples)
        if keep <= 0:
            return []
        step = len(samples) / keep
        return [samples[int(i * step)] for i in range(keep)]

    def merge(self, other: "Histogram | dict") -> "Histogram":
        """Fold another histogram (or its :meth:`state` dict) into this
        one. Count/sum/min/max merge exactly; the reservoirs merge by
        population-weighted deterministic thinning, so the combined
        reservoir approximates a uniform sample over BOTH populations.
        Returns self (chainable folds in the fleet collector)."""
        state = other.state() if isinstance(other, Histogram) else other
        count = int(state.get("count", 0) or 0)
        if count <= 0:
            return self
        prior = self.count
        self.count += count
        self.total += float(state.get("sum", 0.0) or 0.0)
        mn, mx = state.get("min"), state.get("max")
        if isinstance(mn, (int, float)) and mn < self.min:
            self.min = float(mn)
        if isinstance(mx, (int, float)) and mx > self.max:
            self.max = float(mx)
        incoming = [
            float(v) for v in (state.get("reservoir") or ())
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        ]
        if not incoming:
            return self
        if len(self._res) + len(incoming) <= self._cap:
            self._res.extend(incoming)
            return self
        # Over capacity: each side keeps slots proportional to the
        # population it represents (not its reservoir length), clamped so
        # a tiny-but-present side is never thinned to nothing.
        keep_inc = round(self._cap * count / self.count)
        keep_inc = min(len(incoming), max(1, keep_inc))
        keep_own = min(len(self._res), self._cap - keep_inc)
        if prior > 0:
            keep_own = max(1, keep_own)
            keep_inc = min(keep_inc, self._cap - keep_own)
        self._res = (
            self._thin(self._res, keep_own) + self._thin(incoming, keep_inc)
        )
        return self

    def snapshot(self) -> dict:
        out = {
            "count": self.count,
            "sum": self.total,
        }
        if self.count:
            out.update(
                min=self.min,
                max=self.max,
                mean=self.mean,
                p50=self.percentile(50),
                p90=self.percentile(90),
                p99=self.percentile(99),
            )
        return out


def _label_key(labels: dict[str, Any]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Registry:
    """Counters + histograms + gauges + span aggregates, one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)
        self.histograms: dict[str, Histogram] = {}
        # gauge name -> {sorted (label, value) tuple -> last value}
        self.gauges: dict[str, dict[tuple[tuple[str, str], ...], float]] = {}
        self._sinks: list[Any] = []
        # Process identity (replica name, pid, platform), installed once
        # by replica workers (telemetry.aggregate.install_process_identity)
        # and stamped onto every exported span event + the mergeable
        # snapshot — multi-process captures stay attributable without
        # out-of-band context.
        self.identity: dict[str, Any] = {}

    # ------------------------------------------------------------- sinks ----
    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
        close = getattr(sink, "close", None)
        if close:
            close()

    def clear_sinks(self) -> None:
        with self._lock:
            sinks, self._sinks = self._sinks, []
        for s in sinks:
            close = getattr(s, "close", None)
            if close:
                close()

    @property
    def sinks(self) -> list:
        return list(self._sinks)

    def emit(self, event: dict) -> None:
        """Hand one event dict to every attached per-event sink.

        Sink failures (disk full, closed file) are contained: spans emit
        from inside production fit/score/stream paths, and a metrics sink
        must never take down the computation it observes. Drops are
        counted (``telemetry/sink_errors``) and warned once per sink.
        """
        for sink in list(self._sinks):
            emit = getattr(sink, "emit", None)
            if emit is None:
                continue
            try:
                emit(event)
            except Exception as e:
                with self._lock:
                    self.counters["telemetry/sink_errors"] += 1
                if not getattr(sink, "_emit_warned", False):
                    try:
                        sink._emit_warned = True
                    except Exception:
                        pass
                    import warnings

                    warnings.warn(
                        f"telemetry sink {sink!r} failed, dropping events:"
                        f" {e}",
                        RuntimeWarning,
                        stacklevel=2,
                    )

    # ----------------------------------------------------------- metrics ----
    def incr(self, name: str, value: int = 1) -> None:
        with self._lock:
            self.counters[name] += value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self.histograms.get(name)
            if hist is None:
                hist = self.histograms[name] = Histogram()
            hist.record(value)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self.gauges.setdefault(name, {})[_label_key(labels)] = float(value)

    def record_span(
        self,
        path: str,
        wall_s: float,
        device_s: float | None = None,
        attrs: dict | None = None,
        ts: float | None = None,
    ) -> None:
        """Aggregate one finished span and stream it to the event sinks.
        ``ts``: the span's end on the host's wall clock (default: now)."""
        with self._lock:
            hist = self.histograms.get("span:" + path)
            if hist is None:
                hist = self.histograms["span:" + path] = Histogram()
            hist.record(wall_s)
            if device_s is not None:
                dhist = self.histograms.get("span_device:" + path)
                if dhist is None:
                    dhist = self.histograms["span_device:" + path] = Histogram()
                dhist.record(device_s)
        event = {"event": "telemetry.span", "ts": time.time() if ts is None else ts,
                 "path": path, "wall_s": wall_s}
        if device_s is not None:
            event["device_s"] = device_s
        if attrs:
            event.update(attrs)
        # Identity labels never override a span's own attrs of the same
        # name (a router span naming the replica it dispatched TO keeps
        # that name; the stamp says who recorded).
        for k, v in self.identity.items():
            event.setdefault(k, v)
        self.emit(event)

    # --------------------------------------------------------- snapshots ----
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "histograms": {
                    name: h.snapshot() for name, h in self.histograms.items()
                },
                "gauges": {
                    name: {",".join(f"{k}={v}" for k, v in key) or "": val
                           for key, val in series.items()}
                    for name, series in self.gauges.items()
                },
            }

    def mergeable_snapshot(self) -> dict:
        """The ``/telemetryz`` wire form: everything :meth:`snapshot`
        carries, but in a shape a fleet collector can MERGE instead of
        merely display — exact counters, histograms as
        :meth:`Histogram.state` sketches (count/sum/min/max exact,
        reservoir for percentiles), gauges with structured label pairs,
        and the recording process's identity block."""
        with self._lock:
            return {
                "schema": 1,
                "ts": time.time(),
                "identity": dict(self.identity),
                "counters": dict(self.counters),
                "histograms": {
                    name: h.state() for name, h in self.histograms.items()
                },
                "gauges": {
                    name: [[dict(key), val] for key, val in series.items()]
                    for name, series in self.gauges.items()
                },
            }

    def gauge_series(self) -> dict[str, list[tuple[dict[str, str], float]]]:
        """Gauges with structured labels: name -> [(labels dict, value)].

        The flat ``snapshot()['gauges']`` keys comma-join label pairs for
        display/JSONL compactness — lossy when a value contains ``,`` or
        ``=``. Exporters that must reconstruct individual labels (the
        Prometheus renderer) use this instead.
        """
        with self._lock:
            return {
                name: [(dict(key), val) for key, val in series.items()]
                for name, series in self.gauges.items()
            }

    def stage_summary(self) -> dict[str, dict]:
        """Per-span-path aggregate — the bench's per-stage breakdown block."""
        with self._lock:
            out = {}
            for name, h in self.histograms.items():
                if not name.startswith("span:"):
                    continue
                path = name[len("span:"):]
                s = h.snapshot()
                entry = {
                    "count": s["count"],
                    "total_s": round(s["sum"], 6),
                    **{k: round(s[k], 6) for k in ("mean", "p50", "p90", "p99")
                       if k in s},
                }
                # Fenced device timings ride along under device_* keys so
                # the bench breakdown shows completion time, not just
                # enqueue time, when fencing was on.
                dh = self.histograms.get("span_device:" + path)
                if dh is not None:
                    ds = dh.snapshot()
                    entry["device_total_s"] = round(ds["sum"], 6)
                    entry.update({
                        "device_" + k: round(ds[k], 6)
                        for k in ("mean", "p50", "p99") if k in ds
                    })
                out[path] = entry
            self._attach_cost_estimates(out)
            return out

    def _attach_cost_estimates(self, out: dict[str, dict]) -> None:
        """Join cost gauges (telemetry.cost) onto matching stage entries.

        A ``program_flops{program=<path>}`` gauge holds the estimated
        FLOPs of one call of the span at ``<path>``; divided by the
        measured per-call seconds (fenced ``device_mean`` preferred — the
        wall mean of an async dispatch is enqueue time) it yields achieved
        FLOP/s, and against the ``device_peak_*`` roofline anchors a
        utilization fraction. Caller holds the lock.
        """
        peak_f = next(
            iter(self.gauges.get("device_peak_flops", {}).values()), None
        )
        peak_b = next(
            iter(self.gauges.get("device_peak_bytes_per_s", {}).values()), None
        )
        for gauge, unit, peak in (
            ("program_flops", "flops", peak_f),
            ("program_bytes_accessed", "bytes", peak_b),
        ):
            for key, per_call in self.gauges.get(gauge, {}).items():
                path = dict(key).get("program")
                entry = out.get(path)
                if entry is None:
                    continue
                entry[f"est_{unit}_per_call"] = round(per_call, 3)
                seconds = entry.get("device_mean", entry.get("mean"))
                if not seconds:
                    continue
                rate = per_call / seconds
                entry[f"est_{unit}_per_s"] = round(rate, 3)
                if peak:
                    entry[f"{unit}_utilization"] = round(rate / peak, 6)
        for entry in out.values():
            fu = entry.get("flops_utilization")
            bu = entry.get("bytes_utilization")
            if fu is not None and bu is not None:
                entry["roofline_bound"] = "compute" if fu >= bu else "memory"

    def flush(self) -> None:
        """Emit a snapshot event to the per-event sinks and refresh every
        snapshot-style sink (the Prometheus writer)."""
        snap = self.snapshot()
        # Span distributions are reconstructible from the per-span events;
        # the plain histograms (fill ratio, stall time, ...) exist nowhere
        # else in the JSONL stream, so the snapshot must carry them.
        hists = {
            name: h for name, h in snap["histograms"].items()
            if not name.startswith(("span:", "span_device:"))
        }
        self.emit({"event": "telemetry.snapshot", "ts": time.time(),
                   "counters": snap["counters"], "gauges": snap["gauges"],
                   "histograms": hists})
        for sink in list(self._sinks):
            write = getattr(sink, "write_snapshot", None)
            if write is None:
                continue
            try:
                write(self)
            except Exception:
                with self._lock:
                    self.counters["telemetry/sink_errors"] += 1

    def reset(self) -> None:
        """Clear aggregates (not sinks) — test isolation."""
        with self._lock:
            self.counters.clear()
            self.histograms.clear()
            self.gauges.clear()


# The process-global registry every instrumented module records into.
REGISTRY = Registry()
