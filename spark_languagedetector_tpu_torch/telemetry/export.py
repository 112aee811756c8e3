"""Exporters: JSONL event sink and Prometheus text-format snapshots.

Port of ``spark_languagedetector_tpu.telemetry.export``: the same sink
spec, the same event shape, metric names and label escaping, so a capture
or a scrape of the port reads like one of the JAX package.

Selected by ``LANGDETECT_METRICS_SINK`` — a comma list of ``kind:path``
entries, e.g.::

    LANGDETECT_METRICS_SINK=jsonl:/tmp/telemetry.jsonl,prom:/tmp/metrics.prom

``jsonl`` appends one JSON object per telemetry event (span exits, snapshot
flushes) in the same shape ``utils.logging.log_event`` emits — an ``event``
discriminator plus a float ``ts``. Timestamps are forced strictly
increasing per sink (concurrent producers can otherwise collide within
clock resolution), so a consumer may treat the file as an ordered event
log.

``prom`` writes a full Prometheus text-format snapshot of the registry on
every :meth:`Registry.flush` (atomic rename, so scrapers never read a torn
file). Spans export as summaries with p50/p90/p99 quantiles; counters and
gauges export under one metric name each with a ``name`` label — paths
like ``score/pack`` are not valid Prometheus metric names, labels are.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

from .registry import Registry

SINK_ENV = "LANGDETECT_METRICS_SINK"


class JsonlSink:
    """Append-only JSONL event sink with strictly increasing timestamps."""

    kind = "jsonl"

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._last_ts = 0.0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    def emit(self, event: dict) -> None:
        with self._lock:
            ts = float(event.get("ts", 0.0)) or time.time()
            if ts <= self._last_ts:
                ts = math.nextafter(self._last_ts, math.inf)
            self._last_ts = ts
            record = {**event, "ts": ts}
            self._fh.write(json.dumps(record, default=str) + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except ValueError:
                pass


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt(value: float) -> str:
    if isinstance(value, float) and math.isnan(value):
        return "NaN"
    return repr(float(value))


def render_prometheus(registry: Registry) -> str:
    """Registry snapshot as Prometheus text exposition format."""
    snap = registry.snapshot()
    lines: list[str] = []

    span_hists = {
        name[len("span:"):]: h
        for name, h in snap["histograms"].items()
        if name.startswith("span:")
    }
    # Fenced device timings (wall through device completion) — without this
    # block the data fencing exists to capture would be reachable only by
    # grepping raw JSONL events.
    device_hists = {
        name[len("span_device:"):]: h
        for name, h in snap["histograms"].items()
        if name.startswith("span_device:")
    }
    plain_hists = {
        name: h
        for name, h in snap["histograms"].items()
        if not name.startswith(("span:", "span_device:"))
    }
    for metric, hists in (
        ("langdetect_span_seconds", span_hists),
        ("langdetect_span_device_seconds", device_hists),
    ):
        if not hists:
            continue
        lines.append(f"# TYPE {metric} summary")
        for path, h in sorted(hists.items()):
            lbl = f'path="{_escape_label(path)}"'
            for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                if key in h:
                    lines.append(
                        f'{metric}{{{lbl},quantile="{q}"}} {_fmt(h[key])}'
                    )
            lines.append(f"{metric}_sum{{{lbl}}} {_fmt(h['sum'])}")
            lines.append(f"{metric}_count{{{lbl}}} {h['count']}")
    if plain_hists:
        lines.append("# TYPE langdetect_metric summary")
        for name, h in sorted(plain_hists.items()):
            lbl = f'name="{_escape_label(name)}"'
            for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                if key in h:
                    lines.append(
                        f'langdetect_metric{{{lbl},quantile="{q}"}} '
                        f"{_fmt(h[key])}"
                    )
            lines.append(f"langdetect_metric_sum{{{lbl}}} {_fmt(h['sum'])}")
            lines.append(f"langdetect_metric_count{{{lbl}}} {h['count']}")
    if snap["counters"]:
        lines.append("# TYPE langdetect_counter_total counter")
        for name, value in sorted(snap["counters"].items()):
            lines.append(
                f'langdetect_counter_total{{name="{_escape_label(name)}"}} '
                f"{value}"
            )
    gauge_series = registry.gauge_series()
    if gauge_series:
        lines.append("# TYPE langdetect_gauge gauge")
        for name, series in sorted(gauge_series.items()):
            for label_dict, value in sorted(
                series, key=lambda kv: sorted(kv[0].items())
            ):
                labels = [f'name="{_escape_label(name)}"']
                for k, v in sorted(label_dict.items()):
                    labels.append(f'{k}="{_escape_label(v)}"')
                lines.append(
                    f"langdetect_gauge{{{','.join(labels)}}} {_fmt(value)}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(registry: Registry, path: str) -> str:
    """Atomically write the registry's Prometheus snapshot; returns path."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(render_prometheus(registry))
    os.replace(tmp, path)
    return path


class PrometheusSnapshotSink:
    """Snapshot-style sink: rewrites its file on every registry flush."""

    kind = "prom"

    def __init__(self, path: str):
        self.path = path

    def write_snapshot(self, registry: Registry) -> None:
        write_prometheus(registry, self.path)

    def close(self) -> None:
        pass


_SINK_KINDS = {"jsonl": JsonlSink, "prom": PrometheusSnapshotSink}


def parse_sink_spec(spec: str) -> list[tuple[str, str]]:
    """``"jsonl:/a.jsonl,prom:/b.prom"`` → [("jsonl", "/a.jsonl"), ...].

    Unknown kinds raise ValueError — a typo'd env var should be loud, not a
    silently metric-less run.
    """
    out: list[tuple[str, str]] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, sep, path = entry.partition(":")
        if not sep or not path or kind not in _SINK_KINDS:
            raise ValueError(
                f"bad {SINK_ENV} entry {entry!r}; expected kind:path with "
                f"kind in {sorted(_SINK_KINDS)}"
            )
        out.append((kind, path))
    return out


def configure_sinks_from_env(registry: Registry, env=os.environ) -> list:
    """Attach the sinks ``LANGDETECT_METRICS_SINK`` declares; returns them.

    All-or-nothing: every sink is constructed before any is attached, so a
    failing entry (unwritable path) can't leave a partial capture running
    behind an "env var ignored" warning. The knob resolves through
    exec/config's audited table (lazily — this armed at package import).
    """
    from ..exec import config as exec_config

    spec = exec_config.resolve("metrics_sink", env=env) or ""
    if not spec:
        return []
    sinks: list = []
    try:
        for kind, path in parse_sink_spec(spec):
            sinks.append(_SINK_KINDS[kind](path))
    except Exception:
        for s in sinks:
            close = getattr(s, "close", None)
            if close:
                close()
        raise
    for s in sinks:
        registry.add_sink(s)
    return sinks
