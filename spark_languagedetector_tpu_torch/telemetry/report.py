"""Stage-tree report CLI over a telemetry JSONL capture.

Port of ``spark_languagedetector_tpu.telemetry.report``; on the same
capture both packages print the same text, so either reads the other's
captures::

    python -m spark_languagedetector_tpu_torch.telemetry.report <events.jsonl>

Reads the JSONL event stream the ``jsonl`` sink appends, aggregates the
``telemetry.span`` records by slash path, and renders the stage tree with
per-stage count, total/mean seconds and p50/p90/p99. Counter, gauge and
histogram state from the last ``telemetry.snapshot`` event follows the
tree, then the recovery counters and gauges pulled out on their own.

Standard library and the registry's :class:`~.registry.Histogram` only:
it needs no card and imports no torch op.
"""

from __future__ import annotations

import sys

from .registry import Histogram
from .tracing import load_events

__all__ = ["aggregate_spans", "load_events", "main", "render_report"]


def aggregate_spans(events: list[dict]) -> dict[str, Histogram]:
    """path -> Histogram of wall_s over every telemetry.span record."""
    stages: dict[str, Histogram] = {}
    for ev in events:
        if ev.get("event") != "telemetry.span":
            continue
        path = ev.get("path")
        wall = ev.get("wall_s")
        if not isinstance(path, str) or not isinstance(wall, (int, float)):
            continue
        hist = stages.get(path)
        if hist is None:
            hist = stages[path] = Histogram()
        hist.record(float(wall))
    return stages


def _tree_rows(stages: dict[str, Histogram]):
    """(indented label, path, histogram or None) rows in tree order. A
    path segment that never recorded a span of its own (only ``score/pack``,
    no bare ``score``) still renders as a header."""
    all_paths = set()
    for path in stages:
        parts = path.split("/")
        for i in range(1, len(parts) + 1):
            all_paths.add("/".join(parts[:i]))
    for path in sorted(all_paths):
        depth = path.count("/")
        label = "  " * depth + path.rsplit("/", 1)[-1]
        yield label, path, stages.get(path)


_RESILIENCE_COUNTERS = ("score/retries", "stream/retries")
_RESILIENCE_GAUGES = (
    "langdetect_breaker_state",
    "langdetect_degraded",
    "langdetect_dlq_rows",
    "langdetect_retry_attempts",
)


def _resilience_summary(counters, gauges) -> list[str]:
    """The recovery block's lines; [] when the capture has no such signal."""
    out: list[str] = []
    if isinstance(counters, dict):
        for name in sorted(counters, key=str):
            if str(name).startswith("resilience/") or str(name) in _RESILIENCE_COUNTERS:
                out.append(f"  {str(name):<40} {counters[name]}")
    if isinstance(gauges, dict):
        for name in _RESILIENCE_GAUGES:
            series = gauges.get(name)
            if not isinstance(series, dict):
                continue
            for labels in sorted(series, key=str):
                tag = f"{name}{{{labels}}}" if labels else name
                out.append(f"  {tag:<40} {series[labels]}")
    return out


def render_report(events: list[dict]) -> str:
    stages = aggregate_spans(events)
    lines: list[str] = []
    if stages:
        header = (
            f"{'stage':<32} {'count':>7} {'total_s':>10} {'mean_s':>9} "
            f"{'p50_s':>9} {'p90_s':>9} {'p99_s':>9}"
        )
        lines.append(header)
        lines.append("-" * len(header))
        for label, _path, hist in _tree_rows(stages):
            if hist is None:
                lines.append(label)
                continue
            s = hist.snapshot()
            lines.append(
                f"{label:<32} {s['count']:>7} {s['sum']:>10.4f} "
                f"{s['mean']:>9.5f} {s['p50']:>9.5f} {s['p90']:>9.5f} "
                f"{s['p99']:>9.5f}"
            )
    else:
        lines.append("no span events found")

    snapshots = [e for e in events if e.get("event") == "telemetry.snapshot"]
    if snapshots:
        # A capture may be hand-edited, truncated or written by a newer
        # schema: a malformed section skips its entry, it never raises.
        last = snapshots[-1]
        hists = last.get("histograms")
        if isinstance(hists, dict) and hists:
            rendered = []
            for name in sorted(hists, key=str):
                h = hists[name]
                if not isinstance(h, dict) or not h.get("count"):
                    continue
                try:
                    rendered.append(
                        f"  {str(name):<32} n={h['count']:<7} "
                        f"mean={float(h.get('mean', 0.0)):.5f} "
                        f"p50={float(h.get('p50', 0.0)):.5f} "
                        f"p99={float(h.get('p99', 0.0)):.5f}"
                    )
                except (TypeError, ValueError):
                    continue
            if rendered:
                lines.append("")
                lines.append("histograms (last snapshot):")
                lines.extend(rendered)
        counters = last.get("counters")
        if isinstance(counters, dict) and counters:
            lines.append("")
            lines.append("counters (last snapshot):")
            for name in sorted(counters, key=str):
                lines.append(f"  {str(name):<40} {counters[name]}")
        gauges = last.get("gauges")
        if isinstance(gauges, dict) and gauges:
            rendered = []
            for name in sorted(gauges, key=str):
                series = gauges[name]
                if not isinstance(series, dict):
                    continue
                for labels in sorted(series, key=str):
                    tag = f"{name}{{{labels}}}" if labels else str(name)
                    rendered.append(f"  {tag:<40} {series[labels]}")
            if rendered:
                lines.append("")
                lines.append("gauges (last snapshot):")
                lines.extend(rendered)
        res = _resilience_summary(counters, gauges)
        if res:
            lines.append("")
            lines.append("resilience (last snapshot):")
            lines.extend(res)
    if not events:
        return "empty capture: no telemetry events"
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print(
            "usage: python -m spark_languagedetector_tpu_torch.telemetry.report "
            "<events.jsonl>",
            file=sys.stderr,
        )
        return 2
    try:
        events = load_events(argv[0])
    except OSError as e:
        print(f"cannot read {argv[0]}: {e}", file=sys.stderr)
        return 2
    print(render_report(events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
