"""Request tracing and Chrome/Perfetto trace export.

Port of ``spark_languagedetector_tpu.telemetry.tracing``, whole (with its own
JSONL reader in place of the JAX package's ``telemetry.report``).

Two halves of one feature — isolating *one request* out of an aggregate:

**Trace context.** A ``trace_id`` rides a :mod:`contextvars` variable the
same way the active span does. ``trace_request()`` opens a request scope
(reusing an ambient one by default, so a ``BatchRunner.score`` call inside
a streaming transform joins the stream batch's trace instead of starting
its own); every span opened inside the scope stamps ``trace_id`` onto its
exported JSONL record. Cross-thread work inherits the id through the
explicit span ``parent`` (a worker thread has no ambient context), so the
runner's dispatch workers and the streaming engine's prefetch workers
attribute correctly without touching the contextvar themselves.

**Chrome trace export.** ``render_chrome_trace`` turns a captured JSONL
event stream (the ``jsonl`` sink's output, or a flight-recorder dump)
into ``chrome://tracing`` / Perfetto trace-event JSON: one lane per
recording thread (plus a device lane for fenced spans, whose ``device_s``
covers completion rather than enqueue), span attrs — the trace id
included — in ``args``, and gauge snapshots as counter tracks. The CLI::

    python -m spark_languagedetector_tpu_torch.telemetry.tracing events.jsonl [out.json]

complements a device profiler (``torch.profiler``), which shows op-level
device timelines for one capture; this shows the host-side stage/request
timeline for a whole run, cheap enough to leave on.
"""

from __future__ import annotations

import contextvars
import json
import os
import sys
import uuid
from contextlib import contextmanager

_TRACE_ID: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "langdetect_trace_id", default=None
)


def new_trace_id() -> str:
    """16-hex random request/trace id (collision odds are irrelevant at
    per-request cardinality; short enough to grep and to read aloud)."""
    return uuid.uuid4().hex[:16]


def current_trace_id() -> str | None:
    """The calling context's active trace id, or None outside any request."""
    return _TRACE_ID.get()


@contextmanager
def trace_request(trace_id: str | None = None):
    """Open a request scope; yields the trace id spans will stamp.

    ``trace_id=None`` *reuses* an ambient scope when one is active (a
    score call inside a stream batch joins the batch's trace) and mints a
    fresh id otherwise. Passing an explicit id always (re)binds — the
    streaming engine passes one per source batch.
    """
    if trace_id is None:
        existing = _TRACE_ID.get()
        if existing is not None:
            yield existing
            return
        trace_id = new_trace_id()
    token = _TRACE_ID.set(trace_id)
    try:
        yield trace_id
    finally:
        _TRACE_ID.reset(token)


# ------------------------------------------------------- chrome export ------

# Synthetic lane offset for fenced device timings: a span whose device_s
# was recorded gets a second complete event on a per-source-thread device
# lane, so enqueue (host lane) and completion (device lane) read side by
# side without nesting one inside the other. Raw thread idents (pthread
# addresses on Linux — huge, collision-prone under any masking) are never
# used as lane ids; threads are remapped to small ordinals first.
_DEVICE_LANE_BASE = 1 << 20

# Span-record fields that are structural, not user attrs.
_SPAN_FIELDS = ("event", "ts", "path", "wall_s", "device_s", "tid")


def _span_events(events: list[dict]) -> list[dict]:
    return [
        e for e in events
        if e.get("event") == "telemetry.span"
        and isinstance(e.get("path"), str)
        and isinstance(e.get("wall_s"), (int, float))
        and isinstance(e.get("ts"), (int, float))
    ]


def render_chrome_trace(events: list[dict]) -> dict:
    """JSONL telemetry events → Chrome trace-event JSON (dict form).

    Timestamps are microseconds relative to the earliest span start. Each
    lane's events are sorted by start time and clamped non-decreasing, so
    the output is valid for viewers that require per-lane monotonic ``ts``
    (the captured ``ts`` is span *end* time; starts are reconstructed as
    ``ts - wall_s`` and can interleave across producers).
    """
    spans = _span_events(events)
    pid = 1
    trace_events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "spark_languagedetector_tpu_torch"}},
    ]
    if not spans:
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    # Thread idents are remapped to dense ordinals (first-seen order, by
    # earliest event): a host lane n and its device sibling
    # _DEVICE_LANE_BASE + n. Idents are only ever dict keys and labels —
    # a 140TB pthread address must not become a lane id, and masking one
    # could collide two real threads onto one lane.
    lane_ord: dict = {}
    lanes: dict[int, list[tuple[float, float, dict, bool]]] = {}
    lane_ident: dict[int, object] = {}
    t0 = None
    for ev in spans:
        ident = ev.get("tid")
        if not isinstance(ident, int):
            ident = 0
        lane = lane_ord.setdefault(ident, len(lane_ord))
        lane_ident[lane] = ident
        start = float(ev["ts"]) - float(ev["wall_s"])
        if t0 is None or start < t0:
            t0 = start
        lanes.setdefault(lane, []).append(
            (start, float(ev["wall_s"]), ev, False)
        )
        dev = ev.get("device_s")
        if isinstance(dev, (int, float)):
            lanes.setdefault(_DEVICE_LANE_BASE + lane, []).append(
                (start, float(dev), ev, True)
            )

    for lane in sorted(lanes):
        if lane >= _DEVICE_LANE_BASE:
            label = f"device (thread {lane_ident[lane - _DEVICE_LANE_BASE]})"
        else:
            label = f"thread {lane_ident[lane]}"
        trace_events.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": lane,
             "args": {"name": label}}
        )

    for lane, items in sorted(lanes.items()):
        items.sort(key=lambda it: it[0])
        last_us = 0.0
        for start, dur, ev, is_device in items:
            ts_us = max((start - t0) * 1e6, last_us)
            last_us = ts_us
            args = {
                k: v for k, v in ev.items() if k not in _SPAN_FIELDS
            }
            name = ev["path"] + (" [device]" if is_device else "")
            trace_events.append({
                "name": name, "cat": "span", "ph": "X", "pid": pid,
                "tid": lane, "ts": round(ts_us, 3),
                "dur": round(dur * 1e6, 3), "args": args,
            })

    # Gauge snapshots → counter tracks (Perfetto renders them as graphs).
    for ev in events:
        if ev.get("event") != "telemetry.snapshot":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        ts_us = max((float(ts) - t0) * 1e6, 0.0)
        for gname, series in (ev.get("gauges") or {}).items():
            if not isinstance(series, dict):
                continue
            numeric = {
                (k or "value"): v
                for k, v in series.items()
                if isinstance(v, (int, float))
            }
            if numeric:
                trace_events.append({
                    "name": str(gname), "ph": "C", "pid": pid, "tid": 0,
                    "ts": round(ts_us, 3), "args": numeric,
                })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def load_events(path: str) -> list[dict]:
    """Parse one JSONL capture, skipping blank or unparseable lines (a
    truncated tail from a killed run must not void the trace)."""
    events: list[dict] = []
    bad = 0
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(obj, dict):
                events.append(obj)
    if bad:
        print(f"(skipped {bad} unparseable line(s))", file=sys.stderr)
    return events


def write_chrome_trace(events_path: str, out_path: str) -> str:
    """Convert one JSONL capture to a Chrome trace file; returns out_path."""
    trace = render_chrome_trace(load_events(events_path))
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(trace, fh, default=str)
    os.replace(tmp, out_path)
    return out_path


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not 1 <= len(argv) <= 2 or argv[0] in ("-h", "--help"):
        print(
            "usage: python -m spark_languagedetector_tpu_torch.telemetry.tracing "
            "<events.jsonl> [out.trace.json]",
            file=sys.stderr,
        )
        return 2
    src = argv[0]
    out = argv[1] if len(argv) == 2 else (
        (src[:-6] if src.endswith(".jsonl") else src) + ".trace.json"
    )
    try:
        path = write_chrome_trace(src, out)
    except OSError as e:
        print(f"cannot convert {src}: {e}", file=sys.stderr)
        return 2
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
