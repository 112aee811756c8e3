"""Cross-process trace stitching: one Perfetto timeline from N captures.

Port of ``spark_languagedetector_tpu.telemetry.stitch``; the same captures
give the same stitched JSON in both packages::

    python -m spark_languagedetector_tpu_torch.telemetry.stitch \
        router.jsonl replica-*.jsonl [-o out.trace.json]

:mod:`.tracing` renders one process's capture; this merges several into
one Chrome/Perfetto trace: one ``pid`` per capture (named by the recording
process's identity), a lane per recording thread within it, and every
timestamp shifted onto the coordinator's clock by the offset its
``telemetry.clock_sync`` events carry (the last handshake per replica
wins). Request flows join across processes by the ``trace_id`` the HTTP
payload carries: the router's ``fleet/dispatch`` span, the replica's
``serve/dispatch`` span and the runner's ``score/*`` spans all stamp it.
:func:`trace_flows` and :func:`nesting_slack_s` give the same join
programmatically: a child span can never outlast its parent in real
time, whatever the clocks said.

The clock-sync event is written by the coordinator of process replicas
(``scale/replica`` in the JAX package), which the port does not have yet:
a port capture carries none, so its offsets are 0 and captures of one
process (in-process replicas share its clock) stitch unshifted. A JAX
capture that carries them is read and aligned all the same.
"""

from __future__ import annotations

import json
import os
import sys
from collections import Counter

from .tracing import _DEVICE_LANE_BASE, _SPAN_FIELDS, _span_events

CLOCK_SYNC_EVENT = "telemetry.clock_sync"


# ------------------------------------------------------------ clock sync ----
def clock_offsets(events: list[dict]) -> dict[str, float]:
    """``replica name -> offset_s`` (coordinator clock − replica clock)
    from the coordinator capture's clock-sync events. The last handshake
    per name wins — a supervised restart re-syncs its replica."""
    offsets: dict[str, float] = {}
    for ev in events:
        if ev.get("event") != CLOCK_SYNC_EVENT:
            continue
        name, off = ev.get("replica"), ev.get("offset_s")
        if isinstance(name, str) and isinstance(off, (int, float)):
            offsets[name] = float(off)
    return offsets


def capture_label(events: list[dict], fallback: str) -> str:
    """Which process wrote this capture? The identity stamp on its span
    records answers for replica workers; a capture holding clock-sync
    events is the coordinator. Falls back to the file stem."""
    if any(ev.get("event") == CLOCK_SYNC_EVENT for ev in events):
        return "router"
    names = Counter(
        ev["replica"] for ev in _span_events(events)
        if isinstance(ev.get("replica"), str)
        and isinstance(ev.get("pid"), int)
    )
    if names:
        return names.most_common(1)[0][0]
    return fallback


def load_captures(paths: list[str]) -> list[dict]:
    """Load + label + clock-align captures. Returns, per file:
    ``{"label", "path", "events", "offset_s", "identity"}``; offsets come
    from whichever capture carries the clock-sync events (the
    coordinator's), keyed by the other captures' labels."""
    from .report import load_events

    raw = []
    for path in paths:
        events = load_events(path)
        stem = os.path.basename(path)
        stem = stem[:-6] if stem.endswith(".jsonl") else stem
        raw.append({"path": path, "events": events, "stem": stem})
    offsets: dict[str, float] = {}
    for cap in raw:
        offsets.update(clock_offsets(cap["events"]))
    out = []
    for cap in raw:
        label = capture_label(cap["events"], cap["stem"])
        identity: dict = {}
        for ev in _span_events(cap["events"]):
            if isinstance(ev.get("pid"), int):
                identity = {
                    k: ev[k] for k in ("replica", "pid", "platform")
                    if k in ev
                }
                break
        out.append({
            "label": label,
            "path": cap["path"],
            "events": cap["events"],
            "offset_s": offsets.get(label, 0.0),
            "identity": identity,
        })
    return out


# --------------------------------------------------------------- stitching --
def render_stitched_trace(captures: list[dict]) -> dict:
    """:func:`load_captures` output → Chrome trace-event JSON (dict).

    The single-capture exporter's conventions generalized per process:
    capture ordinal + 1 is the ``pid`` (named by the capture label),
    thread idents remap to dense per-process lane ordinals (device
    siblings at ``_DEVICE_LANE_BASE + lane``), timestamps shift by each
    capture's clock offset, become microseconds relative to the earliest
    aligned span start, and clamp per-lane monotonic."""
    trace_events: list[dict] = []
    per_proc: list[dict] = []
    t0: float | None = None
    for ordinal, cap in enumerate(captures):
        pid = ordinal + 1
        off = float(cap.get("offset_s") or 0.0)
        lane_ord: dict = {}
        lanes: dict[int, list[tuple[float, float, dict, bool]]] = {}
        lane_ident: dict[int, object] = {}
        for ev in _span_events(cap["events"]):
            ident = ev.get("tid")
            if not isinstance(ident, int):
                ident = 0
            lane = lane_ord.setdefault(ident, len(lane_ord))
            lane_ident[lane] = ident
            start = float(ev["ts"]) + off - float(ev["wall_s"])
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
        name = str(cap.get("label") or f"process {pid}")
        ident_blk = cap.get("identity") or {}
        if ident_blk.get("pid") is not None:
            name = f"{name} (pid {ident_blk['pid']})"
        trace_events.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": name}}
        )
        per_proc.append({
            "pid": pid, "off": off, "lanes": lanes,
            "lane_ident": lane_ident, "events": cap["events"],
        })
    if t0 is None:
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    for proc in per_proc:
        pid, lanes, lane_ident = (
            proc["pid"], proc["lanes"], proc["lane_ident"]
        )
        for lane in sorted(lanes):
            if lane >= _DEVICE_LANE_BASE:
                label = (
                    f"device (thread "
                    f"{lane_ident[lane - _DEVICE_LANE_BASE]})"
                )
            else:
                label = f"thread {lane_ident[lane]}"
            trace_events.append(
                {"name": "thread_name", "ph": "M", "pid": pid,
                 "tid": lane, "args": {"name": label}}
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
        for ev in proc["events"]:
            if ev.get("event") != "telemetry.snapshot":
                continue
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            ts_us = max((float(ts) + proc["off"] - t0) * 1e6, 0.0)
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
                        "name": str(gname), "ph": "C", "pid": proc["pid"],
                        "tid": 0, "ts": round(ts_us, 3), "args": numeric,
                    })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


# ------------------------------------------------------------ flow checks ---
def trace_flows(captures: list[dict]) -> dict[str, list[dict]]:
    """``trace_id -> [{"process", "path", "start_s", "wall_s"}, ...]``
    across every capture, clock-aligned — the programmatic form of the
    stitched timeline's request join."""
    flows: dict[str, list[dict]] = {}
    for cap in captures:
        off = float(cap.get("offset_s") or 0.0)
        label = str(cap.get("label"))
        for ev in _span_events(cap["events"]):
            tid = ev.get("trace_id")
            if not isinstance(tid, str):
                continue
            flows.setdefault(tid, []).append({
                "process": label,
                "path": ev["path"],
                "start_s": float(ev["ts"]) + off - float(ev["wall_s"]),
                "wall_s": float(ev["wall_s"]),
            })
    for spans in flows.values():
        spans.sort(key=lambda s: s["start_s"])
    return flows


def nesting_slack_s(spans: list[dict]) -> float | None:
    """Minimum parent-minus-child duration slack for one flow's
    router→replica→runner chain, or None when the chain is incomplete.

    Duration containment is clock-offset independent: the router's
    ``fleet/dispatch`` span encloses the replica's HTTP handling (which
    encloses its ``serve/dispatch``), and ``serve/dispatch`` encloses
    the runner's ``score/*`` work — in real time, whatever each
    process's wall clock reads. Non-negative slack is therefore the
    honest stitched-nesting gate."""
    router = [
        s["wall_s"] for s in spans
        if s["path"].split("/")[0] == "fleet"
        and s["path"].startswith("fleet/dispatch")
    ]
    replica = [
        s["wall_s"] for s in spans if s["path"] == "serve/dispatch"
    ]
    runner = [
        s["wall_s"] for s in spans
        if s["path"].startswith("serve/dispatch/") and "score" in s["path"]
    ]
    if not (router and replica and runner):
        return None
    return min(
        max(router) - max(replica),
        max(replica) - max(runner),
    )


def write_stitched_trace(paths: list[str], out_path: str) -> str:
    captures = load_captures(paths)
    trace = render_stitched_trace(captures)
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(trace, fh, default=str)
    os.replace(tmp, out_path)
    return out_path


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = None
    if "-o" in argv:
        i = argv.index("-o")
        if i + 1 >= len(argv):
            print("-o needs a path", file=sys.stderr)
            return 2
        out = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "usage: python -m spark_languagedetector_tpu_torch.telemetry.stitch "
            "<router.jsonl> [replica-*.jsonl ...] [-o out.trace.json]",
            file=sys.stderr,
        )
        return 2
    if out is None:
        src = argv[0]
        out = (
            (src[:-6] if src.endswith(".jsonl") else src) + ".stitched.json"
        )
    try:
        captures = load_captures(argv)
    except OSError as e:
        print(f"cannot load captures: {e}", file=sys.stderr)
        return 2
    trace = render_stitched_trace(captures)
    parent = os.path.dirname(os.path.abspath(out))
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(trace, fh, default=str)
    os.replace(tmp, out)
    flows = trace_flows(captures)
    cross = sum(
        1 for spans in flows.values()
        if len({s["process"] for s in spans}) > 1
    )
    print(out)
    print(
        f"stitched {len(captures)} captures, {len(flows)} traces "
        f"({cross} crossing processes)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
