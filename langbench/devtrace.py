"""The traced window: the device's activity from ``torch.profiler`` and the
program's spans, on one clock.

The profiler records the device's kernels, copies and sets (CUPTI); the
program's spans arrive through a sink on its telemetry registry, stamped
with the host's wall clock. A marker kernel launched as the profiler starts
ties that clock to the profiler's.

From these records :func:`summarize` gives what the per-layer metrics read:

- ``busy_s``: the time in which at least one operation ran on the device
  (the union of their intervals) inside the window; ``window_s`` its length;
- ``kernel_s``: the summed time of every kernel (copies and sets left out);
- ``device_ops``: time per operation name, largest first;
- ``idle_gaps``: the device's idle time inside the window, summed by what
  the host was doing meanwhile (the innermost program span open, else the
  harness's call, else ``harness``), largest first.

The arithmetic of device time by kernel name follows ``chip_smoke.py``'s
``device_breakdown`` and ``trace_kernel_ms``, read here from the raw
profiler events instead of a written trace.
"""

from __future__ import annotations

import time

import numpy as np

class SpanSink:
    """Collects the program's span events (``path``, ``wall_s`` and the
    wall-clock ``ts`` at the span's end) while attached."""

    def __init__(self):
        self.spans: list[dict] = []

    def emit(self, event: dict) -> None:
        if event.get("event") == "telemetry.span":
            self.spans.append({"path": event["path"], "wall_s": float(event["wall_s"]),
                               "end": float(event["ts"])})


class DeviceTrace:
    """``torch.profiler`` over the window, the device's activity only (no
    host ops, so the host pays little for the trace). ``offset_ns`` maps the
    host's wall clock (ns) onto the profiler's: a marker kernel launched on
    an idle device right after a host timestamp is the first device event
    of the trace."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.offset_ns = 0
        self.events = []

    def __enter__(self):
        import torch

        self.prof.__enter__()
        torch.cuda.synchronize()
        self._mark_wall = time.time_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        events = sorted(
            ((e.name(), e.start_ns(), e.duration_ns())
             for e in self.prof.profiler.kineto_results.events()
             if e.device_type().name == "CUDA" and e.duration_ns() > 0),
            key=lambda ev: ev[1],
        )
        if events:
            self.offset_ns = events[0][1] - self._mark_wall
            events = events[1:]
        self.events = events
        return False


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_labels(times_ns, spans, calls, offset_ns: int, entry: str) -> list[str]:
    """What the host was doing at each of ``times_ns`` (ascending): the
    innermost (shortest) program span open then, else the harness's call,
    else ``harness``."""
    t = np.asarray(times_ns, dtype=np.float64)
    label = np.full(t.size, -1, dtype=np.int64)
    best = np.full(t.size, np.inf)
    names = [f"{entry} (outside the program's spans)"]
    intervals = [(c["epoch0"], c["epoch1"], np.inf, 0) for c in calls]
    for s in spans:
        names.append(s["path"])
        intervals.append((s["end"] - s["wall_s"], s["end"], s["wall_s"], len(names) - 1))
    for start, end, wall, name in intervals:
        i0, i1 = np.searchsorted(t, [start * 1e9 + offset_ns, end * 1e9 + offset_ns])
        sl = slice(i0, i1)
        take = (wall < best[sl]) | (label[sl] < 0)
        best[sl] = np.where(take, wall, best[sl])
        label[sl] = np.where(take, name, label[sl])
    return [names[i] if i >= 0 else "harness" for i in label]


def _idle_before(busy, w0: float, t: np.ndarray) -> np.ndarray:
    """Idle nanoseconds in ``[w0, t)`` given the merged busy intervals."""
    if not busy:
        return t - w0
    starts = np.array([b[0] for b in busy], dtype=np.float64)
    lens = np.array([b[1] - b[0] for b in busy], dtype=np.float64)
    before = np.concatenate([[0.0], np.cumsum(lens)])
    i = np.searchsorted(starts, t, side="right") - 1
    partial = np.where(i >= 0, np.clip(t - starts[np.maximum(i, 0)], 0.0, lens[np.maximum(i, 0)]), 0.0)
    return (t - w0) - (before[np.maximum(i, 0)] * (i >= 0) + partial)


def summarize(trace: DeviceTrace, spans, calls, entry: str, top: int = 10) -> dict:
    off = trace.offset_ns
    w0 = calls[0]["epoch0"] * 1e9 + off
    w1 = calls[-1]["epoch1"] * 1e9 + off
    inside = [(n, max(s, w0), min(s + d, w1)) for n, s, d in trace.events if s < w1 and s + d > w0]
    busy = _union([(s, e) for _, s, e in inside])
    by_name: dict[str, float] = {}
    kernel_ns = 0
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        if not n.startswith(("Memcpy", "Memset")):
            kernel_ns += e - s
    # The host's timeline cut at every span's and call's edge; each piece
    # takes the label of what the host was doing in it and the device's
    # idle time inside it.
    edges = {w0, w1}
    for c in calls:
        edges.update((c["epoch0"] * 1e9 + off, c["epoch1"] * 1e9 + off))
    for sp in spans:
        edges.update(((sp["end"] - sp["wall_s"]) * 1e9 + off, sp["end"] * 1e9 + off))
    cuts = np.array(sorted(e for e in edges if w0 <= e <= w1), dtype=np.float64)
    idle = np.diff(_idle_before(busy, w0, cuts))
    gaps: dict[str, float] = {}
    for label, ns in zip(_host_labels((cuts[:-1] + cuts[1:]) / 2, spans, calls, off, entry), idle):
        if ns > 0:
            gaps[label] = gaps.get(label, 0.0) + ns / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "device_ops": [[n[:160], v / 1e9] for n, v in ops],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top],
    }
