"""Hierarchical spans: nestable timing context managers with device fencing.

Port of ``spark_languagedetector_tpu.telemetry.spans``: the same paths, the
same attribute stamping, and fencing on CUDA events.

A span times one stage of a pipeline and records into the registry under a
slash path (``"score/pack"``). Nesting builds the path: within
``span("score")``, ``span("pack")`` records as ``score/pack``. A name that
already carries the parent's path as a prefix is used verbatim, so call
sites may name spans by full path (``span("score/pack")``) and still nest
correctly under ``span("score")`` — and work standalone as roots too.

Threading: the active span is a :mod:`contextvars` variable, so each thread
nests independently and a worker thread starts with no active span. Work
submitted to a pool attaches to the submitting stage by passing the parent
explicitly (``span("stream/transform", parent=root)``) — the streaming
engine's prefetch workers do exactly this. Aggregation is by path into the
registry's histograms, so concurrent children of one parent can never
corrupt any shared tree structure: there is none to corrupt.

Device fencing: CUDA launches are asynchronous — a span around a dispatch
measures enqueue time, not execution. ``sp.fence(tensors)`` registers
result tensors to wait on at span exit; when fencing is enabled (argument
``fence=True`` or env ``LANGDETECT_TELEMETRY_FENCE=1``) the span records an
event on each CUDA tensor's current stream, waits for it, and records
``device_s`` (wall through device completion) alongside ``wall_s``. CPU
tensors are complete when they exist. Fencing serializes the pipeline, so
it is opt-in — a profiling mode, not a production default.

Clock: an exported span event's ``ts`` is the host's wall clock (epoch
seconds) at ``start + wall_s``, where the start is read beside the span's
first perf-counter reading, so ``[ts - wall_s, ts]`` is exactly the host's
time inside the span. ``wall_s`` stops before the fence wait: under
fencing, the wait is the parent span's time, not this one's.
"""

from __future__ import annotations

import contextvars
import threading
import time
from contextlib import contextmanager

from .registry import REGISTRY, Registry
from .tracing import current_trace_id

FENCE_ENV = "LANGDETECT_TELEMETRY_FENCE"

_ACTIVE: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "langdetect_active_span", default=None
)
_UNSET = object()


def current_span() -> "Span | None":
    """The calling thread's innermost open span (None outside any span).

    Capture this before handing work to another thread, then pass it as
    ``span(..., parent=captured)`` so the worker's spans attach to the
    right node instead of becoming parentless roots.
    """
    return _ACTIVE.get()


class Span:
    """One open timing region. Created by :func:`span`, not directly."""

    __slots__ = ("name", "path", "parent", "attrs", "trace_id", "_fences")

    def __init__(self, name: str, path: str, parent: "Span | None", attrs: dict):
        self.name = name
        self.path = path
        self.parent = parent
        self.attrs = attrs
        # Request attribution: the ambient trace context wins (a stream
        # batch's per-request scope overrides the engine root's), the
        # explicit parent's id is the cross-thread fallback (worker
        # threads have no ambient context of their own).
        self.trace_id = current_trace_id() or (
            parent.trace_id if parent is not None else None
        )
        self._fences: list = []

    def fence(self, *arrays) -> None:
        """Register device tensors to wait on at span exit (when fencing is
        enabled). Accepts None entries so call sites need no conditionals."""
        self._fences.extend(a for a in arrays if a is not None)

    def set(self, **attrs) -> None:
        """Attach/overwrite event fields visible in the exported record."""
        self.attrs.update(attrs)


def _wait(t) -> None:
    """Block until the work queued so far on ``t``'s CUDA stream (the
    current stream of its device, which every launch of the port uses) is
    done: one event recorded there and waited on."""
    if not getattr(t, "is_cuda", False):
        return
    import torch

    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    ev.synchronize()


def _fencing_enabled(flag: bool | None) -> bool:
    if flag is not None:
        return flag
    # Resolved through exec/config's audited table (lazily: spans import
    # before the exec package exists). A malformed value means "off" —
    # fencing is a profiling mode, and raising here would fail every
    # span() on the hot path — but still surfaces as an ``error`` row in
    # /varz effective_config.
    from ..exec import config as exec_config

    try:
        return bool(exec_config.resolve("telemetry_fence"))
    except ValueError:
        return False


def _resolve_path(name: str, parent: "Span | None") -> str:
    if parent is None:
        return name
    if name.startswith(parent.path + "/"):
        return name
    # Full-path call-site names under a re-rooted parent: "score/pack"
    # inside a "score" root that is itself nested (stream/transform/score)
    # merges on the shared segment → stream/transform/score/pack, never
    # .../score/score/pack.
    first, sep, rest = name.partition("/")
    if sep and parent.path.rsplit("/", 1)[-1] == first:
        return parent.path + "/" + rest
    return parent.path + "/" + name


@contextmanager
def span(
    name: str,
    *,
    parent=_UNSET,
    registry: Registry | None = None,
    fence: bool | None = None,
    **attrs,
):
    """Open a timing span; on exit, record wall (and fenced device) seconds.

    ``parent``: defaults to the thread's current span; pass an explicit
    span (or None) for cross-thread attachment. ``fence``: tri-state —
    None defers to ``LANGDETECT_TELEMETRY_FENCE``. Extra keyword args ride
    along as fields on the exported span event.
    """
    reg = registry if registry is not None else REGISTRY
    par = current_span() if parent is _UNSET else parent
    sp = Span(name, _resolve_path(name, par), par, dict(attrs))
    token = _ACTIVE.set(sp)
    start_epoch = time.time()
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        wall_s = time.perf_counter() - t0
        device_s = None
        if sp._fences and _fencing_enabled(fence):
            for arr in sp._fences:
                try:
                    _wait(arr)
                except Exception:
                    pass  # fencing must never mask the real error path
            device_s = time.perf_counter() - t0
        _ACTIVE.reset(token)
        # Stamped at exit so the exported record carries the request id and
        # the recording thread (the Chrome-trace exporter's lane key);
        # explicit attrs of the same name win.
        if sp.trace_id is not None:
            sp.attrs.setdefault("trace_id", sp.trace_id)
        sp.attrs.setdefault("tid", threading.get_ident())
        reg.record_span(sp.path, wall_s, device_s, sp.attrs, ts=start_epoch + wall_s)
