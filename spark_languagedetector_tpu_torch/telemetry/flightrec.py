"""Flight recorder: a bounded ring of recent telemetry, dumped on crash.

Port of ``spark_languagedetector_tpu.telemetry.flightrec``, whole.

A post-mortem needs the events *leading up to* the failure, but leaving a
full JSONL sink on forever costs disk proportional to uptime. The flight
recorder is the middle ground: it attaches to the registry as an ordinary
per-event sink, keeps only the most recent ``capacity`` span/snapshot
events in memory (a deque append — no I/O on the hot path), and writes
them all to a JSONL post-mortem file only when a score or segment entry
point actually raises (their ``except`` hooks call :func:`record_crash`).

Gated by ``LANGDETECT_FLIGHT_RECORDER``: ``1`` enables with a default
directory under the system tmpdir, any other non-empty value is the dump
directory. ``LANGDETECT_FLIGHT_RECORDER_EVENTS`` overrides the ring
capacity. Every failure path is contained — a
post-mortem writer that can take down the computation it observes would
be worse than no recorder at all (drops are counted under
``telemetry/flightrec_errors`` and warned once).

The dump file is an ordinary telemetry JSONL capture (with one
``flightrec.dump`` header line), so the ``report`` CLI renders it and the
``tracing`` CLI turns it into a Perfetto timeline of the final moments.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from collections import deque

from .registry import REGISTRY, Registry

FLIGHT_ENV = "LANGDETECT_FLIGHT_RECORDER"
CAPACITY_ENV = "LANGDETECT_FLIGHT_RECORDER_EVENTS"
DEFAULT_CAPACITY = 2048


class FlightRecorder:
    """Ring-buffer sink; ``dump()`` writes the ring as a JSONL post-mortem."""

    kind = "flightrec"

    def __init__(self, out_dir: str, capacity: int = DEFAULT_CAPACITY):
        self.out_dir = out_dir
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._seq = 0

    def emit(self, event: dict) -> None:
        with self._lock:
            self._ring.append(event)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, context: str = "unknown", error: str | None = None) -> str:
        """Write the ring (oldest first) to a fresh post-mortem file."""
        with self._lock:
            events = list(self._ring)
            self._seq += 1
            seq = self._seq
        os.makedirs(self.out_dir, exist_ok=True)
        tag = re.sub(r"[^A-Za-z0-9_.-]+", "_", context) or "unknown"
        path = os.path.join(
            self.out_dir, f"flightrec-{tag}-{os.getpid()}-{seq}.jsonl"
        )
        header = {
            "event": "flightrec.dump",
            "ts": time.time(),
            "context": context,
            "error": error,
            "events": len(events),
        }
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(header, default=str) + "\n")
            for ev in events:
                fh.write(json.dumps(ev, default=str) + "\n")
        return path

    def close(self) -> None:
        pass


# Process-global recorder (one per process, like the env-declared sinks).
_recorder: FlightRecorder | None = None
_last_dump: str | None = None
_warned = False

# A crash that unwinds through nested entry points (score inside a stream
# batch) must dump once, not once per except hook on the way out. The
# dumped exception is marked with this attribute — per-object, so a later
# unrelated exception can never be mistaken for an already-dumped one
# (address-based dedup would break on CPython's eager id reuse, and
# builtin exceptions refuse weakrefs).
_DUMPED_ATTR = "_langdetect_flightrec_dumped"


def active() -> FlightRecorder | None:
    return _recorder


def last_dump_path() -> str | None:
    """Path of the most recent post-mortem this process wrote, if any."""
    return _last_dump


def install(
    out_dir: str,
    capacity: int = DEFAULT_CAPACITY,
    registry: Registry | None = None,
) -> FlightRecorder:
    """Attach a recorder to the registry and make it the crash target.
    Idempotent per process: a second install returns the existing one."""
    global _recorder
    if _recorder is not None:
        return _recorder
    rec = FlightRecorder(out_dir, capacity)
    (registry if registry is not None else REGISTRY).add_sink(rec)
    _recorder = rec
    return rec


def uninstall(registry: Registry | None = None) -> None:
    """Detach the process recorder (tests and the bench smoke path)."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is not None:
        (registry if registry is not None else REGISTRY).remove_sink(rec)


def install_from_env(
    registry: Registry | None = None, env=os.environ
) -> FlightRecorder | None:
    """Install per ``LANGDETECT_FLIGHT_RECORDER``; None when unset/disabled.

    Knobs resolve through exec/config's audited table (lazily — this is
    armed at package import). A malformed capacity keeps the default:
    the recorder is a crash diagnostic, and refusing to arm it over a
    typo would lose exactly the dump the typo'd run needed.
    """
    from ..exec import config as exec_config

    spec = (exec_config.resolve("flight_recorder", env=env) or "").strip()
    if not spec or spec.lower() in ("0", "false"):
        return None
    if spec.lower() in ("1", "true"):
        out_dir = os.path.join(tempfile.gettempdir(), "langdetect-flightrec")
    else:
        out_dir = spec
    try:
        capacity = exec_config.resolve("flight_recorder_events", env=env)
    except ValueError:
        capacity = DEFAULT_CAPACITY
    return install(out_dir, capacity, registry)


def record_crash(
    context: str, exc: BaseException | None = None,
    registry: Registry | None = None,
) -> str | None:
    """Dump the ring for one failing entry point; contained, never raises.

    Returns the post-mortem path (None when no recorder is installed, the
    same exception was already dumped by an inner hook, or the write
    itself failed — counted + warned once, like exporter sink errors).
    """
    global _last_dump, _warned
    rec = _recorder
    if rec is None:
        return None
    if exc is not None and getattr(exc, _DUMPED_ATTR, False):
        return None
    reg = registry if registry is not None else REGISTRY
    try:
        path = rec.dump(context=context, error=repr(exc) if exc else None)
    except Exception as e:
        reg.incr("telemetry/flightrec_errors")
        if not _warned:
            _warned = True
            import warnings

            warnings.warn(
                f"flight recorder dump failed, post-mortem lost: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
        return None
    if exc is not None:
        try:
            setattr(exc, _DUMPED_ATTR, True)
        except Exception:
            pass  # __slots__-only exception: nested hooks may double-dump
    _last_dump = path
    reg.incr("telemetry/flightrec_dumps")
    return path
