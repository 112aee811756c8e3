"""Profiler traces around a region, through ``torch.profiler``.

Port of ``spark_languagedetector_tpu.utils.profiling``, with
``torch.profiler.profile`` in place of ``jax.profiler.trace``::

    with trace("/tmp/langdetect-trace"):
        model.transform(table)

or with no code change: set ``LANGDETECT_TRACE_DIR`` (the ``trace_dir``
knob) and every ``BatchRunner.score`` call traces itself. The profiler
records CPU activity and, where a CUDA device is present, every kernel of
the process on the card (the hand-written kernels launched through
``ctypes`` included), and the region's Chrome trace lands in
``<dir>/trace.json`` (open it in Perfetto or ``chrome://tracing``). A
``label`` puts each capture in its own ``<dir>/<label>-<seq>/``, so
repeated captures never overwrite one another.

Each capture also records a ``profile/trace`` span, so profiler runs show
in the stage tree beside the stages they profiled.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager

from .logging import get_logger, log_event

_log = get_logger("utils.profiling")

TRACE_DIR_ENV = "LANGDETECT_TRACE_DIR"
TRACE_FILE = "trace.json"

# Process-wide capture sequence: labelled captures land in distinct
# directories across threads and call sites.
_TRACE_SEQ = itertools.count()


@contextmanager
def trace(log_dir: str | None = None, label: str | None = None):
    """Profile the enclosed region into ``log_dir`` (or the ``trace_dir``
    knob); a no-op when neither is set, so hot call sites can wrap a region
    unconditionally. Yields the capture's directory (None when off). The
    trace is written, and the ``profile/trace`` span recorded, even when
    the region raises; the region's error is what propagates."""
    if log_dir is None:
        from ..exec import config as exec_config

        log_dir = exec_config.resolve("trace_dir")
    if not log_dir:
        yield None
        return
    if label:
        log_dir = os.path.join(log_dir, f"{label}-{next(_TRACE_SEQ):04d}")
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..telemetry import REGISTRY, current_trace_id

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    region_failed = False
    t0 = time.perf_counter()
    try:
        with prof:
            log_event(_log, "profiling.trace_start", dir=log_dir)
            yield log_dir
    except BaseException:
        region_failed = True
        raise
    finally:
        try:
            prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
        except Exception:
            if not region_failed:
                raise
        finally:
            # Recorded directly, not as an enclosing span(): an ambient
            # profile/trace span would become the parent of every span in
            # the region and re-root the stage tree (profile/trace/score/...),
            # breaking the cost-gauge join and stage matching across
            # captures.
            attrs = {"dir": log_dir, "tid": threading.get_ident()}
            tid = current_trace_id()
            if tid is not None:
                attrs["trace_id"] = tid
            REGISTRY.record_span("profile/trace", time.perf_counter() - t0, None, attrs)
            log_event(_log, "profiling.trace_done", dir=log_dir)
