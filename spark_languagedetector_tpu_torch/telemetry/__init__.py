"""Telemetry core of the port: the registry, spans, request traces and the
flight recorder, under the JAX package's names.

Port of the part of ``spark_languagedetector_tpu.telemetry`` that the
runner itself calls:

  * :data:`REGISTRY` (:mod:`.registry`) — counters, deterministic-reservoir
    histograms with p50/p90/p99, gauges and span aggregates, one lock;
  * :func:`span` (:mod:`.spans`) — nestable timing regions keyed by slash
    paths (``"score/pack"``), optionally fenced on the card
    (``LANGDETECT_TELEMETRY_FENCE``);
  * :func:`trace_request` (:mod:`.tracing`) — a ``trace_id`` per request,
    stamped onto every span record, and the Chrome/Perfetto trace CLI::

        python -m spark_languagedetector_tpu_torch.telemetry.tracing events.jsonl [out.json]

  * :mod:`.flightrec` — a bounded ring of recent events, dumped as a JSONL
    post-mortem when a score call raises (``LANGDETECT_FLIGHT_RECORDER``).

Exporters, device gauges, cost models, fleet aggregation, SLOs and the
report/compare/stitch CLIs are not ported yet.
"""

from __future__ import annotations

from .flightrec import FLIGHT_ENV
from .registry import REGISTRY, Histogram, Registry
from .spans import FENCE_ENV, Span, current_span, span
from .tracing import current_trace_id, new_trace_id, trace_request

__all__ = [
    "FENCE_ENV",
    "FLIGHT_ENV",
    "Histogram",
    "REGISTRY",
    "Registry",
    "Span",
    "current_span",
    "current_trace_id",
    "new_trace_id",
    "span",
    "trace_request",
]

# The flight recorder is env-armed at import (its ring only buffers in
# memory; disk is touched solely on a crash dump). A bad value degrades to
# a warning rather than an ImportError; calling install_from_env directly
# still raises.
try:
    from .flightrec import install_from_env as _flightrec_install

    _flightrec_install(REGISTRY)
except Exception as _e:
    import warnings as _warnings

    _warnings.warn(
        f"{FLIGHT_ENV} ignored — could not arm the flight recorder: {_e}",
        RuntimeWarning,
        stacklevel=2,
    )
