"""Telemetry of the port, under the JAX package's names and formats, so
either package's tools read the other's captures.

Port of ``spark_languagedetector_tpu.telemetry``:

  * :data:`REGISTRY` (:mod:`.registry`) — counters, deterministic-reservoir
    histograms with p50/p90/p99, gauges and span aggregates, one lock;
  * :func:`span` (:mod:`.spans`) — nestable timing regions keyed by slash
    paths (``"score/pack"``), optionally fenced on the card
    (``LANGDETECT_TELEMETRY_FENCE``);
  * :func:`trace_request` (:mod:`.tracing`) — a ``trace_id`` per request,
    stamped onto every span record, and the Chrome/Perfetto trace CLI::

        python -m spark_languagedetector_tpu_torch.telemetry.tracing events.jsonl [out.json]

  * :mod:`.flightrec` — a bounded ring of recent events, dumped as a JSONL
    post-mortem when a score, fit or stream call raises
    (``LANGDETECT_FLIGHT_RECORDER``);
  * :mod:`.export` — the JSONL event sink and the Prometheus text-format
    snapshot writer, attached from ``LANGDETECT_METRICS_SINK`` at import;
  * :mod:`.aggregate` — process identity and the fleet collector;
  * :mod:`.slo` — declared objectives as multi-window burn rates over the
    fleet aggregate;
  * :mod:`.gauges` — the CUDA devices' memory gauges;
  * :mod:`.cost` — the analytic cost model behind the roofline shares of
    :meth:`Registry.stage_summary`;
  * the CLIs over a JSONL capture::

        python -m spark_languagedetector_tpu_torch.telemetry.report events.jsonl
        python -m spark_languagedetector_tpu_torch.telemetry.compare base.jsonl new.jsonl
        python -m spark_languagedetector_tpu_torch.telemetry.stitch a.jsonl b.jsonl [-o out.json]
"""

from __future__ import annotations

from .export import (
    SINK_ENV,
    configure_sinks_from_env,
    render_prometheus,
    write_prometheus,
)
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
    "SINK_ENV",
    "Span",
    "configure_sinks_from_env",
    "current_span",
    "current_trace_id",
    "new_trace_id",
    "render_prometheus",
    "span",
    "trace_request",
    "write_prometheus",
]

# Attach the exporters declared in the environment once, at import: every
# instrumented module imports this package, so a process that sets
# LANGDETECT_METRICS_SINK gets its sinks without any code change. A bad
# value (unknown kind, unwritable path) degrades to a loud warning rather
# than an ImportError — a metrics env var must never take down scoring.
# Calling configure_sinks_from_env directly still raises.
try:
    configure_sinks_from_env(REGISTRY)
except Exception as _e:
    import warnings as _warnings

    _warnings.warn(
        f"{SINK_ENV} ignored — could not attach metric sinks: {_e}",
        RuntimeWarning,
        stacklevel=2,
    )

# The flight recorder is env-armed at import (its ring only buffers in
# memory; disk is touched solely on a crash dump), with the same
# degrade-to-a-warning contract.
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
