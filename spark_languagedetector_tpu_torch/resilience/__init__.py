"""Resilience of the port's runner: retry policies, circuit breaking and a
deterministic chaos layer.

Port of ``spark_languagedetector_tpu.resilience``:

  * :mod:`.policy` — :class:`RetryPolicy` (bounded attempts, deterministic
    seeded backoff, per-attempt deadlines, a classifier that refuses
    programming errors, kernel build and launch failures and CUDA errors),
    :class:`CircuitBreaker`, and :class:`RetryBudget` (the token bucket a
    fleet's failovers, hedges and client re-sends draw on);
  * :mod:`.faults` — :class:`FaultPlan` (env ``LANGDETECT_FAULT_PLAN`` or
    :func:`faults.plan_scope`) injects failures and latency at named sites
    with a seeded schedule, so every recovery path runs on the CPU;
  * :mod:`.dlq` — :class:`DeadLetterQueue`, the quarantine the streaming
    engine (:mod:`..stream.microbatch`) bisects poison rows into.

The runner (:mod:`..api.runner`) layers the breaker-gated degradation
ladder on top: fast path → device gather → host gather, exact at every rung,
wherever the path launches no CUDA kernel.
"""

from __future__ import annotations

from .dlq import DeadLetterQueue
from .faults import FaultPlan, InjectedFault, PoisonRowError, PoisonText
from .policy import (
    BreakerOpen,
    CircuitBreaker,
    DeadlineExceeded,
    RetryBudget,
    RetryPolicy,
    is_retryable,
)

__all__ = [
    "BreakerOpen",
    "CircuitBreaker",
    "DeadLetterQueue",
    "DeadlineExceeded",
    "FaultPlan",
    "InjectedFault",
    "PoisonRowError",
    "PoisonText",
    "RetryBudget",
    "RetryPolicy",
    "is_retryable",
]
