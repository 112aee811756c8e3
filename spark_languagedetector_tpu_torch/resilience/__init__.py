"""Resilience of the port's runner: retry policies, circuit breaking and a
deterministic chaos layer.

Port of ``spark_languagedetector_tpu.resilience`` (the dead-letter queue of
the streaming engine is not ported yet):

  * :mod:`.policy` — :class:`RetryPolicy` (bounded attempts, deterministic
    seeded backoff, per-attempt deadlines, a classifier that refuses
    programming errors, kernel build and launch failures and CUDA errors),
    and :class:`CircuitBreaker`;
  * :mod:`.faults` — :class:`FaultPlan` (env ``LANGDETECT_FAULT_PLAN`` or
    :func:`faults.plan_scope`) injects failures and latency at named sites
    with a seeded schedule, so every recovery path runs on the CPU.

The runner (:mod:`..api.runner`) layers the breaker-gated degradation
ladder on top: fast path → device gather → host gather, exact at every rung,
wherever the path launches no CUDA kernel.
"""

from __future__ import annotations

from .faults import FaultPlan, InjectedFault
from .policy import (
    BreakerOpen,
    CircuitBreaker,
    DeadlineExceeded,
    RetryPolicy,
    is_retryable,
)

__all__ = [
    "BreakerOpen",
    "CircuitBreaker",
    "DeadlineExceeded",
    "FaultPlan",
    "InjectedFault",
    "RetryPolicy",
    "is_retryable",
]
