"""Retry policies and circuit breaking for the runner.

Port of ``spark_languagedetector_tpu.resilience.policy``: one policy object
with bounded attempts, exponential backoff with *deterministic* seeded
jitter (two runs of the same schedule sleep identically, so chaos tests
stay reproducible), per-attempt deadlines, and a classifier that sends
programming errors straight out instead of replaying them.

The classifier differs from the JAX package's in one respect, on purpose:
a kernel of the port that fails to build (:class:`KernelBuildError`) or to
launch (:class:`KernelLaunchError`), and any CUDA error (a
``torch.AcceleratorError``, or a ``RuntimeError`` whose message starts
"CUDA error"), is *not* retryable. A CUDA error is sticky for the context on
this card, so a replay cannot help, and a broken kernel must never be hidden
behind the degradation ladder's exact but slow rungs. Injected faults,
``OSError``, ``TimeoutError`` and ``torch.OutOfMemoryError`` stay retryable,
as in the JAX package.

The :class:`CircuitBreaker` is the consecutive-failure gate in front of the
fast device path: closed (normal) → open (device presumed down; callers skip
straight to their fallback) → half-open after a cooldown (one probe re-tests
the fast path) → closed on probe success. All transitions are exported as
the ``langdetect_breaker_state`` gauge (0 = closed, 1 = half-open, 2 = open).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..ops._kernels import KernelBuildError, KernelLaunchError
from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("resilience.policy")


class DeadlineExceeded(RuntimeError):
    """A failed attempt also blew its per-attempt deadline: stop retrying.

    RuntimeError-shaped on purpose: an *outer* policy (the stream engine
    above a runner) may still classify a blown inner deadline as
    transient and replay the whole unit once.
    """


class BreakerOpen(RuntimeError):
    """Raised by :meth:`RetryPolicy.run` when a gating breaker is open and
    the caller asked for gating (``breaker_gates=True``)."""


# --- retryable-exception classifier ------------------------------------------
# Transient, environment-shaped failures worth replaying: runtime errors
# (an injected fault, an allocation that failed under pressure), host I/O,
# timeouts. NOT retryable even though they subclass RuntimeError:
# NotImplementedError and RecursionError (programming errors), a kernel of
# the port that failed to build or launch, and any CUDA error (sticky for
# the context: the next launch fails the same way). BaseExceptions that
# aren't Exceptions (KeyboardInterrupt, SystemExit, GeneratorExit) are
# never classified retryable and :meth:`RetryPolicy.run` never even catches
# them.
_RETRYABLE_BASES = (RuntimeError, OSError, TimeoutError)
_NON_RETRYABLE_RUNTIME = (
    NotImplementedError,
    RecursionError,
    KernelBuildError,
    KernelLaunchError,
    torch.AcceleratorError,
)


def is_cuda_error(exc: BaseException) -> bool:
    """A CUDA error: ``torch.AcceleratorError``, or a ``RuntimeError`` whose
    message starts "CUDA error" (how torch reports a fault it finds at a
    synchronization)."""
    return isinstance(exc, torch.AcceleratorError) or (
        isinstance(exc, RuntimeError) and str(exc).lstrip().startswith("CUDA error")
    )


def is_retryable(exc: BaseException) -> bool:
    """True when ``exc`` looks transient (worth replaying the work for)."""
    if not isinstance(exc, Exception):
        return False
    if isinstance(exc, _NON_RETRYABLE_RUNTIME) or is_cuda_error(exc):
        return False
    return isinstance(exc, _RETRYABLE_BASES)


# Env knobs: one shared namespace — per-site
# policies are constructed in code, the env sets the process default.
# The spellings below are kept as importable constants (tests pin them);
# the *reads* resolve through exec/config's audited table, so a malformed
# value raises instead of silently meaning "default" and /varz reports
# exactly what a policy built from the environment will do.
RETRY_ATTEMPTS_ENV = "LANGDETECT_RETRY_MAX_ATTEMPTS"
RETRY_BASE_DELAY_ENV = "LANGDETECT_RETRY_BASE_DELAY_S"
RETRY_MAX_DELAY_ENV = "LANGDETECT_RETRY_MAX_DELAY_S"
RETRY_MULTIPLIER_ENV = "LANGDETECT_RETRY_MULTIPLIER"
RETRY_JITTER_ENV = "LANGDETECT_RETRY_JITTER"
RETRY_SEED_ENV = "LANGDETECT_RETRY_SEED"
RETRY_DEADLINE_ENV = "LANGDETECT_RETRY_ATTEMPT_DEADLINE_S"

_U64 = (1 << 64) - 1


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry schedule with deterministic seeded jitter.

    ``max_attempts`` counts the first try: the default of 2 preserves the
    serving layers' historical replay-once semantics, now with backoff
    and classification. ``attempt_deadline_s`` is *post-hoc*: a Python
    thread cannot preempt a blocked device call, so an attempt that both
    raised and overran the deadline converts to :class:`DeadlineExceeded`
    instead of being retried — the deadline bounds total retry spend
    rather than pretending to cancel device work.
    """

    max_attempts: int = 2
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    # Fraction of each delay that is jittered *downward*: delay lands in
    # [base*(1-jitter), base]. Deterministic per (seed, attempt).
    jitter: float = 0.5
    seed: int = 0
    attempt_deadline_s: float | None = None
    classify: Callable[[BaseException], bool] = field(default=is_retryable)

    @staticmethod
    def from_env(env=os.environ, **overrides) -> "RetryPolicy":
        """Process-default policy from ``LANGDETECT_RETRY_*``; keyword
        overrides win (call sites pin what must not drift). Knobs resolve
        through exec/config's audited precedence table — a malformed
        value raises rather than silently meaning the default."""
        from ..exec import config as exec_config

        def knob(name):
            return exec_config.resolve(name, env=env)

        kw = dict(
            max_attempts=max(1, int(knob("retry_max_attempts"))),
            base_delay_s=knob("retry_base_delay_s"),
            multiplier=knob("retry_multiplier"),
            max_delay_s=knob("retry_max_delay_s"),
            jitter=min(1.0, max(0.0, knob("retry_jitter"))),
            seed=knob("retry_seed"),
            attempt_deadline_s=knob("retry_attempt_deadline_s"),
        )
        kw.update(overrides)
        return RetryPolicy(**kw)

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (1-based: the delay
        between attempt N failing and attempt N+1 starting). Pure function
        of (policy, attempt) — replaying a schedule sleeps identically."""
        base = min(
            self.max_delay_s,
            self.base_delay_s * self.multiplier ** max(0, attempt - 1),
        )
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        # splitmix64-style hash of (seed, attempt): deterministic jitter
        # with no dependence on process-global random state.
        x = (
            (self.seed * 0x9E3779B97F4A7C15) + (attempt * 0xBF58476D1CE4E5B9)
        ) & _U64
        x ^= x >> 30
        x = (x * 0x94D049BB133111EB) & _U64
        x ^= x >> 31
        u = x / float(1 << 64)
        return base * (1.0 - self.jitter * u)

    def run(
        self,
        fn: Callable[[], object],
        *,
        site: str = "",
        breaker: "CircuitBreaker | None" = None,
        breaker_gates: bool = False,
        on_retry: Callable[[int, float, BaseException], None] | None = None,
        sleep: Callable[[float], None] = time.sleep,
        initial_error: BaseException | None = None,
        log_fields: dict | None = None,
    ) -> object:
        """Execute ``fn`` under this policy.

        Only ``Exception`` is ever caught — ``KeyboardInterrupt`` /
        ``SystemExit`` always propagate from the attempt itself. A
        non-retryable exception propagates immediately (no replay, no
        breaker accounting: a programming error says nothing about device
        health). Each retry logs a structured ``resilience.retry`` event
        carrying the site, attempt number, backoff delay, error, and the
        ambient ``trace_id``, and feeds the registry
        (``resilience/retries`` counter, ``resilience/retry_backoff_s``
        histogram, ``langdetect_retry_attempts`` gauge).

        ``breaker``: per-attempt outcomes are recorded on it; with
        ``breaker_gates=True`` an open breaker raises :class:`BreakerOpen`
        instead of attempting at all. ``initial_error``: the caller
        already burned attempt 1 elsewhere (the runner's async fetch
        surfaces the dispatch's failure later) — seed the schedule with
        it so total attempts stay bounded by ``max_attempts``.
        ``on_retry(attempt, delay_s, exc)`` lets call sites keep their
        legacy per-site counters.
        """
        from ..telemetry.tracing import current_trace_id

        attempt = 0

        def _account_retry(exc: BaseException) -> float:
            delay = self.backoff_s(attempt)
            REGISTRY.incr("resilience/retries")
            REGISTRY.observe("resilience/retry_backoff_s", delay)
            REGISTRY.set_gauge(
                "langdetect_retry_attempts", attempt, site=site or "unknown"
            )
            log_event(
                _log,
                "resilience.retry",
                site=site,
                attempt=attempt,
                max_attempts=self.max_attempts,
                backoff_s=round(delay, 6),
                error=repr(exc),
                trace_id=current_trace_id(),
                **(log_fields or {}),
            )
            if on_retry is not None:
                on_retry(attempt, delay, exc)
            return delay

        if initial_error is not None:
            attempt = 1
            if not self.classify(initial_error):
                raise initial_error
            if attempt >= self.max_attempts:
                raise initial_error
            delay = _account_retry(initial_error)
            if delay > 0.0:
                sleep(delay)

        while True:
            if breaker is not None and breaker_gates and not breaker.allow():
                raise BreakerOpen(
                    f"circuit breaker {breaker.name!r} is open at {site!r}"
                )
            attempt += 1
            t0 = time.perf_counter()
            try:
                result = fn()
            except Exception as exc:
                elapsed = time.perf_counter() - t0
                retryable = self.classify(exc)
                if breaker is not None and retryable:
                    breaker.record_failure()
                if not retryable:
                    raise
                if (
                    self.attempt_deadline_s is not None
                    and elapsed > self.attempt_deadline_s
                ):
                    raise DeadlineExceeded(
                        f"attempt {attempt} at {site or 'unknown'} failed "
                        f"after {elapsed:.3f}s (deadline "
                        f"{self.attempt_deadline_s}s)"
                    ) from exc
                if attempt >= self.max_attempts:
                    raise
                delay = _account_retry(exc)
                if delay > 0.0:
                    sleep(delay)
                continue
            if breaker is not None:
                breaker.record_success()
            return result


# --- retry budget ------------------------------------------------------------
RETRY_BUDGET_FRACTION_ENV = "LANGDETECT_RETRY_BUDGET_FRACTION"
RETRY_BUDGET_BURST_ENV = "LANGDETECT_RETRY_BUDGET_BURST"


class RetryBudget:
    """Token bucket that bounds retries to a fraction of successes.

    Each success deposits ``fraction`` tokens, up to ``burst`` (also the
    starting balance, so a quiet service absorbs a small incident at once).
    Every extra attempt (a router failover, a client re-send of a 503, a
    hedge) must withdraw one whole token first. In an outage successes dry
    up and the bucket drains, so retries stay under ``burst + fraction x
    successes`` instead of multiplying the offered load; a refused
    withdrawal counts ``fleet/retry_budget_exhausted`` and the caller sheds.

    ``fraction <= 0`` disables the budget (:meth:`try_spend` always grants).
    Thread-safe; the balance is the ``langdetect_retry_budget_tokens``
    gauge.
    """

    def __init__(
        self,
        fraction: float | None = None,
        burst: float | None = None,
        *,
        name: str = "fleet",
    ):
        from ..exec import config as exec_config

        self.fraction = float(exec_config.resolve("retry_budget_fraction", fraction))
        self.burst = max(1.0, float(exec_config.resolve("retry_budget_burst", burst)))
        self.name = name
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._successes = 0
        self._spent = 0
        self._denied = 0
        self._gauge()

    @property
    def enabled(self) -> bool:
        return self.fraction > 0.0

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def _gauge(self) -> None:
        REGISTRY.set_gauge(
            "langdetect_retry_budget_tokens", round(self._tokens, 6), budget=self.name
        )

    def record_success(self) -> None:
        """Deposit for one successful first attempt."""
        if not self.enabled:
            return
        with self._lock:
            self._successes += 1
            self._tokens = min(self.burst, self._tokens + self.fraction)
            self._gauge()

    def try_spend(self, *, reason: str = "retry") -> bool:
        """Withdraw one token for an extra attempt; False: shed it."""
        if not self.enabled:
            return True
        with self._lock:
            granted = self._tokens >= 1.0
            if granted:
                self._tokens -= 1.0
                self._spent += 1
            else:
                self._denied += 1
            self._gauge()
        if not granted:
            REGISTRY.incr("fleet/retry_budget_exhausted")
            log_event(
                _log, "resilience.retry_budget.exhausted", budget=self.name,
                reason=reason, fraction=self.fraction,
            )
        return granted

    def describe(self) -> dict:
        """The budget's state, for ``/varz`` and the storm checks."""
        with self._lock:
            return {
                "name": self.name,
                "enabled": self.enabled,
                "fraction": self.fraction,
                "burst": self.burst,
                "tokens": round(self._tokens, 6),
                "successes": self._successes,
                "spent": self._spent,
                "denied": self._denied,
            }


# --- circuit breaker ---------------------------------------------------------
BREAKER_THRESHOLD_ENV = "LANGDETECT_BREAKER_THRESHOLD"
BREAKER_COOLDOWN_ENV = "LANGDETECT_BREAKER_COOLDOWN_S"
BREAKER_PROBES_ENV = "LANGDETECT_BREAKER_PROBES"

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    """Consecutive-failure breaker: closed → open → half-open → closed.

    ``failure_threshold`` consecutive retryable failures open the
    breaker; after ``cooldown_s`` the next :meth:`allow` transitions to
    half-open and admits probes; ``probe_successes`` consecutive
    successes close it again, any probe failure re-opens (and restarts
    the cooldown). Thread-safe; the clock is injectable so tests drive
    the cooldown without sleeping.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 5.0,
        probe_successes: int = 1,
        *,
        name: str = "device",
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self.probe_successes = max(1, int(probe_successes))
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._probe_hits = 0
        self._opened_at = 0.0

    @staticmethod
    def from_env(env=os.environ, *, name: str = "device") -> "CircuitBreaker":
        from ..exec import config as exec_config

        return CircuitBreaker(
            failure_threshold=max(
                1, int(exec_config.resolve("breaker_threshold", env=env))
            ),
            cooldown_s=exec_config.resolve("breaker_cooldown_s", env=env),
            probe_successes=max(
                1, int(exec_config.resolve("breaker_probes", env=env))
            ),
            name=name,
        )

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, new_state: str) -> None:
        """Caller holds the lock. Emits the state gauge + transition log."""
        old, self._state = self._state, new_state
        self._consecutive_failures = 0
        self._probe_hits = 0
        if new_state == OPEN:
            self._opened_at = self._clock()
            REGISTRY.incr("resilience/breaker_opened")
        REGISTRY.set_gauge(
            "langdetect_breaker_state", _STATE_GAUGE[new_state],
            breaker=self.name,
        )
        log_event(
            _log, "resilience.breaker", breaker=self.name,
            from_state=old, to_state=new_state,
        )

    def allow(self) -> bool:
        """May the protected (fast) path be attempted right now?"""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._transition(HALF_OPEN)
                    return True
                return False
            return True  # HALF_OPEN: probes admitted

    def record_success(self) -> None:
        with self._lock:
            if self._state == CLOSED:
                self._consecutive_failures = 0
                return
            # HALF_OPEN — and OPEN too: a success while open is live probe
            # evidence the path works (it happens when a retry inside one
            # policy run lands *after* the probe attempt that re-opened
            # the breaker). Ignoring it would leave a proven-healthy path
            # gated until the next cooldown.
            hits = self._probe_hits + 1
            if hits >= self.probe_successes:
                self._transition(CLOSED)
            else:
                if self._state == OPEN:
                    self._transition(HALF_OPEN)
                self._probe_hits = hits

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(OPEN)  # probe failed: restart the cooldown
            elif self._state == CLOSED:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.failure_threshold:
                    self._transition(OPEN)
            # OPEN: already tripped; failures while open don't accumulate.
