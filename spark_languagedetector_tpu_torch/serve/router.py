"""Health-checked router in front of a replicated serving fleet.

Port of ``spark_languagedetector_tpu.serve.router``. The router talks HTTP
to each replica, so a replica may live in this process or another; in one
process every replica runs the same model's runner, and its CUDA kernels,
on the card. One thread-safe :class:`FleetRouter` owns:

  * **Probing.** A background loop (or :meth:`FleetRouter.probe_once`,
    which deterministic tests drive) reads each replica's
    ``/healthz/ready``. An answered probe proves liveness and feeds the
    replica's :class:`~..resilience.policy.CircuitBreaker`; readiness is
    the replica's own report. ``breaker_threshold`` consecutive failed
    probes or dispatches eject the replica (breaker open: no traffic, no
    probes) until the cooldown; then one half-open probe decides its
    re-admission. The ``fleet/probe`` fault site injects probe failures.
  * **Routing.** Least outstanding rows among eligible replicas (ready, not
    draining, breaker closed, serving the pinned version when a pin is
    set), the replica's index breaking ties, so two routers fed the same
    sequence choose alike.
  * **Failover.** A dispatch that dies (connection refused or reset, a 5xx
    other than 504, a ``fleet/dispatch`` fault) is retried on another
    replica, never on one this request already saw fail. A failover
    replays on another replica's kernel on the same card, never on the CPU
    or a plain version; a replica's kernel failure arrives as a 500 whose
    body names the ``KernelBuildError``/``KernelLaunchError`` and counts
    ``fleet/replica_kernel_errors`` as well as ``fleet/failovers``. 400,
    422 and 504 are the replica's final answer and are not retried.
  * **Fleet-wide shed.** A replica's 503 shed means "healthy but full": the
    request tries the other ready replicas, and only when all shed does the
    router raise :class:`FleetSaturated` (503 with the smallest
    ``Retry-After`` offered).
  * **Storm defense.** Each failover attempt gets the *remaining* deadline;
    below ``fleet_deadline_floor_ms`` the router answers 504 itself. Every
    extra attempt, failover or hedge, withdraws a token from the shared
    :class:`~..resilience.policy.RetryBudget`. With ``hedge_enable`` a
    straggling dispatch gets one hedge to another replica after the
    observed latency quantile, and the first answer wins (scoring is pure,
    and the version pin holds for both). A
    :class:`~.quarantine.QuarantineTable` charges a request's signature
    with each replica death its dispatch coincided with, and answers a
    quarantined one 422 before any dispatch.
  * **Membership.** :meth:`FleetRouter.add_replica` admits a replica with a
    fresh breaker; :meth:`FleetRouter.remove_replica` drains, then
    detaches.

The version pin is the router's half of the fleet's two-phase swap
(:mod:`.fleet`): while a swap runs only replicas serving the pinned version
are eligible, so no client stream interleaves two versions.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from http.client import HTTPException

from ..exec import config as exec_config
from ..resilience import faults
from ..resilience.policy import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
    RetryBudget,
    is_retryable,
)
from ..telemetry import REGISTRY, span, trace_request
from ..utils.logging import get_logger, log_event
from .batcher import INTERACTIVE, LANES, ServeDeadlineExceeded, ServeError, ServeOverloaded
from .client import ServeClient, ServeHTTPError
from .quarantine import QuarantineTable, QueryQuarantined, signature_of
from .server import JsonHTTPFront

_log = get_logger("serve.router")

_KERNEL_ERRORS = ("KernelBuildError", "KernelLaunchError")


class FleetSaturated(ServeOverloaded):
    """Every ready replica shed the request (or the retry budget is empty):
    HTTP 503 with Retry-After, like any shed."""


class NoReadyReplica(ServeOverloaded):
    """No replica is eligible (all ejected, draining or off the pin): an
    explicit, retryable 503, never a hang."""


class FleetSwapError(ServeError):
    """A fleet-wide swap aborted in phase 1 or rolled back in phase 2; the
    fleet is on one version either way."""


class ReplicaHandle:
    """The router's view of one replica: address, health, load. Its mutable
    fields are guarded by the router's lock; the breaker has its own."""

    def __init__(
        self,
        name: str,
        host: str,
        port: int,
        *,
        breaker: CircuitBreaker,
        request_timeout_s: float,
        probe_timeout_s: float,
    ):
        self.name = name
        self.host, self.port = host, port
        self.client = ServeClient(host, port, timeout_s=request_timeout_s)
        self.probe_client = ServeClient(host, port, timeout_s=probe_timeout_s)
        self.breaker = breaker
        self.ready = False
        self.reasons: list[str] = ["unprobed"]
        self.draining = False  # set by the fleet swap's drain
        self.version: str | None = None
        self.outstanding_rows = 0

    def describe(self) -> dict:
        return {
            "replica": self.name,
            "address": f"{self.host}:{self.port}",
            "ready": self.ready,
            "reasons": list(self.reasons),
            "draining": self.draining,
            "version": self.version,
            "outstanding_rows": self.outstanding_rows,
            "breaker": self.breaker.state,
        }


def _as_endpoint(i: int, rep) -> tuple[str, str, int]:
    """(name, host, port) of a ``ServeReplica``-like object or a tuple."""
    if hasattr(rep, "address"):
        host, port = rep.address
        return getattr(rep, "name", f"r{i}"), host, int(port)
    host, port = rep
    return f"r{i}", host, int(port)


def _names_kernel_error(exc: Exception) -> bool:
    payload = getattr(exc, "payload", None)
    text = str(payload.get("error", "")) if isinstance(payload, dict) else str(exc)
    return any(k in text for k in _KERNEL_ERRORS)


class FleetRouter:
    """Routing tier over N serving replicas.

    ``replicas``: :class:`~.fleet.ServeReplica` objects or ``(host, port)``
    tuples. Knobs left None resolve through ``exec.config``
    (``LANGDETECT_FLEET_*``, ``_RETRY_BUDGET_*``, ``_HEDGE_*``,
    ``_QUARANTINE_*``). ``clock`` times the replicas' breaker cooldowns
    (tests move a fake one).
    """

    def __init__(
        self,
        replicas,
        *,
        probe_interval_ms: float | None = None,
        probe_timeout_s: float | None = None,
        dispatch_attempts: int | None = None,
        breaker_threshold: int | None = None,
        breaker_cooldown_s: float | None = None,
        drain_timeout_s: float | None = None,
        request_timeout_s: float = 60.0,
        deadline_floor_ms: float | None = None,
        retry_budget: RetryBudget | None = None,
        hedge_enable: bool | None = None,
        hedge_quantile: float | None = None,
        hedge_min_ms: float | None = None,
        quarantine: QuarantineTable | None = None,
        name: str = "fleet",
        clock=time.monotonic,
    ):
        self.name = name
        self.probe_interval_s = (
            float(exec_config.resolve("fleet_probe_interval_ms", probe_interval_ms)) / 1e3
        )
        self.probe_timeout_s = float(exec_config.resolve("fleet_probe_timeout_s", probe_timeout_s))
        self.dispatch_attempts = int(
            exec_config.resolve("fleet_dispatch_attempts", dispatch_attempts)
        )
        self.drain_timeout_s = float(exec_config.resolve("fleet_drain_timeout_s", drain_timeout_s))
        # Kept for add_replica: late members get the founders' breakers.
        self._breaker_threshold = int(
            exec_config.resolve("fleet_breaker_threshold", breaker_threshold)
        )
        self._breaker_cooldown_s = float(
            exec_config.resolve("fleet_breaker_cooldown_s", breaker_cooldown_s)
        )
        self._clock = clock
        self._request_timeout_s = float(request_timeout_s)
        self.deadline_floor_ms = float(
            exec_config.resolve("fleet_deadline_floor_ms", deadline_floor_ms)
        )
        self.retry_budget = RetryBudget(name=name) if retry_budget is None else retry_budget
        self.hedge_enable = bool(exec_config.resolve("hedge_enable", hedge_enable))
        self.hedge_quantile = float(exec_config.resolve("hedge_quantile", hedge_quantile))
        self.hedge_min_ms = float(exec_config.resolve("hedge_min_ms", hedge_min_ms))
        self.quarantine = QuarantineTable(name=name) if quarantine is None else quarantine
        # Recent successful dispatch latencies: the hedge delay's quantile
        # source (failures are fast and would shrink it).
        self._lat: deque[float] = deque(maxlen=256)
        self._lock = threading.Lock()
        self._pin: str | None = None
        self._handles: list[ReplicaHandle] = [
            self._new_handle(*_as_endpoint(i, rep)) for i, rep in enumerate(replicas)
        ]
        if not self._handles:
            raise ValueError("a fleet router needs at least one replica")
        self._started = time.monotonic()
        self._stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        log_event(
            _log, "fleet.router.start", replicas=len(self._handles),
            probe_interval_ms=self.probe_interval_s * 1e3,
            dispatch_attempts=self.dispatch_attempts,
        )

    def _new_handle(self, rname: str, host: str, port: int) -> ReplicaHandle:
        return ReplicaHandle(
            rname, host, port,
            breaker=CircuitBreaker(
                failure_threshold=self._breaker_threshold,
                cooldown_s=self._breaker_cooldown_s,
                name=f"{self.name}:{rname}",
                clock=self._clock,
            ),
            request_timeout_s=self._request_timeout_s,
            probe_timeout_s=self.probe_timeout_s,
        )

    # ------------------------------------------------------ membership ------
    def add_replica(self, rep, *, name: str | None = None) -> str:
        """Admit a replica with a fresh, closed breaker (a re-added address
        never inherits an earlier member's ejections), probe it once, and
        return its name. A name already routed is an error."""
        with self._lock:
            idx = len(self._handles)
        rname, host, port = _as_endpoint(idx, rep)
        rname = name or rname
        with self._lock:
            if any(h.name == rname for h in self._handles):
                raise ValueError(
                    f"replica name {rname!r} already routed; remove it first or pick a fresh name"
                )
            h = self._new_handle(rname, host, port)
            self._handles.append(h)
        log_event(
            _log, "fleet.replica.added", replica=rname, address=f"{host}:{port}",
            replicas=idx + 1,
        )
        self._probe_replica(h)
        return rname

    def remove_replica(self, name: str, *, drain: bool = True, timeout_s: float | None = None
                       ) -> bool:
        """Detach a replica: mark it draining (no new picks), wait out its
        outstanding requests (bounded, with ``drain``), drop its handle and
        zero its gauges. Returns whether the drain finished in time; a
        straggler that finishes later only updates the detached handle."""
        h = self._handle(name)
        self.set_draining(name, True)
        drained = self.wait_drained(name, timeout_s=timeout_s) if drain else True
        with self._lock:
            if h in self._handles:
                self._handles.remove(h)
        REGISTRY.set_gauge("langdetect_fleet_replica_ready", 0.0, replica=name)
        REGISTRY.set_gauge("langdetect_fleet_outstanding_rows", 0.0, replica=name)
        log_event(
            _log, "fleet.replica.removed", replica=name, drained=drained,
            replicas=len(self._handles),
        )
        return drained

    # ---------------------------------------------------------- lifecycle ---
    def start(self, *, probe: bool = True) -> "FleetRouter":
        """One probe round now (routing works at once), then the background
        prober unless ``probe=False`` (tests call :meth:`probe_once`)."""
        self.probe_once()
        if probe and self._probe_thread is None:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name=f"{self.name}-prober", daemon=True
            )
            self._probe_thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10.0)
            self._probe_thread = None

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.probe_once()
            except Exception as e:  # the prober must survive anything
                log_event(_log, "fleet.probe_loop_error", error=repr(e))

    # ------------------------------------------------------------ probing ---
    def probe_once(self) -> list[str]:
        """One probe round over the replicas in index order (so a chaos
        plan at ``fleet/probe`` replays exactly). Returns event strings
        such as ``"r1:unreachable:ejected"`` and ``"r1:readmitted"``."""
        with self._lock:
            handles = list(self._handles)  # membership may change mid-round
        events: list[str] = []
        with span("fleet/probe", replicas=len(handles)):
            for h in handles:
                evt = self._probe_replica(h)
                if evt:
                    events.append(evt)
        REGISTRY.incr("fleet/probe_rounds")
        REGISTRY.set_gauge("langdetect_fleet_ready_replicas", float(len(self.eligible())))
        return events

    def _probe_replica(self, h: ReplicaHandle) -> str | None:
        if not h.breaker.allow():
            # Open and cooling down: ejected, not probed. After the cooldown
            # allow() turns half-open and this probe decides re-admission.
            with self._lock:
                h.ready = False
                h.reasons = ["ejected"]
            self._replica_gauges(h)
            return None
        before = h.breaker.state
        try:
            faults.inject("fleet/probe")
            payload = h.probe_client.readyz()
        except Exception as e:
            h.breaker.record_failure()
            # Only the closed -> open edge is an ejection; a failed half-open
            # probe is the same outage going on.
            ejected = h.breaker.state == OPEN and before == CLOSED
            if ejected:
                REGISTRY.incr("fleet/ejections")
            with self._lock:
                h.ready = False
                h.reasons = ["unreachable"]
            self._replica_gauges(h)
            log_event(_log, "fleet.probe_failed", replica=h.name, error=repr(e), ejected=ejected)
            return f"{h.name}:unreachable" + (":ejected" if ejected else "")
        # Reachable: liveness proven. Not-ready is honest backpressure and
        # does not trip the breaker.
        h.breaker.record_success()
        readmitted = before in (OPEN, HALF_OPEN) and h.breaker.state == CLOSED
        if readmitted:
            REGISTRY.incr("fleet/readmissions")
            log_event(_log, "fleet.readmitted", replica=h.name)
        ready = bool(payload.get("ready"))
        with self._lock:
            h.ready = ready
            h.reasons = list(payload.get("reasons") or ([] if ready else ["not_ready"]))
            h.version = payload.get("version") or h.version
        self._replica_gauges(h)
        if readmitted:
            return f"{h.name}:readmitted"
        return f"{h.name}:ready" if ready else f"{h.name}:not_ready"

    def _replica_gauges(self, h: ReplicaHandle) -> None:
        # Membership check and write under one lock hold, or a concurrent
        # remove_replica's zeroed series could be resurrected.
        with self._lock:
            if h not in self._handles:
                return
            REGISTRY.set_gauge(
                "langdetect_fleet_replica_ready",
                1.0 if (h.ready and h.breaker.state == CLOSED) else 0.0,
                replica=h.name,
            )

    # ------------------------------------------------------------ routing ---
    def _eligible_locked(self, h: ReplicaHandle) -> bool:
        return (
            h.ready
            and not h.draining
            and h.breaker.state == CLOSED
            and (self._pin is None or h.version == self._pin)
        )

    def eligible(self) -> list[str]:
        with self._lock:
            return [h.name for h in self._handles if self._eligible_locked(h)]

    def _pick(self, rows: int, excluded: set) -> ReplicaHandle | None:
        """The eligible replica with the fewest outstanding rows, lowest
        index on ties; reserves ``rows`` on it."""
        with self._lock:
            best = None
            for idx, h in enumerate(self._handles):
                if h.name in excluded or not self._eligible_locked(h):
                    continue
                key = (h.outstanding_rows, idx)
                if best is None or key < best[0]:
                    best = (key, h)
            if best is None:
                return None
            h = best[1]
            h.outstanding_rows += rows
            REGISTRY.set_gauge(
                "langdetect_fleet_outstanding_rows", float(h.outstanding_rows), replica=h.name
            )
            return h

    def _release(self, h: ReplicaHandle, rows: int) -> None:
        with self._lock:
            h.outstanding_rows = max(0, h.outstanding_rows - rows)
            if h not in self._handles:
                return  # detached: keep its series zeroed
            REGISTRY.set_gauge(
                "langdetect_fleet_outstanding_rows", float(h.outstanding_rows), replica=h.name
            )

    def _note_dispatch_failure(self, h: ReplicaHandle, exc: Exception) -> None:
        before = h.breaker.state
        h.breaker.record_failure()
        ejected = h.breaker.state == OPEN and before == CLOSED
        if ejected:
            REGISTRY.incr("fleet/ejections")
            with self._lock:
                h.ready = False
                h.reasons = ["dispatch_failures"]
            self._replica_gauges(h)
        REGISTRY.incr("fleet/failovers")
        if _names_kernel_error(exc):
            REGISTRY.incr("fleet/replica_kernel_errors")
        log_event(_log, "fleet.failover", replica=h.name, error=repr(exc), ejected=ejected)

    def _classify_failure(self, h, exc, excluded: set, saturated: list, sig: str, texts
                          ) -> bool:
        """Book a failed dispatch on ``h``: a shed marks it saturated, a
        dead replica (5xx but 504, a transport error) counts a failover and,
        for a severed connection, a death against ``sig``. Returns False
        for an answer that is final (400, 404, 422, 504, a caller error)."""
        if isinstance(exc, ServeHTTPError):
            if exc.status == 503 and exc.shed:
                saturated.append(exc.retry_after_s)
                excluded.add(h.name)
                REGISTRY.incr("fleet/replica_saturated")
                return True
            if exc.status == 503 or (exc.status >= 500 and exc.status != 504):
                excluded.add(h.name)
                self._note_dispatch_failure(h, exc)
                return True
            return False
        if isinstance(exc, HTTPException) or is_retryable(exc):
            excluded.add(h.name)
            self._note_dispatch_failure(h, exc)
            # A connection severed mid-flight: this dispatch coincided with
            # the replica's death.
            self.quarantine.record_death(sig, replica=h.name, source="router", texts=texts)
            return True
        return False

    # ----------------------------------------------------- attempt/hedge ---
    def _call_one(self, h: ReplicaHandle, texts: list, *, rows: int, attempt: int, hedge: bool,
                  want_labels: bool, segment_kw: dict | None, priority: str,
                  deadline_ms: float | None, trace_id: str, tenant: str | None):
        """One wire dispatch to one replica. Always releases its reservation
        and counts ``fleet/dispatches``; only successes feed the hedge
        delay's latency history."""
        t0 = time.perf_counter()
        kw = dict(priority=priority, deadline_ms=deadline_ms, trace_id=trace_id, tenant=tenant)
        try:
            with span("fleet/dispatch", replica=h.name, rows=rows, attempt=attempt):
                # One literal site per branch, so the contract checker
                # sees both.
                if hedge:
                    faults.inject("fleet/hedge")
                else:
                    faults.inject("fleet/dispatch")
                # The tenant rides along: each replica resolves it itself.
                if segment_kw is not None:
                    out, meta = h.client.segment(texts, **segment_kw, **kw)
                elif want_labels:
                    out, meta = h.client.detect(texts, **kw)
                else:
                    out, meta = h.client.score(texts, **kw)
            with self._lock:
                self._lat.append(time.perf_counter() - t0)
            return out, meta
        finally:
            REGISTRY.incr("fleet/dispatches")
            self._release(h, rows)

    def _hedge_delay_s(self) -> float:
        """The hedge's arm delay: the latency quantile over recent
        successes, never under ``hedge_min_ms`` (also the delay before
        eight samples exist)."""
        floor = self.hedge_min_ms / 1e3
        with self._lock:
            lat = sorted(self._lat)
        if len(lat) < 8:
            return floor
        q = min(max(self.hedge_quantile, 0.0), 1.0)
        return max(floor, lat[min(len(lat) - 1, int(q * len(lat)))])

    def _attempt(self, h: ReplicaHandle, texts: list, *, rows: int, attempt: int, excluded: set,
                 saturated: list, sig: str, **call_kw):
        """One dispatch attempt, hedged when enabled: if the primary has not
        answered after the hedge delay, and another replica and a budget
        token are there, a hedge races it and the first answer wins.
        Returns ``(out, meta, served_by)``; raises the primary's error when
        no leg succeeds (a hedge's failure is only booked)."""
        if not self.hedge_enable:
            out, meta = self._call_one(h, texts, rows=rows, attempt=attempt, hedge=False,
                                       **call_kw)
            return out, meta, h.name
        results: queue.SimpleQueue = queue.SimpleQueue()

        def run(handle: ReplicaHandle, is_hedge: bool) -> None:
            try:
                out, meta = self._call_one(handle, texts, rows=rows, attempt=attempt,
                                           hedge=is_hedge, **call_kw)
                results.put(("ok", handle, is_hedge, out, meta))
            except BaseException as e:
                results.put(("err", handle, is_hedge, e))

        threading.Thread(target=run, args=(h, False), name=f"{self.name}-dispatch-{h.name}",
                         daemon=True).start()
        try:
            first = results.get(timeout=self._hedge_delay_s())
        except queue.Empty:
            first = None
        pending = 1
        if first is None:
            # The primary straggles: a replica first (no token spent when
            # there is none), then the budget (hedges stop under overload).
            h2 = self._pick(rows, excluded | {h.name})
            if h2 is not None and not self.retry_budget.try_spend(reason="hedge"):
                self._release(h2, rows)
                h2 = None
            if h2 is not None:
                REGISTRY.incr("fleet/hedges")
                log_event(_log, "fleet.hedge", primary=h.name, hedge=h2.name, rows=rows,
                          attempt=attempt)
                threading.Thread(target=run, args=(h2, True),
                                 name=f"{self.name}-hedge-{h2.name}", daemon=True).start()
                pending += 1
        primary_exc: Exception | None = None
        while pending:
            item = first if first is not None else results.get()
            first = None
            pending -= 1
            if item[0] == "ok":
                _, handle, is_hedge, out, meta = item
                if is_hedge:
                    REGISTRY.incr("fleet/hedge_wins")
                if pending:
                    # The loser finishes in the background; its failure
                    # still feeds the breaker and quarantine books.
                    self._absorb_loser(results, excluded, saturated, sig, texts)
                return out, meta, handle.name
            _, handle, is_hedge, exc = item
            if not isinstance(exc, Exception):
                raise exc  # KeyboardInterrupt, SystemExit
            if is_hedge:
                self._classify_failure(handle, exc, excluded, saturated, sig, texts)
            else:
                primary_exc = exc
        raise primary_exc

    def _absorb_loser(self, results: queue.SimpleQueue, excluded: set, saturated: list,
                      sig: str, texts: list) -> None:
        def absorb() -> None:
            try:
                item = results.get(timeout=self._request_timeout_s + 5.0)
            except queue.Empty:
                return
            if item[0] == "err" and isinstance(item[3], Exception):
                self._classify_failure(item[1], item[3], excluded, saturated, sig, texts)

        threading.Thread(target=absorb, name=f"{self.name}-hedge-absorb", daemon=True).start()

    def score(self, texts, **kw):
        """(float32 [N, L] scores, response metadata with ``replica``)."""
        return self._dispatch(list(texts), want_labels=False, **kw)

    def detect(self, texts, **kw):
        """(labels, response metadata with ``replica``)."""
        return self._dispatch(list(texts), want_labels=True, **kw)

    def segment(self, texts, *, top_k=None, reject_threshold=None, **kw):
        """(segmentation result dicts, response metadata with ``replica``),
        from a replica's ``/detect?mode=segment`` (which resolves its
        model's default knobs)."""
        return self._dispatch(
            list(texts), want_labels=False,
            segment_kw={"top_k": top_k, "reject_threshold": reject_threshold}, **kw,
        )

    def _dispatch(self, texts: list, *, want_labels: bool, segment_kw: dict | None = None,
                  priority: str = INTERACTIVE, deadline_ms: float | None = None,
                  trace_id: str | None = None, tenant: str | None = None):
        # One trace id per routed request (minted here when the caller
        # brought none): the router's spans and the serving replica's
        # carry the same id.
        t0 = time.perf_counter()
        with trace_request(trace_id) as tid:
            return self._dispatch_traced(
                texts, t0=t0, want_labels=want_labels, segment_kw=segment_kw,
                priority=priority, deadline_ms=deadline_ms, trace_id=tid, tenant=tenant,
            )

    def _dispatch_traced(self, texts: list, *, t0: float, want_labels: bool,
                         segment_kw: dict | None, priority: str, deadline_ms: float | None,
                         trace_id: str, tenant: str | None):
        rows = len(texts)
        excluded: set[str] = set()
        saturated: list[float] = []
        # Absolute deadline, stamped once: each failover gets what remains.
        deadline_at = None if deadline_ms is None else t0 + float(deadline_ms) / 1e3
        # No hashing while the table is off; an empty signature short-
        # circuits every quarantine call.
        sig = signature_of(texts) if self.quarantine.enabled else ""
        if sig and self.quarantine.check(sig):
            REGISTRY.incr("fleet/quarantine_rejects")
            log_event(_log, "fleet.quarantine_reject", signature=sig, rows=rows,
                      trace_id=trace_id)
            raise QueryQuarantined(sig, self.quarantine.deaths_threshold)
        attempt = 0
        while attempt < self.dispatch_attempts:
            attempt_deadline_ms = None
            if deadline_at is not None:
                attempt_deadline_ms = (deadline_at - time.perf_counter()) * 1e3
                if attempt_deadline_ms < self.deadline_floor_ms:
                    # Dead on arrival: 504 here, no replica spent on it.
                    REGISTRY.incr("fleet/deadline_rejects")
                    raise ServeDeadlineExceeded(
                        f"remaining deadline {max(attempt_deadline_ms, 0.0):.1f}ms is below the "
                        f"{self.deadline_floor_ms:g}ms dispatch floor after {attempt} attempt(s)"
                    )
            # Every attempt after the first is a retry and pays a token.
            if attempt > 0 and not self.retry_budget.try_spend(reason="failover"):
                REGISTRY.incr("fleet/shed_requests")
                raise FleetSaturated(
                    f"retry budget exhausted after {attempt} attempt(s) "
                    f"({self.retry_budget.describe()['tokens']} tokens)",
                    reason="retry_budget_exhausted",
                    retry_after_s=max(self.probe_interval_s, 0.05),
                )
            h = self._pick(rows, excluded)
            if h is None:
                break
            attempt += 1
            self.quarantine.note_dispatch(h.name, sig, texts)
            try:
                out, meta, served_by = self._attempt(
                    h, texts, rows=rows, attempt=attempt, excluded=excluded,
                    saturated=saturated, sig=sig, want_labels=want_labels,
                    segment_kw=segment_kw, priority=priority,
                    deadline_ms=attempt_deadline_ms, trace_id=trace_id, tenant=tenant,
                )
            except Exception as e:
                if self._classify_failure(h, e, excluded, saturated, sig, texts):
                    continue
                raise
            self.retry_budget.record_success()
            REGISTRY.incr("fleet/requests")
            REGISTRY.observe("fleet/request_s", time.perf_counter() - t0)
            REGISTRY.observe("fleet/attempts_per_request", attempt)
            meta["replica"] = served_by
            return out, meta
        # Every eligible replica shed or died under this request: a
        # retryable fleet-wide 503 either way.
        REGISTRY.incr("fleet/shed_requests")
        if saturated:
            positive = [s for s in saturated if s > 0]
            retry_after = min(positive) if positive else self.probe_interval_s
            raise FleetSaturated(
                f"every ready replica shed ({len(saturated)} saturated, "
                f"{len(excluded) - len(saturated)} failed)",
                reason="fleet_saturated",
                retry_after_s=max(retry_after, 0.001),
            )
        raise NoReadyReplica(
            f"no ready replica (eligible={self.eligible()}, excluded={sorted(excluded)})",
            reason="no_ready_replica",
            retry_after_s=max(self.probe_interval_s * 2, self.probe_timeout_s / 2, 0.05),
        )

    # ---------------------------------------------- swap coordination hooks --
    def pin_version(self, version: str | None) -> None:
        """Route only to replicas serving ``version`` (None clears). The
        fleet swap pins the old version before its first flip and moves the
        pin once, right after it."""
        with self._lock:
            self._pin = version
        log_event(_log, "fleet.pin", version=version)

    @property
    def pinned_version(self) -> str | None:
        with self._lock:
            return self._pin

    def set_draining(self, name: str, draining: bool) -> None:
        h = self._handle(name)
        with self._lock:
            h.draining = draining

    def note_version(self, name: str, version: str | None) -> None:
        """Record a replica's version without waiting for a probe (the
        fleet swap calls this at each flip)."""
        h = self._handle(name)
        with self._lock:
            h.version = version

    def outstanding(self, name: str) -> int:
        h = self._handle(name)
        with self._lock:
            return h.outstanding_rows

    def wait_drained(self, name: str, timeout_s: float | None = None) -> bool:
        """Wait until no routed request is outstanding on ``name``."""
        deadline = time.monotonic() + (self.drain_timeout_s if timeout_s is None else timeout_s)
        while self.outstanding(name) > 0:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def _handle(self, name: str) -> ReplicaHandle:
        with self._lock:
            for h in self._handles:
                if h.name == name:
                    return h
        raise ValueError(f"unknown replica {name!r}")

    # ------------------------------------------------------------- status ---
    def healthz(self) -> dict:
        with self._lock:
            replicas = [h.describe() for h in self._handles]
            pin = self._pin
        eligible = self.eligible()
        return {
            "ok": bool(eligible),
            "router": True,
            "ready_replicas": eligible,
            "pinned_version": pin,
            "replicas": replicas,
            "uptime_s": round(time.monotonic() - self._started, 3),
            "retry_budget": self.retry_budget.describe(),
            "quarantine": self.quarantine.describe(),
            "hedging": {
                "enabled": self.hedge_enable,
                "quantile": self.hedge_quantile,
                "min_ms": self.hedge_min_ms,
                "delay_ms": round(self._hedge_delay_s() * 1e3, 3),
            },
        }

    def readyz(self) -> dict:
        eligible = self.eligible()
        return {
            "ready": bool(eligible),
            "reasons": [] if eligible else ["no_ready_replica"],
            "version": self.pinned_version,
            "ready_replicas": eligible,
        }


class RouterServer(JsonHTTPFront):
    """HTTP front end of a router, with one replica's JSON surface
    (``/score`` ``/detect`` ``/healthz[/live|/ready]`` ``/varz``
    ``/telemetryz`` ``/admin/swap`` ``/admin/rollback``), so a
    :class:`~.client.ServeClient` drives a fleet as it drives one server;
    responses also carry the serving ``replica``. A request's ``tenant``
    goes to the replica untouched; the admin endpoints need an attached
    :class:`~.fleet.ServeFleet` and refuse a tenant.

    ``collector``: a :class:`~..telemetry.aggregate.FleetCollector` whose
    merged view ``/varz`` serves and whose scrape state ``/healthz``
    reports. ``slo``: a :class:`~..telemetry.slo.SloEvaluator` whose
    status ``/healthz`` and ``/varz`` carry; a burning objective's reason
    joins ``/healthz``'s ``reasons`` while routing goes on. The caller
    feeds it (``slo.ingest(collector.aggregate(), now=...)``).
    """

    thread_name = "fleet-http"

    def __init__(self, router: FleetRouter, *, fleet=None, host: str = "127.0.0.1",
                 port: int = 8000, collector=None, slo=None):
        self.router = router
        self.fleet = fleet
        self.collector = collector
        self.slo = slo
        super().__init__(host, port)

    def score(self, payload: dict, *, labels: bool, mode: str | None = None) -> dict:
        texts = payload.get("texts", payload.get("docs"))
        if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
            raise ValueError('"texts" must be a list of strings')
        priority = payload.get("priority", INTERACTIVE)
        if priority not in LANES:
            raise ValueError(f"unknown priority {priority!r}; expected one of {LANES}")
        deadline_ms = payload.get("deadline_ms")
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
        if mode not in (None, "label", "segment"):
            raise ValueError(f"unknown mode {mode!r}; expected 'label' or 'segment'")
        kw = dict(priority=priority, deadline_ms=deadline_ms, trace_id=payload.get("trace_id"),
                  tenant=payload.get("tenant"))
        if labels and mode == "segment":
            out, meta = self.router.segment(
                texts, top_k=payload.get("top_k"),
                reject_threshold=payload.get("reject_threshold"), **kw,
            )
            meta["mode"] = "segment"
            meta["results"] = out
        elif labels:
            out, meta = self.router.detect(texts, **kw)
            # A segment-mode model answers /detect with results.
            meta["results" if meta.get("mode") == "segment" else "labels"] = out
        else:
            out, meta = self.router.score(texts, **kw)
            # f32 -> f64 -> JSON double round-trips: bit for bit end to end.
            meta["scores"] = [[float(v) for v in row] for row in out]
        return meta

    def _check_admin(self, payload: dict | None) -> None:
        # A fleet swap moves every replica's single model: performing it
        # for a request that named a tenant would move the wrong model.
        if payload and payload.get("tenant") is not None:
            raise ValueError(
                '"tenant" is not supported by the fleet admin surface; send tenant-scoped '
                "swaps to a zoo-backed replica's /admin endpoints"
            )
        if self.fleet is None:
            raise ServeError("no fleet attached to this router front end")

    def swap(self, payload: dict) -> dict:
        self._check_admin(payload)
        path = payload.get("path")
        if not isinstance(path, str) or not path:
            raise ValueError('"path" must name a saved model directory')
        return {"version": self.fleet.swap(path, version=payload.get("version"))}

    def rollback(self, payload: dict | None = None) -> dict:
        self._check_admin(payload)
        return {"version": self.fleet.rollback()}

    def healthz(self) -> dict:
        out = self.router.healthz()
        out["draining"] = self._draining
        out["uptime_s"] = round(time.monotonic() - self._started, 3)
        if self.slo is not None:
            slo = self.slo.status()
            out["slo"] = slo
            if slo["burning"]:
                out["reasons"] = list(out.get("reasons") or []) + slo["reasons"]
        if self.collector is not None:
            out["telemetry"] = {
                "members": self.collector.members(),
                "scrapes": self.collector.scrapes,
                "scrape_failures": self.collector.scrape_failures,
                "freshness_s": round(self.collector.freshness_s(), 3),
            }
        return out

    def readyz(self) -> dict:
        out = self.router.readyz()
        if self._draining:
            out["ready"] = False
            out["reasons"] = list(out.get("reasons") or []) + ["draining"]
        out["draining"] = self._draining
        return out

    def varz(self) -> dict:
        snap = REGISTRY.snapshot()
        return {
            "stages": REGISTRY.stage_summary(),
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "histograms": {
                name: h for name, h in snap["histograms"].items()
                if not name.startswith(("span:", "span_device:"))
            },
            "fleet": self.router.healthz(),
            "fleet_telemetry": None if self.collector is None else {
                "aggregate": self.collector.aggregate(),
                "replicas": self.collector.per_replica(),
            },
            "slo": None if self.slo is None else self.slo.status(),
            "config": exec_config.effective_config(),
        }
