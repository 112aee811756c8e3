"""Host-side execution core: plan, dedup, run, pipeline, guard (no device work).

Port of ``spark_languagedetector_tpu.exec.core``:

  * :func:`rows_under_byte_budget` — the byte-budget row sizing shared by the
    scoring runner (``batch_bytes``) and the fit pipeline;
  * :func:`dedup_items` / :func:`dedup_counted` — content-addressed in-flight
    dedup of one call's work items, the latter with the ``dedup/*``
    counters;
  * :func:`plan_micro_batches` — the bucket-group / carry micro-batch planner
    (a small closed set of padded shapes; a bucket's remainder rides up
    into the next wider bucket so a call ends with at most one partly
    filled batch);
  * :func:`run_ordered` — the serial-or-threaded plan executor under the
    runner's dispatch loop;
  * :func:`ordered_prefetch` — the bounded, ordered pipeline under the
    fit's packer (one worker) and the streaming engine (``workers``
    transforms in flight);
  * :func:`guarded_dispatch` — the breaker-gated fast path + classified retry
    + degraded-ladder hand-off the runner's dispatch rides;
  * :class:`AdmissionQueue` — priority lanes, bounded rows, flush-window
    coalescing and explicit shedding behind ``serve/batcher``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

from ..ops.encoding import bucket_length
from ..telemetry import REGISTRY


def rows_under_byte_budget(
    pad_to: int, byte_budget: int, max_rows: int, floor: int = 64
) -> int:
    """Micro-batch rows for a padded width: ``max_rows`` halved until the
    padded batch fits ``byte_budget``, never below ``floor``. Halving keeps
    the (rows, pad_to) set a small lattice of power-of-two fractions."""
    rows = max_rows
    while rows * pad_to > byte_budget and rows > floor:
        rows //= 2
    return rows


def dedup_items(keys: Sequence) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Content-addressed dedup over one call's work items.

    ``keys`` are hashable content keys (``(doc, lang)`` pairs for the fit);
    dict hashing + equality makes a match exact. Returns None when every
    key is distinct, else ``(first_idx, inverse, mult)``: int64 indices of
    each key's first occurrence in first-seen order, the [N] map with
    ``keys[i] == keys[first_idx[inverse[i]]]``, and each unique key's
    multiplicity.
    """
    n = len(keys)
    if len(set(keys)) == n:  # the all-unique fast path, at C speed
        return None
    index: dict = {}
    inverse = np.empty(n, dtype=np.int64)
    first: list[int] = []
    mult: list[int] = []
    for i, key in enumerate(keys):
        j = index.setdefault(key, len(first))
        if j == len(first):
            first.append(i)
            mult.append(1)
        else:
            mult[j] += 1
        inverse[i] = j
    return (
        np.asarray(first, dtype=np.int64),
        inverse,
        np.asarray(mult, dtype=np.int64),
    )


def dedup_counted(keys: Sequence, size_of: Callable = len):
    """:func:`dedup_items` plus the shared telemetry contract.

    The ``dedup/rows_in`` / ``dedup/rows_unique`` / ``dedup/bytes_saved``
    counters and the ``dedup/unique_ratio`` distribution carry the JAX
    package's names; the scoring runner and the fit planner both record
    them here. ``size_of`` maps a key to its payload byte length (what
    ``bytes_saved`` measures); it is only evaluated on the duplicate path,
    keeping the all-unique fast path at one set build + three counter
    bumps."""
    n = len(keys)
    d = dedup_items(keys)
    REGISTRY.incr("dedup/rows_in", n)
    if d is None:
        REGISTRY.incr("dedup/rows_unique", n)
        REGISTRY.observe("dedup/unique_ratio", 1.0)
        return None
    first_idx = d[0]
    REGISTRY.incr("dedup/rows_unique", len(first_idx))
    REGISTRY.incr(
        "dedup/bytes_saved",
        sum(size_of(k) for k in keys)
        - sum(size_of(keys[int(i)]) for i in first_idx),
    )
    REGISTRY.observe("dedup/unique_ratio", len(first_idx) / n)
    return d


def plan_micro_batches(
    sizes: Sequence[int],
    *,
    length_buckets: Sequence[int],
    rows_for: Callable[[int], int],
    order: Sequence[int] | None = None,
) -> list[tuple[np.ndarray, int]]:
    """Group work items by padded-length bucket, emit ``rows_for(pad_to)``-row
    batches per bucket, and carry each bucket's remainder into the next wider
    bucket. Returns ``[(sel indices, pad_to), ...]`` with every ``pad_to`` a
    member of ``length_buckets`` (callers chunk oversized items first).
    """
    idx_iter: Iterable[int] = range(len(sizes)) if order is None else order
    by_bucket: dict[int, list[int]] = {}
    for i in idx_iter:
        b = bucket_length(sizes[i] or 1, length_buckets)
        by_bucket.setdefault(b, []).append(int(i))
    plan: list[tuple[np.ndarray, int]] = []
    carry: list[int] = []
    for pad_to in sorted(by_bucket):
        idxs = carry + by_bucket[pad_to]
        rows = rows_for(pad_to)
        full_end = len(idxs) - len(idxs) % rows
        for start in range(0, full_end, rows):
            plan.append((np.asarray(idxs[start : start + rows]), pad_to))
        carry = idxs[full_end:]
    if carry:
        pad_to = bucket_length(max(sizes[i] for i in carry) or 1, length_buckets)
        rows = rows_for(pad_to)
        for start in range(0, len(carry), rows):
            plan.append((np.asarray(carry[start : start + rows]), pad_to))
    return plan


def run_ordered(plan: Sequence, fn: Callable, workers: int) -> list:
    """Run ``fn`` over every planned item, results in plan order.

    ``workers > 1`` overlaps one item's host work (the native packer and
    the copies release the GIL) with another's — the batch path's
    dispatch loop. Serial when the plan is short or one worker suffices.
    """
    workers = max(1, min(int(workers), len(plan)))
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(fn, plan))
    return [fn(item) for item in plan]


def ordered_prefetch(
    it: Iterable,
    fn: Callable,
    *,
    depth: int = 0,
    workers: int = 1,
    abort_wait: bool = True,
) -> Iterator[tuple[object, Callable, bool, int]]:
    """Bounded, ordered producer/consumer pipeline over ``it``.

    Yields ``(item, thunk, prefetched, pending)`` per source item, in
    source order; ``thunk()`` returns (or raises) ``fn(item)``'s result.
    With ``depth == 0`` nothing runs ahead — ``thunk`` computes inline
    when called (the caller keeps its synchronous semantics and its own
    spans/timers around the call). With ``depth > 0``, up to ``depth``
    items beyond the yielded one are in flight on ``workers`` threads,
    and items are pulled from ``it`` at most ``depth + 1`` ahead of the
    consumer — a consuming source (Kafka) never loses more than the
    pipeline depth on a crash.

    ``pending`` counts the in-flight items *including* the yielded one
    (the streaming engine's queue-depth signal). Closing the generator
    cancels not-yet-started work; with ``abort_wait`` (the default) it
    also joins the pool, so a consumer exception leaves no worker behind
    and the next run's launches can't interleave with a leftover one's
    (the streaming engine's choice). ``abort_wait=False`` returns without
    joining a possibly wedged worker (the fit packer's choice: a copy
    stuck on a dead link must not turn a fit abort into a hang; the
    orphan is joined at interpreter exit).
    """
    it = iter(it)
    if depth <= 0:
        for item in it:
            yield item, (lambda item=item: fn(item)), False, 1
        return
    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(max_workers=max(1, workers))
    in_flight: deque = deque()
    drained = False
    try:
        while True:
            while len(in_flight) <= depth:
                try:
                    item = next(it)
                except StopIteration:
                    break
                in_flight.append((item, ex.submit(fn, item)))
            if not in_flight:
                drained = True
                return
            pending = len(in_flight)
            item, fut = in_flight.popleft()
            yield item, fut.result, True, pending
    finally:
        ex.shutdown(wait=drained or abort_wait, cancel_futures=True)
        # Drop queued (item, future) pairs now: they may hold pinned host
        # buffers the caller expects released when the generator closes.
        in_flight.clear()


def guarded_dispatch(
    fast: Callable[[], object],
    *,
    policy,
    site: str,
    breaker=None,
    degraded: Callable[[BaseException | None], object] | None = None,
    on_retry=None,
    on_recovered: Callable[[], None] | None = None,
    log_fields: dict | None = None,
):
    """The shared failure wiring around one dispatch:
    breaker-gated fast path under the classified retry ``policy``, then the
    ``degraded`` ladder.

    With ``degraded=None`` (the fallback disabled) only the policy replay
    applies. Otherwise: while the breaker
    admits, the fast path runs under the policy; a retryable exhaustion
    falls through to ``degraded(cause)``; a success after degraded batches
    calls ``on_recovered`` once the breaker agrees the path is healthy. An
    open breaker short-circuits straight to the ladder
    (``resilience/breaker_short_circuit``).
    """
    if degraded is None:
        return policy.run(
            fast, site=site, on_retry=on_retry, log_fields=log_fields
        )
    cause: BaseException | None = None
    if breaker is None or breaker.allow():
        try:
            result = policy.run(
                fast,
                site=site,
                breaker=breaker,
                on_retry=on_retry,
                log_fields=log_fields,
            )
        except Exception as e:
            if not policy.classify(e):
                raise
            cause = e
        else:
            if on_recovered is not None:
                on_recovered()
            return result
    else:
        REGISTRY.incr("resilience/breaker_short_circuit")
    return degraded(cause)


class AdmissionQueue:
    """Priority-lane admission queue with flush-window coalescing and
    explicit shedding: the serving front end's half of the core
    (``serve/batcher`` wraps it).

    Items are admitted into lanes (drained in ``lanes`` order, so a bulk
    backlog never delays an interactive request) and popped as one
    coalesced batch by :meth:`next_batch`: the flush fires when
    ``max_rows`` are queued or the oldest admitted item has waited
    ``max_wait_s`` on ``clock``. Backpressure is reject-newest and
    explicit: :meth:`admit` returns a shed reason (queue past
    ``max_queue_rows``, estimated wait past ``slo_s``, or the caller's
    ``shed_probe``) instead of queueing into a blown SLO. One consumer
    thread is assumed (the dispatcher); any number of producers may admit
    concurrently.
    """

    def __init__(
        self,
        *,
        max_rows: int,
        max_wait_s: float,
        max_queue_rows: int,
        slo_s: float = 0.0,
        lanes: Sequence[str] = ("interactive", "bulk"),
        shed_probe: Callable[[str], str | None] | None = None,
        on_change: Callable[[int, int], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_rows < 1 or max_queue_rows < 1:
            raise ValueError("max_rows and max_queue_rows must be >= 1")
        self.max_rows = int(max_rows)
        self.max_wait_s = float(max_wait_s)
        self.max_queue_rows = int(max_queue_rows)
        self.slo_s = float(slo_s)
        self.lanes = tuple(lanes)
        self._shed_probe = shed_probe
        self._on_change = on_change
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # lane -> deque of (item, rows, admitted_at)
        self._queues: dict[str, deque] = {p: deque() for p in self.lanes}
        self.queued_rows = 0
        self.inflight_rows = 0
        # Cumulative rows ever admitted: the monotone arrival odometer the
        # elastic fleet differentiates into an arrival rate (the dispatch
        # EMA below holds its last value across silence).
        self.admitted_rows = 0
        # Rows/s over recent dispatches (EMA): the estimated-wait shed
        # signal. Zero until the first dispatch lands.
        self.ema_rows_per_s = 0.0
        self.closed = False
        # Queue-local shed tallies (everything but "closed", which is
        # lifecycle, not backpressure), for /healthz.
        self.shed_requests = 0
        self.shed_rows = 0
        self.shed_reasons: dict[str, int] = {}

    # ------------------------------------------------------------- admit ----
    def admit(self, item, rows: int, lane: str) -> tuple[str | None, float]:
        """Atomically admit one item, or return why it was shed.

        Returns ``(None, est_wait_s)`` on admission, else
        ``(reason, est_wait_s)`` with the item NOT queued. Reasons:
        ``"closed"``, ``"queue_full"``, ``"slo"``, or whatever the
        ``shed_probe`` returned for this lane. Reject-newest: queued work
        is never evicted."""
        if lane not in self._queues:
            raise ValueError(
                f"unknown lane {lane!r}; expected one of {self.lanes}"
            )
        with self._cv:
            if self.closed:
                return "closed", 0.0
            backlog = self.queued_rows + self.inflight_rows
            wait_s = (
                backlog / self.ema_rows_per_s
                if self.ema_rows_per_s > 0
                else 0.0
            )
            if self.queued_rows + rows > self.max_queue_rows:
                return self._shed_locked("queue_full", rows), wait_s
            if self.slo_s > 0 and wait_s > self.slo_s:
                return self._shed_locked("slo", rows), wait_s
            if self._shed_probe is not None:
                reason = self._shed_probe(lane)
                if reason is not None:
                    return self._shed_locked(reason, rows), wait_s
            self._queues[lane].append((item, int(rows), self._clock()))
            self.queued_rows += rows
            self.admitted_rows += rows
            self._notify_change_locked()
            self._cv.notify_all()
        return None, wait_s

    def _shed_locked(self, reason: str, rows: int) -> str:
        self.shed_requests += 1
        self.shed_rows += rows
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
        return reason

    def _notify_change_locked(self) -> None:
        if self._on_change is not None:
            depth = sum(len(q) for q in self._queues.values())
            self._on_change(depth, self.queued_rows)

    def _oldest_locked(self) -> float | None:
        ages = [q[0][2] for q in self._queues.values() if q]
        return min(ages) if ages else None

    def _take_locked(self, key) -> list:
        """Pop one coalesced batch: lanes in priority order, whole items
        only, until ``max_rows`` is reached (the first item is always
        taken, even when larger). ``key(item)`` partitions items that
        cannot share a dispatch: the first item taken sets the batch's key,
        whose items are gathered from every lane; items of other keys are
        stepped over and keep their places (they lead later batches). Ending
        the batch at the first key flip instead would serve interleaved
        kinds of request (score, labels, segment from clients in lockstep)
        one request per dispatch."""
        batch: list = []
        rows = 0
        lead_key = None
        for lane in self.lanes:
            q = self._queues[lane]
            skipped: list = []
            while q and (rows < self.max_rows or not batch):
                if key is not None:
                    k = key(q[0][0])
                    if batch and k != lead_key:
                        skipped.append(q.popleft())
                        continue
                    lead_key = k
                item, item_rows, _ = q.popleft()
                batch.append(item)
                rows += item_rows
            q.extendleft(reversed(skipped))
        self.queued_rows -= rows
        self.inflight_rows = rows
        self._notify_change_locked()
        return batch

    # -------------------------------------------------------------- take ----
    def next_batch(self, *, key: Callable | None = None) -> list | None:
        """Block until a coalesced batch is due, pop and return it; None
        once the queue is closed and drained. The window holds until
        ``max_rows`` are queued or the oldest item has waited
        ``max_wait_s`` by ``clock`` (or the queue closes)."""
        while True:
            with self._cv:
                while self.queued_rows == 0 and not self.closed:
                    self._cv.wait()
                if self.queued_rows == 0 and self.closed:
                    return None
                while self.queued_rows < self.max_rows:
                    oldest = self._oldest_locked()
                    if oldest is None:
                        break
                    remaining = oldest + self.max_wait_s - self._clock()
                    if remaining <= 0 or self.closed:
                        break
                    self._cv.wait(remaining)
                if self.queued_rows == 0:
                    continue
                return self._take_locked(key)

    def wake(self) -> None:
        """Re-check the flush window now (an injected ``clock`` moved)."""
        with self._cv:
            self._cv.notify_all()

    def done(self) -> None:
        """Mark the in-flight batch settled (the consumer calls this after
        every dispatch, success or failure)."""
        with self._cv:
            self.inflight_rows = 0
            self._cv.notify_all()

    def record_rate(self, rows: int, seconds: float) -> None:
        """Fold one dispatch's throughput into the shed-signal EMA."""
        if seconds <= 0:
            return
        rate = rows / seconds
        with self._lock:
            self.ema_rows_per_s = (
                rate
                if self.ema_rows_per_s == 0.0
                else 0.7 * self.ema_rows_per_s + 0.3 * rate
            )

    # ------------------------------------------------------------- admin ----
    def close(self, drain: bool = True) -> list:
        """Stop admitting. With ``drain`` the queued items stay for the
        consumer; otherwise they are evicted and returned so the caller
        can fail them explicitly (never a silent drop)."""
        evicted: list = []
        with self._cv:
            self.closed = True
            if not drain:
                for q in self._queues.values():
                    while q:
                        item, rows, _ = q.popleft()
                        self.queued_rows -= rows
                        evicted.append(item)
                self._notify_change_locked()
            self._cv.notify_all()
        return evicted

    def stats(self) -> dict:
        with self._lock:
            return {
                "queue_depth": sum(len(q) for q in self._queues.values()),
                "queued_rows": self.queued_rows,
                "inflight_rows": self.inflight_rows,
                "admitted_rows": self.admitted_rows,
                "ema_rows_per_s": round(self.ema_rows_per_s, 3),
                "max_rows": self.max_rows,
                "max_wait_ms": self.max_wait_s * 1e3,
                "max_queue_rows": self.max_queue_rows,
                "slo_ms": self.slo_s * 1e3,
                "closed": self.closed,
                "shed_requests": self.shed_requests,
                "shed_rows": self.shed_rows,
                "shed_reasons": dict(self.shed_reasons),
            }
