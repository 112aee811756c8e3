"""Continuous micro-batcher: concurrent small requests → coalesced dispatches.

Port of ``spark_languagedetector_tpu.serve.batcher``. Online serving is
many concurrent callers, each with a handful of documents, all wanting low
latency; the runner is fastest on large batches of its bucketed shapes.
This module is the admission queue between the two:

  * requests are admitted into priority lanes (``interactive`` ahead of
    ``bulk``) and coalesced into one ``BatchRunner.score``/``predict_ids``
    call (or one ``segment_documents`` call for segment-mode requests) by
    a single dispatcher thread; a flush fires when the queue reaches
    ``max_rows`` or the oldest admitted request has waited ``max_wait_ms``
    (env ``LANGDETECT_SERVE_MAX_ROWS`` / ``LANGDETECT_SERVE_MAX_WAIT_MS``);
  * demux is deterministic: each request's rows come back as a contiguous
    slice of the coalesced result, and the batcher adds no numeric step of
    its own. The fused kernels and the gather scorer count and sum per
    document, so a response is bit-identical to calling the runner
    directly with the same documents; the hybrid strategy's float64 matmul
    may differ in the last f32 bit across coalesce geometries (labels
    exact, scores in the reduction-order class);
  * backpressure is explicit: the queue is bounded (rows), an estimated
    wait past the SLO sheds, and an open breaker or a degraded-ladder
    runner sheds the bulk lane. A shed request fails fast with
    :class:`ServeOverloaded` (HTTP 503), never hangs. The ``serve/admit``
    fault site lets chaos plans force sheds deterministically.

A kernel path never falls back: a dispatch error (after the runner's own
retry policy) fails every request of the batch with that error.

Model hot-swap composes through the source: the dispatcher leases the
serving runner per dispatch (see :mod:`.registry`), so a swap lands
between dispatches and every request is answered by exactly one version.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from concurrent.futures import Future
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..exec import config as exec_config
from ..exec.core import AdmissionQueue
from ..ops.encoding import UTF8
from ..resilience import faults
from ..segment import SegmentOptions, segment_documents
from ..telemetry import REGISTRY, current_trace_id, new_trace_id, span, trace_request
from ..utils.logging import get_logger, log_event
from .cache import ScoreCache

_log = get_logger("serve.batcher")

# Process-unique tokens for _StaticSource cache scoping.
_STATIC_UIDS = itertools.count()

# Priority lanes, drained in this order: a bulk backlog must never add
# queueing delay to an interactive request.
INTERACTIVE = "interactive"
BULK = "bulk"
LANES = (INTERACTIVE, BULK)


class ServeError(RuntimeError):
    """Base class for serving-layer failures."""


class ServeOverloaded(ServeError):
    """Request shed at admission (queue full, SLO blown, degraded bulk,
    or an injected ``serve/admit`` fault). Maps to HTTP 503."""

    def __init__(self, message: str, *, reason: str = "overloaded",
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class ServeDeadlineExceeded(ServeError):
    """The request's deadline passed while it was still queued: rejected
    explicitly instead of spending device time on a dead response. Maps
    to HTTP 504."""


class ServeClosed(ServeError):
    """Submitted to a batcher that has been closed."""


@dataclass
class ServeResult:
    """One request's demuxed response.

    ``values`` is the request's contiguous slice of the coalesced result:
    float32 ``[N, L]`` scores, int32 ``[N]`` argmax ids in label mode, or
    a list of N result dicts in segment mode.
    """

    values: np.ndarray
    version: str
    trace_id: str
    queue_wait_s: float
    dispatch_s: float
    languages: tuple[str, ...] | None = None
    # Rows of the dispatch that served this request, its own included.
    rows_coalesced: int = 0

    @property
    def labels(self) -> list[str]:
        if self.languages is None:
            raise ServeError("serving source carries no language names")
        return [self.languages[int(i)] for i in self.values]

    @property
    def results(self) -> list[dict]:
        """Segment-mode results (the ``values`` list, named)."""
        return list(self.values)


@dataclass
class _Request:
    docs: list[bytes]
    want_labels: bool
    priority: str
    deadline: float | None  # absolute, on the batcher's clock
    trace_id: str
    admitted_at: float
    # Segment mode: the decode's options (None ⇒ label/score mode).
    # Requests coalesce only with requests of the same key below, so one
    # dispatched batch is one (mode, knobs) pair.
    segment_opts: SegmentOptions | None = None
    future: Future = field(default_factory=Future)

    def batch_key(self):
        return (
            self.want_labels,
            None if self.segment_opts is None else self.segment_opts.key(),
        )


class _StaticSource:
    """A bare :class:`~..api.runner.BatchRunner` behind the registry's
    lease protocol (version pinned to ``"v0"``)."""

    class _Entry:
        __slots__ = ("runner", "version", "languages", "model", "uid")

        def __init__(self, runner):
            self.runner = runner
            self.version = "v0"
            self.languages = None
            self.model = None
            # Cache-scope token: every static source pins "v0", so two
            # batchers over different runners sharing one ScoreCache need
            # a per-source token to keep their keys apart.
            self.uid = f"static_{next(_STATIC_UIDS)}"

    def __init__(self, runner):
        self._entry = self._Entry(runner)

    def peek(self):
        return self._entry

    def lease(self):
        return nullcontext(self._entry)


class ContinuousBatcher:
    """SLO-aware continuous batcher in front of a runner (or registry).

    ``source`` is either a :class:`~..api.runner.BatchRunner` or anything
    with the registry lease protocol (``peek()`` and ``lease()`` yielding
    an entry with ``runner``/``version``/``languages`` — see
    :class:`~.registry.ModelRegistry`). One dispatcher thread owns all
    device work, so concurrent callers never race the runner. Knobs left
    None resolve through ``exec.config`` (explicit > env > tuning profile
    > default); ``clock`` times the flush window.
    """

    def __init__(
        self,
        source,
        *,
        max_wait_ms: float | None = None,
        max_rows: int | None = None,
        max_queue_rows: int | None = None,
        slo_ms: float | None = None,
        cache: ScoreCache | None = None,
        cache_enable: bool | None = None,
        clock=time.monotonic,
        name: str = "serve",
        tenant: str | None = None,
    ):
        if not hasattr(source, "lease"):
            source = _StaticSource(source)
        self._source = source
        self.name = name
        # A model zoo's batcher serves one tenant: its cache keys carry the
        # tenant (a cache shared across tenants never cross-answers) and its
        # sheds also count ``zoo/shed/<tenant>``.
        self.tenant = tenant
        # The version-keyed score cache, consulted per document under the
        # dispatch's lease: an explicit instance wins (shared across
        # batchers), else one is built when ``cache_enable`` resolves true.
        if cache is None and bool(exec_config.resolve("cache_enable", cache_enable)):
            cache = ScoreCache()
        self.cache = cache
        self._clock = clock
        self._queue = AdmissionQueue(
            max_rows=int(exec_config.resolve("serve_max_rows", max_rows)),
            max_wait_s=float(exec_config.resolve("serve_max_wait_ms", max_wait_ms)) / 1000.0,
            max_queue_rows=int(exec_config.resolve("serve_queue_rows", max_queue_rows)),
            slo_s=float(exec_config.resolve("serve_slo_ms", slo_ms)) / 1000.0,
            lanes=LANES,
            shed_probe=self._degraded_probe,
            on_change=self._on_queue_change,
            clock=clock,
        )
        self._thread = threading.Thread(target=self._run, name=f"{name}-batcher", daemon=True)
        self._thread.start()
        log_event(
            _log, "serve.batcher.start", max_wait_ms=self.max_wait_s * 1e3,
            max_rows=self.max_rows, max_queue_rows=self.max_queue_rows,
            slo_ms=self.slo_s * 1e3,
        )

    def _degraded_probe(self, lane: str) -> str | None:
        """Admission-time health shed: while the serving runner's breaker
        is open (or its last dispatch rode the degradation ladder), the
        bulk lane sheds so the rest of the capacity serves interactive
        traffic. On the card only a runner without a kernel
        (``strategy="gather"``) takes the ladder."""
        if lane != BULK:
            return None
        runner = getattr(self._source.peek(), "runner", None)
        breaker = getattr(runner, "breaker", None)
        state = breaker.state if breaker is not None else "closed"
        if state == "open" or getattr(runner, "_degraded_mode", False):
            return "degraded"
        return None

    def _on_queue_change(self, depth: int, queued_rows: int) -> None:
        REGISTRY.set_gauge("langdetect_serve_queue_depth", depth)
        REGISTRY.set_gauge("langdetect_serve_queue_rows", queued_rows)

    # Views onto the queue's knobs; the queue bound is settable at run
    # time (the next admission sees it).
    @property
    def max_rows(self) -> int:
        return self._queue.max_rows

    @property
    def max_wait_s(self) -> float:
        return self._queue.max_wait_s

    @property
    def slo_s(self) -> float:
        return self._queue.slo_s

    @property
    def max_queue_rows(self) -> int:
        return self._queue.max_queue_rows

    @max_queue_rows.setter
    def max_queue_rows(self, value: int) -> None:
        self._queue.max_queue_rows = int(value)

    @property
    def _ema_rows_per_s(self) -> float:
        return self._queue.ema_rows_per_s

    @_ema_rows_per_s.setter
    def _ema_rows_per_s(self, value: float) -> None:
        self._queue.ema_rows_per_s = float(value)

    # ------------------------------------------------------- admission ------
    def submit(
        self,
        byte_docs: Sequence[bytes],
        *,
        priority: str = INTERACTIVE,
        want_labels: bool = False,
        segment_options: SegmentOptions | None = None,
        deadline_ms: float | None = None,
        trace_id: str | None = None,
    ) -> Future:
        """Admit one request; returns a Future resolving to a
        :class:`ServeResult` (or raising the dispatch error).

        ``segment_options`` switches the request to the span-level
        segmentation result type; it excludes ``want_labels``. Raises
        :class:`ServeOverloaded` at once when the request is shed, so
        callers can retry elsewhere instead of queueing into a blown SLO.
        """
        if priority not in LANES:
            raise ValueError(f"unknown priority {priority!r}; expected one of {LANES}")
        if segment_options is not None and want_labels:
            raise ValueError("segment_options and want_labels are mutually exclusive")
        docs = list(byte_docs)
        # Chaos gate: an injected error here IS a shed, with the same
        # counters and exception.
        try:
            faults.inject("serve/admit")
        except faults.InjectedFault as e:
            self._count_shed(len(docs), "injected", priority)
            raise ServeOverloaded(
                "admission rejected (injected fault)", reason="injected",
                retry_after_s=self.max_wait_s,
            ) from e
        tid = trace_id or current_trace_id() or new_trace_id()
        if not docs:
            if self._queue.closed:
                raise ServeClosed(f"batcher {self.name!r} is closed")
            # Zero-row requests never wake the row-counting dispatcher:
            # answer them here with the runner's own empty result.
            entry = self._source.peek()
            L = int(getattr(getattr(entry, "runner", None), "num_langs", 0))
            fut: Future = Future()
            fut.set_result(ServeResult(
                values=(
                    [] if segment_options is not None
                    else np.zeros(0, np.int32) if want_labels
                    else np.zeros((0, L), np.float32)
                ),
                version=entry.version,
                trace_id=tid,
                queue_wait_s=0.0,
                dispatch_s=0.0,
                languages=getattr(entry, "languages", None),
            ))
            REGISTRY.incr("serve/admitted_requests")
            REGISTRY.incr("serve/requests")
            return fut
        now = self._clock()
        req = _Request(
            docs=docs,
            want_labels=want_labels,
            priority=priority,
            deadline=None if deadline_ms is None else now + deadline_ms / 1e3,
            trace_id=tid,
            admitted_at=now,
            segment_opts=segment_options,
        )
        # One atomic queue call: closed check, bound, SLO estimate and the
        # degraded-bulk probe under the queue lock (reject-newest).
        reason, wait_s = self._queue.admit(req, len(docs), priority)
        if reason == "closed":
            raise ServeClosed(f"batcher {self.name!r} is closed")
        if reason is not None:
            self._count_shed(len(docs), reason, priority)
            raise ServeOverloaded(
                f"request shed ({reason}): {self._queue.queued_rows} rows "
                f"queued, estimated wait {wait_s * 1e3:.1f}ms",
                reason=reason,
                retry_after_s=max(wait_s, self.max_wait_s),
            )
        REGISTRY.incr("serve/admitted_requests")
        return req.future

    def score(self, byte_docs: Sequence[bytes], **kw) -> np.ndarray:
        """Blocking convenience: admit + wait; float32 [N, L] scores."""
        return self.submit(byte_docs, **kw).result().values

    def predict_ids(self, byte_docs: Sequence[bytes], **kw) -> np.ndarray:
        """Blocking convenience: admit + wait; int32 [N] argmax ids."""
        return self.submit(byte_docs, want_labels=True, **kw).result().values

    def segment(self, byte_docs: Sequence[bytes], options: SegmentOptions | None = None,
                **kw) -> list[dict]:
        """Blocking convenience: admit + wait; one segmentation result
        dict per document."""
        return self.submit(
            byte_docs, segment_options=options or SegmentOptions(), **kw
        ).result().values

    def _count_shed(self, rows: int, reason: str, priority: str) -> None:
        REGISTRY.incr("serve/shed_requests")
        REGISTRY.incr("serve/shed_rows", rows)
        REGISTRY.incr(f"serve/shed_{reason}")
        if self.tenant is not None:
            REGISTRY.incr(f"zoo/shed/{self.tenant}")
        log_event(
            _log, "serve.shed", reason=reason, rows=rows, priority=priority,
            queued_rows=self._queue.queued_rows, trace_id=current_trace_id(),
        )

    # ------------------------------------------------------- dispatcher -----
    @staticmethod
    def _complete(req: _Request, result=None, error: Exception | None = None):
        """Resolve one request's future, tolerating caller-side cancels: a
        set on a cancelled future raises, and an exception here would kill
        the one dispatcher thread and hang every later request."""
        try:
            if error is not None:
                req.future.set_exception(error)
            else:
                req.future.set_result(result)
        except BaseException:
            REGISTRY.incr("serve/cancelled_requests")

    def _run(self) -> None:
        # Requests in one batch share a result mode and its knobs (the
        # key), so the demux below is a pure offset walk.
        while True:
            batch = self._queue.next_batch(key=lambda r: r.batch_key())
            if batch is None:
                return
            try:
                self._dispatch(batch)
            except Exception as e:  # safety net: the thread must survive
                log_event(_log, "serve.dispatcher_error", error=repr(e))
                for req in batch:
                    self._complete(req, error=ServeError(f"internal dispatcher error: {e!r}"))
            finally:
                self._queue.done()

    def _cache_scope(self, entry) -> str:
        """Cache key scope = tenant + model identity + version name. Version
        names repeat across sources (every registry auto-names "v1", every
        static source pins "v0"), so a cache shared across batchers needs
        the model uid (persisted with the model: replicas loading one path
        share entries) or the static source's token; a zoo's batcher
        prefixes its tenant, so tenants address disjoint entries."""
        scope = getattr(getattr(entry, "model", None), "uid", None) or getattr(entry, "uid", None)
        scope = f"{scope}:{entry.version}" if scope else entry.version
        return scope if self.tenant is None else f"tenant:{self.tenant}|{scope}"

    def _segmented(self, entry, docs: list[bytes], opts: SegmentOptions) -> list[dict]:
        """One coalesced segment-mode dispatch, through the score cache.

        The cache mode string carries every decode knob (``opts.key()``)
        plus the calibration version, so requests with different knobs, or
        the same knobs across a recalibration, never cross-answer. Values
        are the canonical JSON of the result dict, stored as uint8 arrays.
        """
        model = getattr(entry, "model", None)
        languages = getattr(entry, "languages", None) or (
            model.profile.languages if model is not None else None
        )
        if not languages:
            raise ServeError("serving source carries no language names for segment mode")
        calibration = getattr(model, "calibration", None)
        cache = self.cache

        def decode(miss_docs):
            return segment_documents(
                entry.runner, miss_docs, languages, options=opts, calibration=calibration,
            )

        if cache is None:
            return decode(docs)
        cal_version = calibration.version if calibration is not None else "uncal"
        mode = f"segment[{opts.key()}][cal={cal_version}]"
        encoding = getattr(entry.runner, "score_encoding", UTF8)
        version = self._cache_scope(entry)
        cached = cache.get_many(version, mode, encoding, docs)
        miss = [i for i, c in enumerate(cached) if c is None]
        out: list = [None if c is None else json.loads(bytes(c)) for c in cached]
        if miss:
            miss_docs = [docs[i] for i in miss]
            miss_out = decode(miss_docs)
            for j, i in enumerate(miss):
                out[i] = miss_out[j]
            cache.put_many(
                version, mode, encoding, miss_docs,
                [
                    np.frombuffer(json.dumps(r, sort_keys=True).encode("utf-8"), dtype=np.uint8)
                    for r in miss_out
                ],
            )
        return out

    def _scored(self, entry, docs: list[bytes], want_labels: bool):
        """One coalesced dispatch's results, through the score cache: hits
        from the leased version's stored results, misses through the
        runner in one call, every computed result written back. Without a
        cache this is exactly the direct runner call."""
        runner = entry.runner
        cache = self.cache
        if cache is None:
            return runner.predict_ids(docs) if want_labels else runner.score(docs)
        mode = "labels" if want_labels else "scores"
        encoding = getattr(runner, "score_encoding", UTF8)
        version = self._cache_scope(entry)
        cached = cache.get_many(version, mode, encoding, docs)
        miss = [i for i, c in enumerate(cached) if c is None]
        if miss:
            miss_docs = [docs[i] for i in miss]
            miss_out = runner.predict_ids(miss_docs) if want_labels else runner.score(miss_docs)
        if len(miss) == len(docs):
            out = miss_out
        else:
            # L from the results themselves: a cached value is an [L] row,
            # a miss result a [rows, L] block.
            if want_labels:
                out = np.empty(len(docs), np.int32)
            else:
                L = (
                    np.asarray(miss_out).shape[1] if miss
                    else np.asarray(next(c for c in cached if c is not None)).shape[0]
                )
                out = np.empty((len(docs), L), np.float32)
            for i, c in enumerate(cached):
                if c is not None:
                    out[i] = c
            for j, i in enumerate(miss):
                out[i] = miss_out[j]
        if miss:
            cache.put_many(version, mode, encoding, miss_docs, list(miss_out))
        return out

    def _dispatch(self, batch: list[_Request]) -> None:
        t_start = self._clock()
        live: list[_Request] = []
        for req in batch:
            if req.future.cancelled():
                # The caller gave up while the request was queued.
                REGISTRY.incr("serve/cancelled_requests")
            elif req.deadline is not None and t_start > req.deadline:
                REGISTRY.incr("serve/deadline_rejects")
                log_event(
                    _log, "serve.deadline", trace_id=req.trace_id, rows=len(req.docs),
                    waited_ms=(t_start - req.admitted_at) * 1e3,
                )
                self._complete(req, error=ServeDeadlineExceeded(
                    f"deadline passed after {t_start - req.admitted_at:.3f}s in queue"
                ))
            else:
                live.append(req)
        if not live:
            return
        rows = sum(len(r.docs) for r in live)
        docs = [d for r in live for d in r.docs]
        want_labels = live[0].want_labels
        # One batch = one batch_key, so the lead request's options speak
        # for every coalesced request.
        segment_opts = live[0].segment_opts
        REGISTRY.set_gauge("langdetect_serve_inflight_rows", rows)
        try:
            with self._source.lease() as entry:
                # The lead request's trace id is the dispatch's ambient
                # trace; every request keeps its own id on its result.
                with trace_request(live[0].trace_id), span(
                    "serve/dispatch", rows=rows, requests=len(live),
                    version=entry.version, labels=want_labels,
                    segment=segment_opts is not None,
                ):
                    t0 = time.perf_counter()
                    out = (
                        self._segmented(entry, docs, segment_opts)
                        if segment_opts is not None
                        else self._scored(entry, docs, want_labels)
                    )
                    dispatch_s = time.perf_counter() - t0
        except Exception as e:
            REGISTRY.incr("serve/dispatch_errors")
            log_event(
                _log, "serve.dispatch_error", rows=rows, requests=len(live), error=repr(e),
            )
            for req in live:
                self._complete(req, error=e)
            return
        finally:
            REGISTRY.set_gauge("langdetect_serve_inflight_rows", 0)
        REGISTRY.incr("serve/dispatches")
        REGISTRY.incr("serve/requests", len(live))
        REGISTRY.incr("serve/coalesced_rows", rows)
        REGISTRY.observe("serve/rows_per_dispatch", rows)
        REGISTRY.observe("serve/requests_per_dispatch", len(live))
        REGISTRY.observe("serve/dispatch_s", dispatch_s)
        # Fill against the coalescing bound; a single over-bound request
        # counts as full, never as negative waste.
        capacity = max(self.max_rows, rows)
        fill = rows / capacity if capacity else 1.0
        REGISTRY.observe("serve/fill_ratio", fill)
        REGISTRY.observe("serve/padding_waste", 1.0 - fill)
        REGISTRY.incr("serve/dispatch_capacity_rows", capacity)
        self._queue.record_rate(rows, dispatch_s)
        done = self._clock()
        off = 0
        for req in live:
            # Segment results are per-doc dicts: slice the list; numeric
            # modes keep a contiguous array copy.
            if segment_opts is not None:
                sub = list(out[off:off + len(req.docs)])
            else:
                sub = np.array(out[off:off + len(req.docs)])
            off += len(req.docs)
            queue_wait_s = t_start - req.admitted_at
            REGISTRY.observe("serve/queue_wait_s", queue_wait_s)
            REGISTRY.observe("serve/total_s", done - req.admitted_at)
            self._complete(req, ServeResult(
                values=sub,
                version=entry.version,
                trace_id=req.trace_id,
                queue_wait_s=queue_wait_s,
                dispatch_s=dispatch_s,
                languages=getattr(entry, "languages", None),
                rows_coalesced=rows,
            ))
        log_event(
            _log, "serve.dispatch", rows=rows, requests=len(live),
            version=entry.version, dispatch_s=round(dispatch_s, 6),
            trace_ids=[r.trace_id for r in live],
        )

    # ------------------------------------------------------------ admin -----
    def wake(self) -> None:
        """Re-check the flush window now (after an injected clock moved)."""
        self._queue.wake()

    def stats(self) -> dict:
        """Queue/backpressure snapshot for /healthz, with the resolved
        ``device_encode`` knob the runners inherit."""
        out = self._queue.stats()
        out["device_encode"] = bool(exec_config.resolve("device_encode"))
        return out

    def close(self, drain: bool = True) -> None:
        """Stop admitting; by default drain queued requests first so no
        admitted request is ever dropped. With ``drain=False`` queued
        requests fail with :class:`ServeClosed` (still never a hang)."""
        for req in self._queue.close(drain=drain):
            self._complete(req, error=ServeClosed(f"batcher {self.name!r} closed"))
        self._thread.join(timeout=30.0)
        log_event(_log, "serve.batcher.close", drained=drain)

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
