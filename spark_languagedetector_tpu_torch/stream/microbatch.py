"""Streaming micro-batch scoring loop.

Port of ``spark_languagedetector_tpu.stream.microbatch``: the same sources,
engine, counters and span names (``stream``, ``stream/transform``,
``stream/batch``, ``sink``, ``quarantine``; ``stream/retries``,
``stream/queue_depth``, ``stream/prefetch_stall_s``,
``resilience/quarantined_batches``), so one fault plan gives the same sunk
rows and the same dead-letter records in both packages.

The JAX package's bench config 4 is "Structured Streaming micro-batch langid
over a Kafka text source". The reference has no streaming code of its own —
Spark Structured Streaming would drive its Transformer per micro-batch. The
equivalent here is an explicit loop: a pluggable source yields batches of
rows, the model's runner labels them on the model's device (the CUDA
kernels on the card), a sink consumes the annotated rows, and per-batch and
lifetime metrics are tracked.

Sources are any ``Iterable[Table]``; adapters below wrap an in-memory list
and a Kafka consumer (gated on ``kafka-python`` being importable — it
degrades to a clear error, the way Spark requires the kafka connector JAR).

Failure handling supplies the durability Structured Streaming provided:

  * transient transform failures replay under a :class:`RetryPolicy`
    (classified — deterministic errors are never futilely replayed, and
    ``KeyboardInterrupt``/``SystemExit`` are never swallowed);
  * with a ``checkpoint_path``, every sunk batch commits a resume token
    (atomic JSON via :mod:`..persist.checkpoint`); a restarted run
    fast-forwards the source past committed batches and re-emits nothing;
  * with a ``dlq``, a batch that fails with a deterministic
    ``ValueError``-class error (a row that cannot be encoded) is bisected
    to the poison rows — healthy rows are scored and sunk in order, the
    poison rows are quarantined with full context — instead of killing the
    query. Nothing else is quarantined: a kernel that fails to build or
    launch, or a CUDA error, is not retryable (the port's classifier) and
    not poison, so it propagates out of :func:`run_stream`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from itertools import islice
from typing import Callable, Iterable, Iterator, Sequence

from ..api.table import Table
from ..exec import config as exec_config
from ..exec.core import ordered_prefetch
from ..resilience import faults
from ..resilience.dlq import DeadLetterQueue
from ..resilience.policy import CircuitBreaker, RetryPolicy
from ..telemetry import REGISTRY, flightrec, new_trace_id, span, trace_request
from ..utils.logging import get_logger, log_event
from ..utils.metrics import Metrics

_log = get_logger("stream.microbatch")


# ------------------------------------------------------------- sources ------
def memory_source(rows: Sequence[dict], batch_rows: int) -> Iterator[Table]:
    """Replay an in-memory row list as micro-batches (columns = dict keys)."""
    for start in range(0, len(rows), batch_rows):
        yield Table.from_rows(rows[start : start + batch_rows])


def kafka_source(
    topic: str,
    batch_rows: int,
    input_col: str = "fulltext",
    poll_timeout_s: float = 1.0,
    **consumer_kwargs,
) -> Iterator[Table]:
    """Kafka topic → micro-batches of single-column tables.

    Requires a Kafka client library; raises a clear error when absent
    (mirrors Spark's requirement of the kafka-sql connector package).
    """
    try:
        from kafka import KafkaConsumer  # type: ignore[import-not-found]
    except ImportError as e:
        raise RuntimeError(
            "kafka_source requires the 'kafka-python' package; install it or "
            "use memory_source/your own Iterable[Table]"
        ) from e

    # The loop below runs in the tests against a stubbed consumer; only a
    # live broker needs the real dependency.
    consumer = KafkaConsumer(topic, **consumer_kwargs)
    buf: list[str] = []
    while True:
        records = consumer.poll(timeout_ms=int(poll_timeout_s * 1000))
        for batch in records.values():
            for rec in batch:
                buf.append(
                    rec.value.decode("utf-8", errors="replace")
                    if isinstance(rec.value, bytes)
                    else str(rec.value)
                )
                if len(buf) >= batch_rows:
                    yield Table({input_col: buf})
                    buf = []
        if buf:
            yield Table({input_col: buf})
            buf = []


# --------------------------------------------------------------- engine -----
@dataclass
class StreamingQuery:
    """Progress handle for a running (or finished) micro-batch loop."""

    metrics: Metrics = field(default_factory=Metrics)
    batches: int = 0
    rows: int = 0
    last_batch_rows: int = 0
    last_batch_seconds: float = 0.0
    # Request id of the batch the three last_batch_* fields describe —
    # lets an on_progress hook tie a slow batch back to its spans in the
    # JSONL capture (bench records the slowest one per config).
    last_batch_trace_id: str | None = None
    # Resilience accounting: source batches skipped because a checkpoint
    # said they were already committed; batches routed through the
    # quarantine/bisect path; rows this run handed to the DLQ.
    resumed_from: int = 0
    quarantined_batches: int = 0
    dlq_rows: int = 0

    @property
    def rows_per_second(self) -> float:
        return self.metrics.throughput("rows", "total_s")


def _poison_shaped(policy: RetryPolicy, error: BaseException) -> bool:
    """Whether a failed transform may be bisected into the DLQ: only a
    deterministic ``ValueError``-class error (a poison row) qualifies. A
    kernel build or launch failure and a CUDA error are ``RuntimeError``s,
    so they propagate, never quarantined as data."""
    return isinstance(error, ValueError) and not policy.classify(error)


def _slice_table(table: Table, lo: int, hi: int) -> Table:
    return Table(
        {n: table.column(n)[lo:hi] for n in table.schema.names}, table.schema
    )


def run_stream(
    model,
    source: Iterable[Table],
    sink: Callable[[Table], None],
    *,
    max_batches: int | None = None,
    on_progress: Callable[[StreamingQuery], None] | None = None,
    prefetch: int | None = None,
    workers: int | None = None,
    retry_policy: RetryPolicy | None = None,
    breaker: CircuitBreaker | None = None,
    dlq: DeadLetterQueue | None = None,
    checkpoint_path: str | None = None,
) -> StreamingQuery:
    """Drive the micro-batch loop: for each source batch, transform on the
    model's device and hand the annotated table to the sink.

    Scoring is stateless, so failure recovery is replay: a batch whose
    transform raises a *retryable* error (``resilience.policy.is_retryable``
    — runtime errors such as an injected fault, host I/O) is re-submitted
    under ``retry_policy`` (default: the env-tuned
    ``RetryPolicy.from_env()``, replay-once with backoff) before any
    further handling. Deterministic errors (a bad column's ``ValueError``,
    a poison row, a kernel that failed to build or launch) are never
    replayed: with a ``dlq`` a ``ValueError``-class one takes the
    quarantine path below; without one, or for any other error, they
    propagate at once. ``KeyboardInterrupt``/``SystemExit`` are never
    swallowed anywhere in the loop.

    ``dlq``: a batch that still fails with a poison-shaped error
    (:func:`_poison_shaped`) after classification/retries is bisected —
    halves that transform cleanly are sunk (in source order; the sink may
    therefore see several sub-batches for one source batch), rows that
    fail alone are quarantined with their batch/row index and error. The
    query keeps running; ``query.dlq_rows`` counts the damage.

    ``checkpoint_path``: after each batch is fully sunk (or settled via
    the DLQ), a resume token ``{"committed": seq + 1}`` is atomically
    persisted. A later ``run_stream`` with the same path fast-forwards
    the (replayed-from-the-start) source past the committed batches, so a
    mid-stream kill re-emits nothing already sunk. The commit happens
    *after* the sink returns: a batch whose sink raised replays on
    resume — at-least-once for the crashing batch, exactly-once for
    everything committed.

    ``breaker``: optional health monitor — per-batch transform outcomes
    are recorded on it (the degraded-mode *gating* lives in the model
    runner's own breaker).

    ``prefetch > 0`` overlaps batch N+1's transform with batch N's result
    fetch and sink via the execution core's ordered pipeline
    (``exec.core.ordered_prefetch`` — the same machinery under the fit's
    packer); sinks always run in the caller's thread, in source order.
    ``prefetch``/``workers`` left ``None`` resolve through ``exec.config``
    (env ``LANGDETECT_STREAM_PREFETCH`` / ``LANGDETECT_STREAM_WORKERS``;
    defaults 0 and ``min(2, prefetch)``). ``workers`` is the transform
    concurrency: with one worker, transforms serialize — batch N+1's
    packing and host-to-device copy cannot start until batch N's result
    fetch returns. More workers share the model's runner (its pinned
    staging ring hands a buffer out again only after its copy's event has
    completed); batches stay independent, so results are unchanged.
    Caveat: with a *consuming* source (e.g. Kafka with auto-commit), an
    error that terminates the loop can discard up to ``prefetch`` batches
    that were already pulled from the source but not yet sunk — use the
    default ``prefetch=0`` when the source cannot replay.
    """
    query = StreamingQuery()
    it = iter(source)
    policy = retry_policy if retry_policy is not None else RetryPolicy.from_env()
    input_col = getattr(model, "get_input_col", lambda: None)()
    prefetch = int(exec_config.resolve("stream_prefetch", prefetch))
    if workers is None:
        workers = exec_config.resolve("stream_workers")

    # Resume: fast-forward past batches a previous run already committed.
    committed = 0
    if checkpoint_path is not None:
        from ..persist.checkpoint import load_checkpoint

        state = load_checkpoint(checkpoint_path) or {}
        committed = max(0, int(state.get("committed", 0)))
        skipped = 0
        while skipped < committed:
            try:
                next(it)
            except StopIteration:
                break
            skipped += 1
        query.resumed_from = skipped
        if skipped:
            log_event(_log, "stream.resume", committed=skipped)

    def transform_once(batch: Table, seq: int, trace_id: str) -> Table:
        # Runs on a prefetch worker thread when the pipeline is deep: the
        # explicit parent pins the span under this run's "stream" root (a
        # fresh thread has no ambient span to inherit), so concurrent
        # workers all aggregate under stream/transform. The per-batch
        # trace id (minted when the batch was pulled) is rebound here so
        # the nested runner score spans attribute to this batch's request
        # rather than the stream root.
        def attempt():
            faults.inject("stream/batch")
            return model.transform(batch)

        def on_retry(attempt_no, delay_s, exc):
            # May run on the worker thread concurrently with the caller's
            # counter writes — Metrics serializes internally.
            query.metrics.incr("retries")
            REGISTRY.incr("stream/retries")
            log_event(
                _log, "stream.retry", batch=seq, attempt=attempt_no,
                backoff_s=round(delay_s, 6), trace_id=trace_id,
                error=repr(exc),
            )

        with trace_request(trace_id), span(
            "stream/transform", parent=stream_span, batch=seq,
            rows=batch.num_rows,
        ):
            return policy.run(
                attempt,
                site="stream/batch",
                breaker=breaker,
                on_retry=on_retry,
            )

    def settle(tbl: Table, seq: int, base: int, error: BaseException) -> None:
        """Bisect a deterministically-failing batch: sink the rows that
        score cleanly (in order), quarantine the rows that fail alone.
        Probes call ``model.transform`` directly (under the retry policy
        for stray transients) — deliberately bypassing the ``stream/batch``
        chaos site, so an injected transient cannot masquerade as poison
        during isolation. Only *deterministic* failures recurse toward the
        DLQ: a retryable error that exhausts the policy mid-bisection is
        an outage, not poison — it propagates (crashing the batch; its
        commit never happens, so a resume replays it whole) instead of
        quarantining healthy rows."""
        if not _poison_shaped(policy, error):
            raise error
        if tbl.num_rows <= 1:
            for i, row in enumerate(tbl.to_rows()):
                dlq.put(
                    batch=seq, row_index=base + i, row=row, error=repr(error)
                )
                query.dlq_rows += 1
                query.metrics.incr("dlq_rows")
            return
        mid = tbl.num_rows // 2
        for lo, hi in ((0, mid), (mid, tbl.num_rows)):
            sub = _slice_table(tbl, lo, hi)
            try:
                out = policy.run(
                    lambda sub=sub: model.transform(sub),
                    site="stream/bisect",
                )
            except Exception as sub_error:
                settle(sub, seq, base + lo, sub_error)
            else:
                with span("sink", rows=sub.num_rows):
                    sink(out)

    def quarantine(tbl: Table, seq: int, trace_id: str,
                   error: BaseException) -> None:
        query.quarantined_batches += 1
        query.metrics.incr("quarantined_batches")
        REGISTRY.incr("resilience/quarantined_batches")
        log_event(
            _log, "stream.quarantine", batch=seq, rows=tbl.num_rows,
            error=repr(error), trace_id=trace_id,
        )
        with span("quarantine", batch=seq, rows=tbl.num_rows):
            settle(tbl, seq, 0, error)  # nests as stream/batch/quarantine

    n_workers = workers if workers is not None else min(2, max(prefetch, 1))
    seq_box = [committed]

    def pulled() -> Iterator[tuple[Table, int, str]]:
        """Source batches with the per-pull work stamped at pull time:
        chaos row corruption (deterministic per batch count), the batch's
        trace id, and its sequence number. The execution core's pipeline
        pulls from this lazily — at most ``prefetch + 1`` ahead of the
        drain — so a consuming source (Kafka auto-commit) never loses
        more than the pipeline depth on a crash."""
        while True:
            try:
                batch = next(it)
            except StopIteration:
                return
            batch, _ = faults.corrupt_batch(batch, input_col)
            tid = new_trace_id()
            s = seq_box[0]
            seq_box[0] += 1
            yield batch, s, tid

    # Budget BEFORE pulling: total pulls (drained + in flight) never
    # exceed max_batches, so an over-pulled batch is never silently lost.
    src_iter: Iterable = pulled()
    if max_batches is not None:
        src_iter = islice(src_iter, max(0, max_batches))
    pipeline = None
    try:
        with span(
            "stream", prefetch=prefetch, workers=n_workers
        ) as stream_span:
            # The shared ordered pipeline (exec.core): transforms run on
            # worker threads up to ``prefetch`` batches ahead, results
            # drain in source order; prefetch=0 keeps the synchronous
            # semantics (the thunk transforms inline, in this thread).
            pipeline = ordered_prefetch(
                src_iter,
                lambda item: transform_once(*item),
                depth=prefetch,
                workers=n_workers,
            )
            for (src, src_seq, src_tid), thunk, prefetched, pending in pipeline:
                REGISTRY.observe("stream/queue_depth", pending)
                REGISTRY.set_gauge("stream/queue_depth", pending)
                t0 = time.perf_counter()
                # The timer covers processing (transform-or-wait + sink)
                # only, never idle source polling, matching the synchronous
                # loop's throughput semantics.
                with trace_request(src_tid), query.metrics.timer(
                    "total_s"
                ), span(
                    "stream/batch", batch=src_seq, rows=src.num_rows
                ):
                    try:
                        if not prefetched:
                            out = thunk()
                        else:
                            # Sink-visible stall: how long the drain sat
                            # waiting on the prefetch worker — the signal
                            # separating "wire is behind" from "sink is
                            # behind" when stream throughput drops.
                            t_wait = time.perf_counter()
                            out = thunk()
                            REGISTRY.observe(
                                "stream/prefetch_stall_s",
                                time.perf_counter() - t_wait,
                            )
                    except Exception as e:
                        # Retryable errors already exhausted the policy
                        # inside transform_once; what reaches here is
                        # either poison-shaped (→ quarantine when a DLQ
                        # is wired) or a device or kernel failure (→
                        # propagate: quarantining healthy data during an
                        # outage would turn downtime into data loss).
                        if dlq is None or not _poison_shaped(policy, e):
                            raise
                        quarantine(src, src_seq, src_tid, e)
                    else:
                        with span("sink", rows=src.num_rows):
                            sink(out)  # nests as stream/batch/sink
                dt = time.perf_counter() - t0
                query.batches += 1
                query.rows += src.num_rows
                query.last_batch_rows = src.num_rows
                query.last_batch_seconds = dt
                query.last_batch_trace_id = src_tid
                query.metrics.incr("rows", src.num_rows)
                query.metrics.incr("batches")
                if checkpoint_path is not None:
                    # Commit AFTER the sink (or quarantine) settled the
                    # batch: the resume token only ever names batches
                    # whose effects are fully externalized.
                    from ..persist.checkpoint import save_checkpoint

                    save_checkpoint(
                        checkpoint_path,
                        {
                            "committed": src_seq + 1,
                            "rows": query.rows,
                            "dlq_rows": query.dlq_rows,
                        },
                    )
                if on_progress is not None:
                    on_progress(query)
                log_event(
                    _log,
                    "stream.batch",
                    n=query.batches,
                    rows=src.num_rows,
                    seconds=dt,
                    trace_id=src_tid,
                )
    except Exception as e:
        # Post-mortem: dump the flight-recorder ring (when armed) before
        # the loop unwinds — a consuming source may make this failure
        # unreplayable, so the recent-batch timeline is all there is.
        flightrec.record_crash("stream", e)
        raise
    finally:
        if pipeline is not None:
            # Don't wait for transforms of batches this run will never
            # sink; closing the pipeline cancels them and joins the pool.
            pipeline.close()
    return query
