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
  * :func:`ordered_prefetch` — the bounded, ordered one-thread pipeline
    under the fit's packer;
  * :func:`guarded_dispatch` — the breaker-gated fast path + classified retry
    + degraded-ladder hand-off the runner's dispatch rides.

The serving front end's ``AdmissionQueue`` is not ported yet.
"""

from __future__ import annotations

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


def ordered_prefetch(it: Iterable, fn: Callable, depth: int) -> Iterator:
    """Yield ``fn(item)`` for every item of ``it``, in source order,
    computed on one worker thread that runs up to ``depth`` items ahead of
    the one yielded (an exception of ``fn`` raises at its item's turn).

    Closing the generator cancels work not yet started and returns without
    joining a worker that may be stuck: a copy wedged on a dead link must
    not turn a fit abort into a hang.
    """
    from concurrent.futures import ThreadPoolExecutor

    it = iter(it)
    ex = ThreadPoolExecutor(max_workers=1)
    in_flight: deque = deque()
    drained = False
    try:
        while True:
            while len(in_flight) <= depth:
                try:
                    item = next(it)
                except StopIteration:
                    break
                in_flight.append(ex.submit(fn, item))
            if not in_flight:
                drained = True
                return
            yield in_flight.popleft().result()
    finally:
        ex.shutdown(wait=drained, cancel_futures=True)
        # Drop queued futures now: they may hold pinned host buffers the
        # caller expects released when the generator closes.
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
