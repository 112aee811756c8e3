"""Host-side micro-batch planning and pipelining (no device work).

Port of the planning half of ``spark_languagedetector_tpu.exec.core``: the
byte-budget row sizing and the bucket-group / carry micro-batch planner (a
small closed set of padded shapes keeps every batch on a few geometries,
and a bucket's ragged remainder rides up into the next wider bucket so a
call ends with at most one partly filled batch), the in-flight dedup of a
call's work items, and the bounded ordered producer/consumer pipeline under
the device fit's packer.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

from ..ops.encoding import bucket_length


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
