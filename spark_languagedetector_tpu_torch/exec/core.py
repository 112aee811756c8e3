"""Host-side micro-batch planning (no device work).

Port of the planning half of ``spark_languagedetector_tpu.exec.core``: the
byte-budget row sizing and the bucket-group / carry micro-batch planner. A
small closed set of padded shapes keeps every batch on a few geometries, and
a bucket's ragged remainder rides up into the next wider bucket so a call
ends with at most one partly filled batch.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

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
