"""Pipelined ingest for the device fit: plan → pack → copy → count.

Port of ``spark_languagedetector_tpu.ops.fit_pipeline``:

  * :func:`plan_fit_batches` — the deterministic micro-batch plan.
    Documents longer than the largest length bucket are chunk-split onto
    bucketed widths; the windows a split severs are counted on the host and
    added once through the fit's ``extra_counts``, so the split is exactly
    count-preserving. Duplicate (document, language) pairs are counted once
    with an integer multiplicity. Items are length-sorted and grouped per
    length bucket with rows sized under a byte budget.
  * :func:`iter_device_batches` — one packer thread walks the plan in
    order, pads each batch into pinned host memory and starts its
    ``non_blocking`` copy to the device, keeping :data:`FIT_PIPELINE_DEPTH`
    batches ahead of the count step that consumes them.

An explicit ``batch_rows`` (the estimator's ``fitBatchRows``) slices the
plan into fixed-row batches; otherwise rows adapt per bucket under
:data:`DEFAULT_FIT_BATCH_BYTES`.

Exactness: the padded batches equal :func:`.encoding.pad_batch`'s, chunk
splits plus straddle windows reproduce every window of an oversized
document exactly once, and int32 count accumulation is order-independent,
so the fitted profile is bit-identical to the host fit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..exec.core import (
    dedup_items,
    ordered_prefetch,
    plan_micro_batches,
    rows_under_byte_budget,
)
from .encoding import DEFAULT_LENGTH_BUCKETS, bucket_length, pad_batch
from .vocab import VocabSpec

# Byte budget for one micro-batch's padded copy, the JAX package's default:
# rows halve from the cap until the padded bytes fit, so the (rows, pad_to)
# set stays a small fixed lattice.
DEFAULT_FIT_BATCH_BYTES = 8 << 20
DEFAULT_FIT_MAX_ROWS = 4096
MIN_FIT_ROWS = 64

# Packed-and-copying batches the packer keeps queued ahead of the count
# step: one packing and one in transfer while the step consumes a third.
FIT_PIPELINE_DEPTH = 2


def rows_for_fit_bucket(pad_to: int) -> int:
    """Adaptive rows for a padded width (the shared halving policy)."""
    return rows_under_byte_budget(
        pad_to, DEFAULT_FIT_BATCH_BYTES, DEFAULT_FIT_MAX_ROWS, MIN_FIT_ROWS
    )


def split_bounds(doc_len: int, max_len: int, min_tail: int) -> list[int]:
    """Split positions for one oversized document: chunks of ``max_len``
    with the last boundary pulled back so the tail chunk keeps at least
    ``min_tail`` bytes (the max gram length: a shorter tail would take the
    partial-window rule the whole document never takes)."""
    if doc_len <= max_len:
        return []
    bounds = list(range(max_len, doc_len, max_len))
    if doc_len - bounds[-1] < min_tail:
        bounds[-1] = doc_len - min_tail
    return bounds


def plan_fit_batches(
    byte_docs: Sequence[bytes],
    lang_indices,
    spec: VocabSpec,
    *,
    batch_rows: int | None = None,
):
    """Deterministic micro-batch plan: ``(items, item_langs, plan, straddle,
    item_mult)``.

    * ``items`` / ``item_langs``: every document no longer than the largest
      bucket verbatim, oversized ones chunk-split (:func:`split_bounds`),
      each chunk with its document's language;
    * ``plan``: ``[(sel, pad_to), ...]``, row indices into ``items`` and a
      bucketed width; fixed ``batch_rows`` slices the length-sorted order,
      else :func:`plan_micro_batches` groups per bucket;
    * ``straddle``: ``(ids, langs, counts)`` int64 arrays of the windows
      chunk-splitting severed, or None;
    * ``item_mult``: int32 per-item multiplicity of duplicated (document,
      language) pairs, or None when every pair is distinct. Integer counts
      times an integer weight equal the duplicated sum, so the profile is
      unchanged.
    """
    length_buckets = DEFAULT_LENGTH_BUCKETS
    max_len = length_buckets[-1]
    max_gram = max(spec.gram_lengths)
    lang_arr = np.asarray(lang_indices)
    docs = [d if isinstance(d, bytes) else bytes(d) for d in byte_docs]
    doc_mult = None
    if len(docs) > 1:
        d = dedup_items([(doc, int(lang)) for doc, lang in zip(docs, lang_arr)])
        if d is not None:
            first_idx, _, doc_mult = d
            docs = [docs[int(i)] for i in first_idx]
            lang_arr = lang_arr[first_idx]
    items: list[bytes] = []
    item_langs: list[int] = []
    item_mult: list[int] = []
    corr: dict[tuple[int, int], int] = {}
    for j, (doc, lang) in enumerate(zip(docs, lang_arr)):
        lang = int(lang)
        m = 1 if doc_mult is None else int(doc_mult[j])
        if len(doc) <= max_len:
            items.append(doc)
            item_langs.append(lang)
            item_mult.append(m)
            continue
        prev = 0
        for p in split_bounds(len(doc), max_len, max_gram):
            items.append(doc[prev:p])
            item_langs.append(lang)
            item_mult.append(m)
            prev = p
            # Windows starting in (p-n, p) lie in no chunk: count them here
            # (times the multiplicity). n = 1 windows never straddle.
            for n in spec.gram_lengths:
                for s in range(p - n + 1, p):
                    key = (spec.gram_to_id(doc[s : s + n]), lang)
                    corr[key] = corr.get(key, 0) + m
        items.append(doc[prev:])
        item_langs.append(lang)
        item_mult.append(m)

    langs_np = np.asarray(item_langs, dtype=np.int32)
    mult_np = None if doc_mult is None else np.asarray(item_mult, dtype=np.int32)
    order = np.argsort([len(d) for d in items], kind="stable")
    if batch_rows is not None:
        plan = []
        for start in range(0, len(order), batch_rows):
            sel = order[start : start + batch_rows]
            longest = max((len(items[i]) for i in sel), default=1)
            plan.append(
                (np.asarray(sel), bucket_length(max(longest, 1), length_buckets))
            )
    else:
        plan = plan_micro_batches(
            [len(d) for d in items],
            length_buckets=length_buckets,
            rows_for=rows_for_fit_bucket,
            order=order,
        )
    straddle = None
    if corr:
        e = np.asarray(
            [(i, l, c) for (i, l), c in sorted(corr.items())], dtype=np.int64
        )
        straddle = (e[:, 0], e[:, 1], e[:, 2])
    return items, langs_np, plan, straddle, mult_np


def iter_device_batches(
    items: Sequence[bytes],
    item_langs: np.ndarray,
    plan,
    *,
    item_mult: np.ndarray | None = None,
    device: torch.device,
):
    """Yield ``(batch, lengths, lang_ids, mult, rows, pad_to)`` tensors on
    ``device`` for every planned micro-batch, packing and copying ahead.

    One packer thread (:func:`ordered_prefetch`, one worker, so packs stay
    in plan order) pads each batch with :func:`pad_batch` into pinned host
    memory when ``device`` is a CUDA device and starts ``non_blocking``
    copies on the default stream, the one the count step runs on, so the
    step sees the finished copy; up to :data:`FIT_PIPELINE_DEPTH` batches
    run ahead of the consumer. ``mult`` is None when the plan carries no duplicates.
    Closing the generator stops the packer.
    """
    if not plan:
        return
    pinned = device.type == "cuda"

    def pack_one(planned):
        sel, pad_to = planned
        rows = len(sel)
        batch = torch.empty((rows, pad_to), dtype=torch.uint8, pin_memory=pinned)
        _, lengths = pad_batch([items[k] for k in sel], pad_to, out=batch.numpy())
        cols = [batch, torch.from_numpy(lengths), torch.from_numpy(item_langs[sel])]
        if item_mult is not None:
            cols.append(torch.from_numpy(item_mult[sel]))
        if pinned:
            cols[1:] = [c.pin_memory() for c in cols[1:]]
        dev = [c.to(device, non_blocking=True) for c in cols]
        if item_mult is None:
            dev.append(None)
        return (*dev, rows, pad_to)

    pipeline = ordered_prefetch(plan, pack_one, FIT_PIPELINE_DEPTH)
    try:
        yield from pipeline
    finally:
        pipeline.close()
