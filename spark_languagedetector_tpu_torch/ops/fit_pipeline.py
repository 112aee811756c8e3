"""Pipelined ingest for the device fit: plan → pack → copy → count.

Port of ``spark_languagedetector_tpu.ops.fit_pipeline``:

  * :func:`plan_fit_batches` — the deterministic micro-batch plan.
    Documents longer than the largest length bucket are chunk-split onto
    bucketed widths; the windows a split severs are counted on the host and
    added once through the fit's ``extra_counts``, so the split is exactly
    count-preserving. Duplicate (document, language) pairs are counted once
    with an integer multiplicity (``LANGDETECT_DEDUP``, with the ``dedup/*``
    counters). Items are length-sorted and grouped per length bucket with
    rows sized under a byte budget.
  * :func:`iter_device_batches` — one packer thread walks the plan in
    order and packs each batch into pinned host memory in one of three
    forms — padded (``native.pack_batch``), ragged when the chunk-aligned
    flat buffer is smaller than the padded one (``native.pack_ragged``), or
    the raw wire form (``wire_from_docs``) when
    ``LANGDETECT_DEVICE_ENCODE`` asks for it — and starts its
    ``non_blocking`` copy, keeping :data:`FIT_PIPELINE_DEPTH` batches ahead
    of the count step. The consumer rebuilds the padded batch on the device
    (``ops.encoding.unpack_ragged``, ``ops.encode_device.encode_batch``), in
    plan order.
  * :func:`resolve_fit_batching` — an explicit ``batch_rows`` (the
    estimator's ``fitBatchRows``) wins, then ``LANGDETECT_FIT_BATCH_ROWS``,
    else rows adapt per bucket under ``LANGDETECT_FIT_BATCH_BYTES``
    (through ``exec.config``; default :data:`DEFAULT_FIT_BATCH_BYTES`).

Exactness: every form's batch equals :func:`.encoding.pad_batch`'s, chunk
splits plus straddle windows reproduce every window of an oversized
document exactly once, and int32 count accumulation is order-independent,
so the fitted profile is bit-identical to the host fit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import native
from ..exec import config as exec_config
from ..exec.core import (
    dedup_counted,
    ordered_prefetch,
    plan_micro_batches,
    rows_under_byte_budget,
)
from ..exec.staging import HostStaging
from ..telemetry import REGISTRY, span
from .encode_device import encode_batch, wire_capacity, wire_from_docs
from .encoding import RAGGED_CHUNK, bucket_length, ragged_fit, unpack_ragged
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


def resolve_fit_batching(batch_rows: int | None = None) -> tuple[int | None, int]:
    """(fixed_rows | None, byte_budget) for the fit's micro-batch plan: an
    explicit ``batch_rows`` wins, else ``LANGDETECT_FIT_BATCH_ROWS``, else
    None (adaptive); the budget is ``LANGDETECT_FIT_BATCH_BYTES``, else the
    tuning profile's ``fit_batch_bytes``, else the default."""
    budget = int(exec_config.resolve("fit_batch_bytes"))
    if batch_rows is not None:
        if batch_rows <= 0:
            raise ValueError(f"batch_rows must be positive, got {batch_rows}")
        return int(batch_rows), budget
    rows = exec_config.resolve("fit_batch_rows")
    return (None if rows is None else int(rows)), budget


def rows_for_fit_bucket(pad_to: int, byte_budget: int = DEFAULT_FIT_BATCH_BYTES) -> int:
    """Adaptive rows for a padded width (the shared halving policy)."""
    return rows_under_byte_budget(pad_to, byte_budget, DEFAULT_FIT_MAX_ROWS, MIN_FIT_ROWS)


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
    item_mult)``. The rows and byte budget come from
    :func:`resolve_fit_batching`, the bucket lattice and dedup from
    ``LANGDETECT_LENGTH_BUCKETS`` and ``LANGDETECT_DEDUP`` (``exec.config``).

    * ``items`` / ``item_langs``: every document no longer than the largest
      bucket verbatim, oversized ones chunk-split (:func:`split_bounds`),
      each chunk with its document's language;
    * ``plan``: ``[(sel, pad_to), ...]``, row indices into ``items`` and a
      bucketed width; fixed ``batch_rows`` slices the length-sorted order,
      else :func:`plan_micro_batches` groups per bucket with
      :func:`rows_for_fit_bucket` rows under ``byte_budget``;
    * ``straddle``: ``(ids, langs, counts)`` int64 arrays of the windows
      chunk-splitting severed, or None;
    * ``item_mult``: int32 per-item multiplicity of duplicated (document,
      language) pairs, or None when every pair is distinct (or dedup is
      off). Integer counts
      times an integer weight equal the duplicated sum, so the profile is
      unchanged.
    """
    batch_rows, byte_budget = resolve_fit_batching(batch_rows)
    length_buckets = exec_config.resolve("length_buckets")
    dedup = bool(exec_config.resolve("dedup"))
    max_len = length_buckets[-1]
    max_gram = max(spec.gram_lengths)
    lang_arr = np.asarray(lang_indices)
    docs = [d if isinstance(d, bytes) else bytes(d) for d in byte_docs]
    doc_mult = None
    if dedup and len(docs) > 1:
        d = dedup_counted(
            [(doc, int(lang)) for doc, lang in zip(docs, lang_arr)],
            size_of=lambda key: len(key[0]),
        )
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
            rows_for=lambda b: rows_for_fit_bucket(b, byte_budget),
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

    One packer thread (:func:`ordered_prefetch`, one worker, so packs and
    their copies stay in plan order) packs each batch into a pinned staging
    buffer (``exec.staging``; plain memory when ``device`` is the CPU) in
    the padded, ragged or wire form and starts its ``non_blocking`` copy on
    the current stream, the one the count step runs on; up to
    :data:`FIT_PIPELINE_DEPTH` batches run ahead of the consumer. The
    consumer rebuilds ragged and wire batches into the padded form on the
    device. ``mult`` is None when the plan carries no duplicates.
    Closing the generator stops the packer.
    """
    if not plan:
        return
    device = torch.device(device)
    native.available()  # the one-time build, outside the pipelined loop
    device_encode = bool(exec_config.resolve("device_encode"))
    staging = HostStaging(device)
    u8, i32 = np.uint8, np.int32

    def pack_one(planned):
        sel, pad_to = planned
        batch_docs = [items[k] for k in sel]
        rows = len(batch_docs)
        real_bytes = sum(len(d) for d in batch_docs)
        # The planner's chunk-split already bounds every doc <= pad_to, so
        # the wire form's join is the exact content.
        ragged = None if device_encode else ragged_fit(batch_docs, pad_to)
        form = "wire" if device_encode else "padded" if ragged is None else "ragged"
        cols = [("langs", i32, (rows,))]
        if item_mult is not None:
            cols.append(("mult", i32, (rows,)))
        if form == "wire":
            capacity = wire_capacity(real_bytes, rows, pad_to)
            fields = [("wire", u8, (capacity,)), ("starts", i32, (rows,)),
                      ("lengths", i32, (rows,))]
        elif form == "ragged":
            rows_flat, flat_step = ragged
            capacity = rows_flat * RAGGED_CHUNK
            fields = [("flat", u8, (capacity // RAGGED_CHUNK, RAGGED_CHUNK)),
                      ("offs", i32, (rows,)), ("lengths", i32, (rows,))]
        else:
            capacity = rows * pad_to
            fields = [("batch", u8, (rows, pad_to)), ("lengths", i32, (rows,))]
        st = staging.take(fields + cols)
        with st:
            v = st.views
            with span("fit/pack", rows=rows, pad_to=pad_to,
                      **{"wire": True} if form == "wire" else {"ragged": form == "ragged"}):
                if form == "wire":
                    _, starts, lengths = wire_from_docs(batch_docs, capacity, out=v["wire"])
                    v["starts"][:] = starts
                    v["lengths"][:] = lengths
                elif form == "ragged":
                    _, offs, lengths = native.pack_ragged(
                        batch_docs, pad_to, flat_step=flat_step, out=v["flat"]
                    )
                    v["offs"][:] = offs
                    v["lengths"][:] = lengths
                else:
                    native.pack_batch(batch_docs, pad_to, out=v["batch"],
                                      lengths_out=v["lengths"])
                v["langs"][:] = item_langs[sel]
                if item_mult is not None:
                    v["mult"][:] = item_mult[sel]
        if form != "padded":
            REGISTRY.incr(f"fit/{'encoded' if form == 'wire' else 'ragged'}_batches")
        fill = real_bytes / capacity if capacity else 1.0
        REGISTRY.observe("fit/batch_fill_ratio", fill)
        REGISTRY.observe("fit/padding_waste", 1.0 - fill)
        REGISTRY.incr("fit/real_bytes", real_bytes)
        REGISTRY.incr("fit/capacity_bytes", capacity)
        REGISTRY.incr(
            "fit/wire_bytes", sum(a.nbytes for a in v.values()),
        )
        with span("fit/put", rows=rows, pad_to=pad_to) as sp:
            dev = st.to_device()
            sp.fence(*dev.values())
        return form, dev, rows, pad_to

    pipeline = ordered_prefetch(
        plan, pack_one, depth=FIT_PIPELINE_DEPTH, abort_wait=False
    )
    try:
        for _, packed, _, _ in pipeline:
            form, dev, rows, pad_to = packed()
            if form == "wire":
                batch = encode_batch(dev["wire"], dev["starts"], dev["lengths"], pad_to)
            elif form == "ragged":
                batch = unpack_ragged(dev["flat"], dev["offs"], dev["lengths"], pad_to)
            else:
                batch = dev["batch"]
            yield batch, dev["lengths"], dev["langs"], dev.get("mult"), rows, pad_to
    finally:
        pipeline.close()
