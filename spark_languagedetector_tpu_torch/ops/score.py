"""Batch scoring by row gather: padded byte batches → per-language scores.

Port of the gather half of ``spark_languagedetector_tpu.ops.score``: the
explicit ``strategy="gather"`` of the runner and the tests' reference.

* dense (``lut`` None): the weight table covers the whole id space and
  window ids index it directly;
* LUT (``lut`` int32 ``[V]``): ids map to rows of a compact ``[G+1, L]``
  table whose row G is the zeros miss row.

Semantics: unknown grams contribute zero; an all-miss document scores all
zeros and its argmax is index 0; ties go to the lowest index; a document
shorter than a gram length contributes one partial window per such length
(Scala ``sliding``). The window axis is summed in blocks so the gathered
``[B, block, L]`` slab stays bounded whatever the document length.
"""

from __future__ import annotations

import numpy as np
import torch

from .vocab import VocabSpec, partial_window_ids, short_doc_ids_numpy, window_ids, window_ids_numpy

# Window-axis block of the gather sum.
DEFAULT_BLOCK = 1024


def _partial_window_rows(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    n: int,
    window0_ids: torch.Tensor,
    spec: VocabSpec,
    lut: torch.Tensor | None,
    miss_row: int,
) -> torch.Tensor:
    """Row indices for the single partial window of docs with len < n.
    Docs with len == 0 get the miss row (``sliding`` over an empty
    collection emits nothing)."""
    short_ids = partial_window_ids(batch, lengths, n, window0_ids, spec)
    rows = short_ids if lut is None else lut[short_ids].long()
    return torch.where(lengths > 0, rows, miss_row)


def _splice_partial_windows(
    rows: torch.Tensor,
    partial_rows: torch.Tensor,
    lengths: torch.Tensor,
    n: int,
    window_limit: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Window mask + Scala-``sliding`` partial-window splice.

    Full windows are those with start ≤ len - n (and start < window_limit
    when chunk ownership applies); a doc shorter than n contributes its
    single partial window in column 0 regardless of the limit. Returns new
    (rows, mask); the inputs are not modified.
    """
    B, W = rows.shape
    starts = torch.arange(W, device=rows.device)[None, :]
    lengths = lengths.long()
    mask = starts <= (lengths[:, None] - n)
    if window_limit is not None:
        mask = mask & (starts < window_limit.long()[:, None])
    is_short = lengths < n
    rows = rows.clone()
    rows[:, 0] = torch.where(is_short, partial_rows, rows[:, 0])
    mask[:, 0] = mask[:, 0] | (is_short & (lengths > 0))
    return rows, mask


def _block_accumulate(
    weights: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, block: int
) -> torch.Tensor:
    """Σ_w weights[rows[b, w]] · mask[b, w] → f32 [B, L], in window blocks."""
    B, W = rows.shape
    acc = torch.zeros((B, weights.shape[1]), dtype=torch.float32, device=rows.device)
    for s in range(0, W, block):
        r = rows[:, s : s + block]
        m = mask[:, s : s + block]
        acc += (weights[r] * m[..., None].to(weights.dtype)).sum(dim=1).float()
    return acc


def score_batch(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    weights: torch.Tensor,
    lut: torch.Tensor | None,
    *,
    spec: VocabSpec,
    block: int = DEFAULT_BLOCK,
    window_limit: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scores for a padded batch (gather strategy).

    Args:
      batch: uint8 [B, S] zero-padded document bytes.
      lengths: int [B] true byte lengths (≤ S).
      weights: float [V, L] dense over the id space (``lut`` None) or
        [G+1, L] compact with a zeros miss row at G (``lut`` given).
      lut: optional int32 [V] id→row table; unlearned ids map to row G.
      window_limit: optional int [B] — row i only counts window starts
        < window_limit[i] (long-document chunk ownership). None ⇒ no limit.

    Returns float32 [B, L].
    """
    B = batch.shape[0]
    miss_row = weights.shape[0] - 1 if lut is not None else 0
    total = torch.zeros(
        (B, weights.shape[1]), dtype=torch.float32, device=batch.device
    )
    for n in spec.gram_lengths:
        ids = window_ids(batch, n, spec)  # [B, W]
        rows = ids if lut is None else lut[ids].long()
        partial_rows = _partial_window_rows(
            batch, lengths, n, ids[:, 0], spec, lut, miss_row
        )
        rows, mask = _splice_partial_windows(
            rows, partial_rows, lengths, n, window_limit
        )
        total += _block_accumulate(weights, rows, mask, block)
    return total


def argmax_language(scores: torch.Tensor) -> torch.Tensor:
    """[B, L] → int32 [B]; first maximum wins (reference tie/zero behavior)."""
    return torch.argmax(scores, dim=1).to(torch.int32)


def score_batch_numpy(
    byte_docs: list[bytes],
    weights: np.ndarray,
    sorted_ids: np.ndarray | None,
    spec: VocabSpec,
) -> np.ndarray:
    """Host scorer with identical semantics in float64 (no padding): the
    bridge to the pure-Python oracle. ``weights``/``sorted_ids`` are the
    profile arrays (``GramProfile.host_arrays``): compact [G+1, L] + ascending
    ids (binary-search membership), or the dense table + None.
    """
    L = weights.shape[1]
    out = np.zeros((len(byte_docs), L), dtype=np.float64)
    for i, doc in enumerate(byte_docs):
        arr = np.frombuffer(doc, dtype=np.uint8)[None, :]
        ids_all = []
        for n in spec.gram_lengths:
            if len(doc) >= n:
                ids_all.append(window_ids_numpy(arr, n, spec)[0])
        short = short_doc_ids_numpy(doc, spec)
        if short:
            ids_all.append(np.asarray(short, dtype=np.int64))
        if not ids_all:
            continue
        ids = np.concatenate(ids_all)
        if sorted_ids is None:
            out[i] = weights[ids].sum(axis=0)
            continue
        if len(sorted_ids) == 0:
            rows = np.full(len(ids), weights.shape[0] - 1)
        else:
            pos = np.searchsorted(sorted_ids, ids)
            pos_c = np.minimum(pos, len(sorted_ids) - 1)
            hit = sorted_ids[pos_c] == ids
            rows = np.where(hit, pos_c, weights.shape[0] - 1)
        out[i] = weights[rows].sum(axis=0)
    return out
