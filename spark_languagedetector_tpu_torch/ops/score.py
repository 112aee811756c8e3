"""Batch scoring by row gather: padded byte batches → per-language scores.

Port of the gather half of ``spark_languagedetector_tpu.ops.score``: the
explicit ``strategy="gather"`` of the runner and the tests' reference, for
whole documents (``score_batch*``) and per cell (``window_scores_batch*``,
segment mode's exactness oracle and the route of every non-fused strategy).

* dense (``lut`` None): the weight table covers the whole id space and
  window ids index it directly;
* LUT (``lut`` int32 ``[V]``): ids map to rows of a compact ``[G+1, L]``
  table whose row G is the zeros miss row;
* cuckoo (:func:`score_batch_cuckoo`): exact gram lengths 4..5 overflow
  int32 ids, so windows become packed ``(lo, hi)`` keys resolved by two
  verified probes of the cuckoo table (``ops.cuckoo``).

Semantics: unknown grams contribute zero; an all-miss document scores all
zeros and its argmax is index 0; ties go to the lowest index; a document
shorter than a gram length contributes one partial window per such length
(Scala ``sliding``). The window axis is summed in blocks so the gathered
``[B, block, L]`` slab stays bounded whatever the document length.
"""

from __future__ import annotations

import numpy as np
import torch

from .vocab import (
    EXACT,
    VocabSpec,
    mix32_torch,
    partial_window_ids,
    partial_window_keys,
    short_doc_ids_numpy,
    window_ids,
    window_ids_numpy,
    window_keys,
)

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
    gram_lengths_subset: tuple[int, ...] | None = None,
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
      gram_lengths_subset: optional subset of ``spec.gram_lengths`` to score
        (the hybrid strategy scores its long lengths here).

    Returns float32 [B, L].
    """
    B = batch.shape[0]
    miss_row = weights.shape[0] - 1 if lut is not None else 0
    total = torch.zeros(
        (B, weights.shape[1]), dtype=torch.float32, device=batch.device
    )
    for n in spec.gram_lengths if gram_lengths_subset is None else gram_lengths_subset:
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


def _cuckoo_rows(
    lo: torch.Tensor,
    hi: torch.Tensor,
    entries: torch.Tensor,
    miss_row: int,
    seed1: int,
    seed2: int,
) -> torch.Tensor:
    """Two-probe verified lookup: packed keys → compact weight rows (int64),
    or the miss row G. ``entries`` is the int32 [M, 4] table
    (``CuckooTable.entries``); M is a power of two, so ``% M`` is a mask."""
    M = entries.shape[0]
    e1 = entries[mix32_torch(lo, hi, seed1) & (M - 1)]
    e2 = entries[mix32_torch(lo, hi, seed2) & (M - 1)]
    hit1 = (e1[..., 0] == lo) & (e1[..., 1] == hi)
    hit2 = (e2[..., 0] == lo) & (e2[..., 1] == hi)
    return torch.where(
        hit1, e1[..., 2], torch.where(hit2, e2[..., 2], miss_row)
    ).long()


def score_batch_cuckoo(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    weights: torch.Tensor,
    entries: torch.Tensor,
    *,
    seed1: int,
    seed2: int,
    spec: VocabSpec,
    block: int = DEFAULT_BLOCK,
    window_limit: torch.Tensor | None = None,
    gram_lengths_subset: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Scores via cuckoo membership (exact vocabs with gram lengths 4..5).

    Same contract as :func:`score_batch` (masking, partial-window rule,
    ``window_limit``, subset); membership is resolved by packed-key lookups
    into ``entries`` instead of integer ids. ``weights`` is the compact
    [G+1, L] table with the zeros miss row at G.
    """
    if spec.mode != EXACT:
        raise ValueError(
            "score_batch_cuckoo needs an exact vocab spec — hashed specs "
            "use integer-id scoring (score_batch), not packed-key membership"
        )
    B = batch.shape[0]
    G = weights.shape[0] - 1
    total = torch.zeros(
        (B, weights.shape[1]), dtype=torch.float32, device=batch.device
    )
    for n in spec.gram_lengths if gram_lengths_subset is None else gram_lengths_subset:
        lo, hi = window_keys(batch, n)
        rows = _cuckoo_rows(lo, hi, entries, G, seed1, seed2)
        plo, phi = partial_window_keys(batch, lengths, n)
        prows = _cuckoo_rows(plo, phi, entries, G, seed1, seed2)
        prows = torch.where(lengths > 0, prows, G)
        rows, mask = _splice_partial_windows(rows, prows, lengths, n, window_limit)
        total += _block_accumulate(weights, rows, mask, block)
    return total


# ------------------------------------------- per-window (cell) scoring ------
#
# Segment mode: instead of folding every window's contribution into one
# [B, L] document score, contributions are kept per CELL, a fixed span of
# ``cell`` consecutive window start positions. A window starting at byte s
# belongs to cell s // cell whatever its gram length, so the per-cell tensors
# of all lengths align and sum. Summing a document's cells restores the
# whole-doc score up to f32 reduction order.


def _cell_accumulate(
    weights: torch.Tensor,
    rows: torch.Tensor,
    mask: torch.Tensor,
    cell: int,
    n_cells: int,
    block: int,
) -> torch.Tensor:
    """Σ_w weights[rows[b, w]] · mask[b, w] by window cell → f32
    [B, n_cells, L], in window blocks (the block rounded to a whole number
    of cells, so no block straddles a cell boundary)."""
    B, W = rows.shape
    L = weights.shape[1]
    blk = max(cell, (block // cell) * cell)
    full = n_cells * cell
    if full > W:
        rows = torch.nn.functional.pad(rows, (0, full - W))
        mask = torch.nn.functional.pad(mask, (0, full - W))
    acc = torch.zeros((B, n_cells, L), dtype=torch.float32, device=rows.device)
    for s in range(0, full, blk):
        r = rows[:, s : s + blk]
        m = mask[:, s : s + blk]
        contrib = weights[r] * m[..., None].to(weights.dtype)
        c0 = s // cell
        acc[:, c0 : c0 + r.shape[1] // cell] += (
            contrib.reshape(B, -1, cell, L).sum(dim=2).float()
        )
    return acc


def window_scores_batch(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    weights: torch.Tensor,
    lut: torch.Tensor | None,
    *,
    spec: VocabSpec,
    cell: int,
    block: int = DEFAULT_BLOCK,
    window_limit: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-cell scores for a padded batch (gather strategies): float32
    [B, ceil(S / cell), L] where entry ``[b, c]`` sums every window of every
    gram length whose start position lies in ``[c·cell, (c+1)·cell)``.
    Masking, the partial-window splice into window 0 and ``window_limit``
    chunk ownership are exactly those of :func:`score_batch`; the partial
    window of a short document lands in cell 0. The gather formulation is
    segment mode's exactness oracle and the route of every non-fused
    strategy."""
    if lut is not None and lut.numel() == 0:
        lut = None
    B, S = batch.shape
    n_cells = -(-S // cell)
    miss_row = weights.shape[0] - 1 if lut is not None else 0
    total = torch.zeros(
        (B, n_cells, weights.shape[1]), dtype=torch.float32, device=batch.device
    )
    for n in spec.gram_lengths:
        ids = window_ids(batch, n, spec)
        rows = ids if lut is None else lut[ids].long()
        partial_rows = _partial_window_rows(
            batch, lengths, n, ids[:, 0], spec, lut, miss_row
        )
        rows, mask = _splice_partial_windows(
            rows, partial_rows, lengths, n, window_limit
        )
        total += _cell_accumulate(weights, rows, mask, cell, n_cells, block)
    return total


def window_scores_batch_cuckoo(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    weights: torch.Tensor,
    entries: torch.Tensor,
    *,
    seed1: int,
    seed2: int,
    spec: VocabSpec,
    cell: int,
    block: int = DEFAULT_BLOCK,
    window_limit: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`window_scores_batch` for packed-key cuckoo membership (exact
    gram lengths 4..5): the two-probe row resolution of
    :func:`score_batch_cuckoo`, summed per cell."""
    if spec.mode != EXACT:
        raise ValueError(
            "window_scores_batch_cuckoo needs an exact vocab spec — hashed "
            "specs use integer-id scoring (window_scores_batch)"
        )
    B, S = batch.shape
    n_cells = -(-S // cell)
    G = weights.shape[0] - 1
    total = torch.zeros(
        (B, n_cells, weights.shape[1]), dtype=torch.float32, device=batch.device
    )
    for n in spec.gram_lengths:
        lo, hi = window_keys(batch, n)
        rows = _cuckoo_rows(lo, hi, entries, G, seed1, seed2)
        plo, phi = partial_window_keys(batch, lengths, n)
        prows = _cuckoo_rows(plo, phi, entries, G, seed1, seed2)
        prows = torch.where(lengths > 0, prows, G)
        rows, mask = _splice_partial_windows(rows, prows, lengths, n, window_limit)
        total += _cell_accumulate(weights, rows, mask, cell, n_cells, block)
    return total


def _host_rows(
    ids: np.ndarray, weights: np.ndarray, sorted_ids: np.ndarray | None
) -> np.ndarray:
    """weights rows of ``ids`` on the host: direct for the dense table,
    binary-search membership (misses → the zeros row G) for compact ones."""
    if sorted_ids is None:
        return weights[ids]
    if len(sorted_ids) == 0:
        return weights[np.full(len(ids), weights.shape[0] - 1)]
    pos = np.searchsorted(sorted_ids, ids)
    pos_c = np.minimum(pos, len(sorted_ids) - 1)
    hit = sorted_ids[pos_c] == ids
    return weights[np.where(hit, pos_c, weights.shape[0] - 1)]


def window_scores_numpy(
    byte_docs: list[bytes],
    weights: np.ndarray,
    sorted_ids: np.ndarray | None,
    spec: VocabSpec,
    cell: int,
) -> list[np.ndarray]:
    """Host mirror of :func:`window_scores_batch` in float64 (the oracle):
    per document a ``[max(1, ceil(len / cell)), L]`` array; window start →
    cell ``start // cell``; a short document's partial windows land in
    cell 0. ``weights``/``sorted_ids`` as for :func:`score_batch_numpy`."""
    L = weights.shape[1]
    out = []
    for doc in byte_docs:
        acc = np.zeros((max(1, -(-len(doc) // cell)), L), dtype=np.float64)
        arr = np.frombuffer(doc, dtype=np.uint8)[None, :]
        for n in spec.gram_lengths:
            if len(doc) >= n:
                ids = np.asarray(window_ids_numpy(arr, n, spec)[0], np.int64)
                np.add.at(
                    acc, np.arange(len(ids)) // cell,
                    _host_rows(ids, weights, sorted_ids),
                )
        short = short_doc_ids_numpy(doc, spec)
        if short:
            acc[0] += _host_rows(
                np.asarray(short, dtype=np.int64), weights, sorted_ids
            ).sum(axis=0)
        out.append(acc)
    return out


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
        out[i] = _host_rows(np.concatenate(ids_all), weights, sorted_ids).sum(axis=0)
    return out
