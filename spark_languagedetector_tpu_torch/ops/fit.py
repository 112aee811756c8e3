"""Profile fitting on the host: gram counting → weighting → per-language top-k.

Port of ``spark_languagedetector_tpu.ops.fit`` (vectorized numpy; the
profile it returns is bit-identical). The reference's four training stages:

  computeGrams + reduceGrams → :func:`extract_gram_counts`
  computeProbabilities       → :func:`compute_weights`
  filterTopGrams             → :func:`select_top_grams`

Weighting modes: ``parity`` is the reference's actual formula,
weight_l = log(1 + present_l / #langs_containing_gram); ``counts`` is the
formula its documentation claims, weight_l = log(1 + count_l / total_count).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .encoding import pad_batch
from .vocab import VocabSpec, window_ids_numpy

PARITY = "parity"
COUNTS = "counts"
WEIGHT_MODES = (PARITY, COUNTS)

_FIT_BATCH = 1024  # docs per padded counting batch
# Pending (unmerged per-batch unique) elements before a merge into the
# running accumulator — ~128MB of ids+counts.
_PENDING_MERGE_LIMIT = 8_000_000


@dataclass(frozen=True)
class GramCounts:
    """Sparse per-(gram, language) totals: the reduceGrams output."""

    ids: np.ndarray  # int64 [M] gram ids, ascending
    langs: np.ndarray  # int32 [M] language indices
    counts: np.ndarray  # int64 [M] total occurrences
    num_langs: int


def extract_gram_counts(
    byte_docs: Sequence[bytes],
    lang_indices: np.ndarray,
    num_langs: int,
    spec: VocabSpec,
    batch_size: int = _FIT_BATCH,
    gram_lengths_subset: tuple[int, ...] | None = None,
    min_partial_gram_len: int = 1,
) -> GramCounts:
    """Count every window occurrence per (gram id, language), partial windows
    of short documents included (Scala ``sliding``). Each batch's window ids
    reduce to (unique pair, count) at once and merge into the accumulator
    when the pending set is large, so memory stays O(batch + distinct pairs).

    ``gram_lengths_subset`` counts only those window classes (ids stay in
    the full spec's id space); ``min_partial_gram_len`` drops partial
    windows whose gram (the whole short doc) is shorter than the bound. The
    split device fit uses both to part the counts by resulting gram length
    (``ops.fit_tpu.fit_profile_device_split``).
    """
    lang_indices = np.asarray(lang_indices, dtype=np.int64)
    lengths_to_count = (
        tuple(gram_lengths_subset)
        if gram_lengths_subset is not None
        else spec.gram_lengths
    )
    max_n = max(lengths_to_count)
    acc_ids = np.zeros(0, np.int64)
    acc_counts = np.zeros(0, np.int64)
    pending: list[tuple[np.ndarray, np.ndarray]] = []
    pending_elems = 0

    def flush():
        nonlocal acc_ids, acc_counts, pending, pending_elems
        if not pending:
            return
        all_ids = np.concatenate([acc_ids] + [u for u, _ in pending])
        all_counts = np.concatenate([acc_counts] + [c for _, c in pending])
        acc_ids, inv = np.unique(all_ids, return_inverse=True)
        # bincount sums in float64 — exact for counts below 2^53.
        acc_counts = np.bincount(
            inv, weights=all_counts.astype(np.float64)
        ).astype(np.int64)
        pending = []
        pending_elems = 0

    for start in range(0, len(byte_docs), batch_size):
        docs = byte_docs[start : start + batch_size]
        langs = lang_indices[start : start + batch_size]
        batch, lengths = pad_batch(docs, pad_to=max(max(len(d) for d in docs), 1))
        batch_chunks: list[np.ndarray] = []
        for n in lengths_to_count:
            if batch.shape[1] < n:
                continue  # no full windows of this class in the batch
            ids = window_ids_numpy(batch, n, spec)  # [B, W]
            W = ids.shape[1]
            mask = np.arange(W)[None, :] <= (lengths[:, None] - n)
            lang_grid = np.broadcast_to(langs[:, None], ids.shape)
            batch_chunks.append(ids[mask] * num_langs + lang_grid[mask])
        # Partial windows: one window of the whole doc per gram length it
        # falls short of, id in the doc's own length class.
        for i, doc in enumerate(docs):
            n_doc = len(doc)
            if min_partial_gram_len <= n_doc < max_n:
                reps = sum(1 for n in lengths_to_count if n > n_doc)
                if reps:
                    short_id = spec.gram_to_id(bytes(doc))
                    batch_chunks.append(
                        np.full(reps, short_id, dtype=np.int64) * num_langs
                        + langs[i]
                    )
        if batch_chunks:
            u, c = np.unique(np.concatenate(batch_chunks), return_counts=True)
            pending.append((u, c.astype(np.int64)))
            pending_elems += len(u)
            if pending_elems > _PENDING_MERGE_LIMIT:
                flush()

    flush()
    return GramCounts(
        ids=acc_ids // num_langs,
        langs=(acc_ids % num_langs).astype(np.int32),
        counts=acc_counts,
        num_langs=num_langs,
    )


def compute_weights(
    gram_counts: GramCounts, weight_mode: str = PARITY
) -> tuple[np.ndarray, np.ndarray]:
    """Per-gram weight vectors: (unique_ids [U] ascending, weights [U, L]
    float64)."""
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(f"weight_mode must be one of {WEIGHT_MODES}")
    L = gram_counts.num_langs
    unique_ids, row_index = np.unique(gram_counts.ids, return_inverse=True)
    U = len(unique_ids)
    weights = np.zeros((U, L), dtype=np.float64)
    if weight_mode == PARITY:
        # #langs containing each gram; each (id, lang) appears exactly once.
        nlangs = np.bincount(row_index, minlength=U).astype(np.float64)
        weights[row_index, gram_counts.langs] = np.log1p(1.0 / nlangs[row_index])
    else:
        totals = np.zeros(U, dtype=np.float64)
        np.add.at(totals, row_index, gram_counts.counts.astype(np.float64))
        weights[row_index, gram_counts.langs] = np.log1p(
            gram_counts.counts / totals[row_index]
        )
    return unique_ids, weights


def select_top_grams(
    unique_ids: np.ndarray,
    weights: np.ndarray,
    profile_size: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Keep the union over languages of each language's top-k grams, with the
    full weight vector of every winner. Ties break by gram id ascending."""
    L = weights.shape[1]
    k = min(profile_size, len(unique_ids))
    winner_rows: list[np.ndarray] = []
    for l in range(L):
        # lexsort: last key primary → primary -weight, secondary id ascending.
        winner_rows.append(np.lexsort((unique_ids, -weights[:, l]))[:k])
    rows = (
        np.unique(np.concatenate(winner_rows))
        if winner_rows
        else np.zeros(0, np.int64)
    )
    return unique_ids[rows], np.ascontiguousarray(weights[rows])


def fit_profile_numpy(
    byte_docs: Sequence[bytes],
    lang_indices: np.ndarray,
    num_langs: int,
    spec: VocabSpec,
    profile_size: int,
    weight_mode: str = PARITY,
) -> tuple[np.ndarray, np.ndarray]:
    """Full host fit: returns (sorted gram ids [G], weights [G, L] float64)."""
    gram_counts = extract_gram_counts(byte_docs, lang_indices, num_langs, spec)
    unique_ids, weights = compute_weights(gram_counts, weight_mode)
    return select_top_grams(unique_ids, weights, profile_size)
