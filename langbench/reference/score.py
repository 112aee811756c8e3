"""Plain reference scorer: each document's score per language.

A document's score for language l is the sum, over its windows (partial
windows included, :mod:`.vocab`), of the profile weight of the window's
gram in l; a gram outside the profile adds nothing. The label is the
language of the highest score, the first one on a tie (so a document with
no profile gram is labelled with the first language).

Computed as ``counts @ W``: per block of documents, how often each profile
gram occurs in each document (exact integers), times the weight table. In
float64 that is the reference; the benchmark's control runs the same sum
with the table rounded to a narrower type.
"""

from __future__ import annotations

import numpy as np
import torch

from .vocab import Vocab, blocks, window_ids

COUNT_ELEMS = 1 << 27  # documents x profile grams per block (1 GiB of f64)
BLOCK_BYTES = 1 << 24  # document bytes per window pass


def gram_counts(vocab: Vocab, byte_docs, ids_t: torch.Tensor) -> torch.Tensor:
    """int64 ``[D, G]``: occurrences of each profile gram (``ids_t``,
    ascending) in each document."""
    G = int(ids_t.numel())
    D = len(byte_docs)
    ids, doc = window_ids(vocab, byte_docs, ids_t.device)
    row = torch.searchsorted(ids_t, ids)
    hit = (row < G) & (ids_t[row.clamp(max=G - 1)] == ids)
    return torch.bincount(doc[hit] * G + row[hit], minlength=D * G).view(D, G)


def score(config: dict, byte_docs, ids: np.ndarray, weights: np.ndarray, device,
          table_dtype=torch.float64, sum_dtype=torch.float64) -> np.ndarray:
    """``[D, L]`` scores of ``byte_docs`` under the profile ``(ids,
    weights)``: the table is rounded to ``table_dtype`` and summed in
    ``sum_dtype`` (float64 both for the reference)."""
    vocab = Vocab.of(config)
    ids_t = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)
    W = torch.as_tensor(weights, device=device).to(table_dtype).to(sum_dtype)
    G, L = W.shape
    out = np.zeros((len(byte_docs), L), dtype=np.float64)
    if G == 0:
        return out
    per_block = max(1, COUNT_ELEMS // G)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32 here
    try:
        for a, b in blocks(byte_docs, BLOCK_BYTES):
            for s in range(a, b, per_block):
                e = min(b, s + per_block)
                counts = gram_counts(vocab, byte_docs[s:e], ids_t).to(sum_dtype)
                out[s:e] = (counts @ W).double().cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def labels(scores: np.ndarray) -> np.ndarray:
    """Index of the highest score per row, the first on a tie."""
    return np.argmax(scores, axis=1)
