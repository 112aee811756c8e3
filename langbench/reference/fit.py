"""Plain reference fit: a byte-n-gram profile from a labelled corpus.

The algorithm of spark-languagedetector with its ``parity`` weighting, as
the benchmark's configurations state it, written from that description and
not from the program:

1. Every window of every training document (:mod:`.vocab`) marks its gram
   as present in the document's language.
2. A gram present in ``k`` of the languages weighs ``log(1 + 1/k)`` in each
   of them (float64) and 0 in the others.
3. Each language keeps its ``min(profile_size, U)`` heaviest grams (``U``
   the number of distinct grams of the corpus), ties to the lower gram id;
   a language with fewer present grams than that fills up with the
   lowest-id grams it lacks, at weight 0.
4. The profile is the union of the kept grams, ascending by id, each with
   its whole weight vector over the languages.

Presence is taken from sorted unique ``(gram, language)`` keys, so nothing
depends on the order of documents or on a table's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .vocab import Vocab, blocks, window_ids

BLOCK_BYTES = 1 << 22  # training bytes per window pass


def presence_pairs(vocab: Vocab, byte_docs, lang_idx, n_langs: int, device) -> torch.Tensor:
    """Sorted unique keys ``gram * n_langs + language`` of the corpus."""
    lang_t = torch.as_tensor(np.asarray(lang_idx, dtype=np.int64), device=device)
    parts = []
    for a, b in blocks(byte_docs, BLOCK_BYTES):
        ids, doc = window_ids(vocab, byte_docs[a:b], device)
        parts.append(torch.unique(ids * n_langs + lang_t[a:b][doc]))
    if not parts:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.unique(torch.cat(parts))


def fit(config: dict, byte_docs, lang_idx, device, weight_dtype=torch.float64):
    """``(ids int64 [G] ascending, weights [G, L] float64)`` on the host:
    the profile of ``config`` (``languages``, ``languageProfileSize``,
    ``weightMode`` "parity") from ``byte_docs`` labelled ``lang_idx``.
    ``weight_dtype`` rounds the weights through a narrower type (the
    benchmark's control); the ranking is the exact one either way."""
    if config.get("weightMode", "parity") != "parity":
        raise ValueError("the reference fit implements the parity weighting only")
    vocab = Vocab.of(config)
    L = int(config["languages"])
    keys = presence_pairs(vocab, byte_docs, lang_idx, L, device)
    return finalize(keys, L, int(config["languageProfileSize"]), weight_dtype)


def finalize(keys: torch.Tensor, L: int, profile_size: int, weight_dtype=torch.float64):
    """Steps 2-4 from the sorted presence keys."""
    gram, lang = keys // L, keys % L
    ugram, nl = torch.unique_consecutive(gram, return_counts=True)
    U = int(ugram.numel())
    k = min(profile_size, U)
    nlangs = torch.repeat_interleave(nl, nl)
    # Heaviest first is fewest languages first; ties by id (keys are sorted
    # by gram already, and both sorts are stable).
    order = torch.argsort(nlangs, stable=True)
    order = order[torch.argsort(lang[order], stable=True)]
    lang_s = lang[order]
    first = torch.searchsorted(lang_s, torch.arange(L, device=keys.device))
    rank = torch.arange(lang_s.numel(), device=keys.device) - first[lang_s]
    kept = gram[order][rank < k]
    present = torch.bincount(lang, minlength=L).cpu().numpy()
    extra = []
    if (present < k).any():
        ug = ugram.cpu().numpy()
        g_np, l_np = gram.cpu().numpy(), lang.cpu().numpy()
        for l in np.flatnonzero(present < k):
            lacks = np.setdiff1d(ug, g_np[l_np == l], assume_unique=True)
            extra.append(lacks[: k - int(present[l])])
    ids = torch.unique(kept).cpu().numpy()
    if extra:
        ids = np.union1d(ids, np.concatenate(extra))
    # Weights of every pair whose gram was kept.
    ids_t = torch.as_tensor(ids, device=keys.device)
    row = torch.searchsorted(ids_t, gram)
    hit = (row < ids_t.numel()) & (ids_t[row.clamp(max=max(ids_t.numel() - 1, 0))] == gram)
    table = np.log1p(1.0 / np.arange(1, L + 1, dtype=np.float64))  # k languages -> weight
    w = np.zeros((ids.size, L), dtype=np.float64)
    r, c, n = (t[hit].cpu().numpy() for t in (row, lang, nlangs))
    w[r, c] = table[n - 1]
    if weight_dtype != torch.float64:
        w = torch.from_numpy(w).to(weight_dtype).double().numpy()
    return ids.astype(np.int64), w
