"""The compulsory work of the hybrid route's two histogram kernels, from a
transform call's documents and the profile alone.

In the rules of :mod:`.count`: each count depends on the documents, the
profile's gram ids and the configuration only, never on the program's
padding, row count R or batching, and each input byte is read once and each
output byte written once. For a kernel that counts the windows of the gram
lengths ``ns`` of documents ``D`` (partial windows of those lengths
included, :mod:`.reference.vocab`):

- operations = one add per window;
- bytes = the documents' bytes, read once
  + 4 bytes per distinct (document, profile gram) pair among those windows,
  one count written each (a gram outside the profile writes nothing).

``row_hist`` (``csrc/row_hist.cu``) counts the lengths above 2,
``bigram_hist`` (``csrc/bigram_hist.cu``) the lengths 1 and 2
(:data:`KERNEL_LENGTHS`). A kernel that wrote only the non-zero counts
would meet this bound; the dense ``[B, R]`` histograms the kernels write
are what a share of it shows.

No metric reads it yet: a kernel's device time is read from the trace by
name, and the trace's summary keeps only its ten largest operations
(``PERF.md`` §7).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.vocab import Vocab, window_ids

# Kernel -> whether it counts the windows of a gram length.
KERNEL_LENGTHS = {"row_hist": lambda n: n > 2, "bigram_hist": lambda n: n <= 2}


def hist_work(vocab: Vocab, byte_docs, profile_ids, kernel: str, device) -> dict:
    """Operations and bytes of ``kernel`` over ``byte_docs``: the windows
    of its gram lengths and the distinct (document, profile gram) pairs
    among them."""
    ns = tuple(n for n in vocab.gram_lengths if KERNEL_LENGTHS[kernel](n))
    if not ns or not byte_docs:
        return {"ops": 0.0, "bytes": 0.0}
    ids, doc = window_ids(Vocab(vocab.mode, ns, vocab.hash_bits, vocab.scheme), byte_docs, device)
    hit = torch.isin(ids, torch.as_tensor(np.asarray(profile_ids, dtype=np.int64), device=device))
    # One key per pair: every id lies below the largest one plus one.
    span = int(ids.max()) + 1 if ids.numel() else 1
    pairs = int(torch.unique(doc[hit] * span + ids[hit]).numel())
    return {"ops": float(ids.numel()),
            "bytes": float(sum(len(d) for d in byte_docs) + 4 * pairs)}
