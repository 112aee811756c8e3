"""The compulsory work of the benchmark's calls, from their inputs alone.

Each count depends on the cell's inputs and configuration only: never on
the strategy, padding, table layout or batching the program chose, so any
implementation of the same work reads the same count. Each input byte is
read once and each output byte written once.

A ``transform`` call over documents ``D`` with ``L`` languages:

- bytes = the documents' bytes
  + ``L * weight_bytes`` for each distinct profile gram the call's windows
  touch (one profile row each; a gram outside the profile reads nothing)
  + 4 bytes per document for its label (int32);
- operations = one add per window per language (``windows * L``) + the
  argmax (``L`` per document).

A ``fit`` over a training corpus with ``L`` languages:

- bytes = the corpus bytes + 4 bytes per distinct (gram, language) count
  (int32) + the profile written (``G * (8 + L * 8)``: ids and float64
  weights);
- operations = one add per window.

The least time is the larger of operations over the card's float32 peak
and bytes over its memory bandwidth (:mod:`.peaks`).
"""

from __future__ import annotations

import numpy as np

from .reference.vocab import Vocab


def windows(vocab: Vocab, lengths) -> int:
    """Windows of documents of these byte lengths, partial ones included."""
    ln = np.asarray(lengths, dtype=np.int64)
    full = sum(int(np.maximum(ln - n + 1, 0).sum()) for n in vocab.gram_lengths)
    partial = sum(int(((ln > 0) & (ln < n)).sum()) for n in vocab.gram_lengths)
    return full + partial


def transform_work(vocab: Vocab, lengths, distinct_rows: int, n_langs: int,
                   weight_bytes: int) -> dict:
    """Operations and bytes of one transform call."""
    ln = np.asarray(lengths, dtype=np.int64)
    w = windows(vocab, ln)
    return {
        "ops": float(w * n_langs + ln.size * n_langs),
        "bytes": float(ln.sum() + distinct_rows * n_langs * weight_bytes + 4 * ln.size),
    }


def fit_work(vocab: Vocab, lengths, distinct_pairs: int, profile_grams: int,
             n_langs: int) -> dict:
    """Operations and bytes of one fit."""
    ln = np.asarray(lengths, dtype=np.int64)
    return {
        "ops": float(windows(vocab, ln)),
        "bytes": float(ln.sum() + 4 * distinct_pairs + profile_grams * (8 + 8 * n_langs)),
    }


def least_seconds(work: dict, peaks: dict) -> float:
    """The least time the card could take for ``work``."""
    return max(work["ops"] / peaks["f32_ops_per_s"], work["bytes"] / peaks["hbm_bytes_per_s"])
