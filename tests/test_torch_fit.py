"""The port's host fit against the JAX package's: ids and weights bit-identical.

One synthetic corpus (numpy seed) with short documents (partial windows),
duplicate grams across languages and weight ties, fitted by both packages'
``fit_profile_numpy`` in both weight modes, over an exact and a hashed vocab.
"""

import numpy as np
import pytest

from spark_languagedetector_tpu.ops import fit as jfit
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu_torch.ops import fit as tfit
from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec


def _corpus(seed=5, n_langs=4, per_lang=25):
    rng = np.random.default_rng(seed)
    docs, langs = [], []
    for i in range(n_langs * per_lang):
        lang = i % n_langs
        letters = np.arange(97 + 3 * lang, 97 + 3 * lang + 8)  # overlapping alphabets
        docs.append(bytes(rng.choice(letters, int(rng.integers(0, 80))).tolist()))
        langs.append(lang)
    docs += [b"", b"q", b"ab", b"abcd"]
    langs += [0, 1, 2, 3]
    return docs, np.asarray(langs), n_langs


@pytest.mark.parametrize("weight_mode", ["parity", "counts"])
@pytest.mark.parametrize(
    "vocab", [("exact", (1, 2, 3), 20), ("hashed", (1, 2, 3, 4, 5), 18)]
)
def test_fit_profile_bit_identical(vocab, weight_mode):
    docs, langs, L = _corpus()
    ids, w = tfit.fit_profile_numpy(docs, langs, L, VocabSpec(*vocab), 40, weight_mode)
    jids, jw = jfit.fit_profile_numpy(
        docs, langs, L, JaxVocabSpec(*vocab), 40, weight_mode
    )
    assert ids.dtype == jids.dtype and w.dtype == jw.dtype
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(w, jw)


def test_gram_counts_and_merge_flush_match(monkeypatch):
    """Small merge limit: the streaming merge path gives the same counts."""
    docs, langs, L = _corpus(seed=6)
    spec, jspec = VocabSpec("exact", (1, 2)), JaxVocabSpec("exact", (1, 2))
    monkeypatch.setattr(tfit, "_PENDING_MERGE_LIMIT", 10)
    got = tfit.extract_gram_counts(docs, langs, L, spec, batch_size=7)
    ref = jfit.extract_gram_counts(docs, langs, L, jspec)
    for f in ("ids", "langs", "counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
