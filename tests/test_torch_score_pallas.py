"""The port's bigram kernels (plain versions on the CPU) against JAX.

The same dense exact profiles and documents (numpy seed) go through the JAX
package's ``ops.score_pallas`` (its Pallas kernels in interpret mode,
``block=128``), its gather scorer, and the port's ``score_pallas`` with CPU
tensors, which are the bigram-histogram and bigram-score kernels' plain
PyTorch versions.

* Bit-exact: ``bigram_hist`` against JAX ``_hist_batch``.
* Reduction-order (``atol=1e-4, rtol=1e-5``, labels identical):
  ``score_batch_pallas`` at L ≤ 16 (the bigram-score kernel) and L > 16
  (the bigram-histogram kernel and a float64 matmul), with window limits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_languagedetector_tpu.ops import score as jscore
from spark_languagedetector_tpu.ops import score_pallas as jpallas
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu_torch.ops import score_pallas as SP
from spark_languagedetector_tpu_torch.ops._kernels import BIGRAM_HIST, BIGRAM_SCORE
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec

ATOL, RTOL = 1e-4, 1e-5
PAD = 256
BLOCK = 128


def _docs(rng):
    docs = [bytes(rng.integers(97, 112, int(rng.integers(0, 60))).tolist()) for _ in range(7)]
    # Empty, 1 byte, 2 bytes, 0x00/0xFF, random bytes, one filling the width
    # (its last window's next byte lies past it): 16 documents.
    docs += [b"", b"a", b"\xff", b"ab", b"\x00\xff\x00", bytes(rng.integers(0, 256, 200).tolist()),
             b"\xff" * PAD, bytes(rng.integers(0, 256, PAD).tolist()), b"zz"]
    return docs


def _inputs(seed, limited):
    rng = np.random.default_rng(seed)
    docs = _docs(rng)
    batch, lengths = pad_batch(docs, PAD)
    lim = (rng.integers(1, 40, len(docs)) if limited else np.full(len(docs), PAD)).astype(np.int32)
    return rng, batch, lengths, lim


@pytest.mark.parametrize("limited", [False, True])
@pytest.mark.parametrize("mask_n", [1, 2])
def test_bigram_hist_plain_matches_jax_kernel(mask_n, limited):
    _, batch, lengths, lim = _inputs(mask_n, limited)
    got = SP.bigram_hist(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(lim), mask_n
    ).numpy()
    b0 = jnp.asarray(batch.astype(np.int32))
    b1 = jnp.pad(b0[:, 1:], ((0, 0), (0, 1)))
    ref = np.asarray(jpallas._hist_batch(
        b0, b1, jnp.asarray(lengths), jnp.asarray(lim), blk=BLOCK, mask_n=mask_n,
        interpret=True,
    )).reshape(len(batch), 65536)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32 and got.sum() > 0


def _dense(rng, spec, L):
    w = np.zeros((spec.id_space_size, L), np.float32)
    n = min(3000, spec.id_space_size // 2)
    learned = rng.choice(spec.id_space_size, n, replace=False)
    w[learned] = rng.normal(size=(n, L)).astype(np.float32)
    w[97:112] = rng.normal(size=(15, L)).astype(np.float32)  # the docs' bytes
    return w


@pytest.mark.parametrize("limited", [False, True])
@pytest.mark.parametrize("glens,L", [((1, 2), 5), ((2,), 5), ((1,), 5), ((1, 2), 20), ((2,), 20)])
def test_score_batch_pallas_matches_jax(glens, L, limited):
    rng, batch, lengths, lim = _inputs(L + len(glens), limited)
    spec, jspec = VocabSpec("exact", glens), JaxVocabSpec("exact", glens)
    assert SP.pallas_supported(spec, spec.id_space_size, L)
    w = _dense(rng, spec, L)
    w1, w2 = SP.weight_views(w, spec)
    kernel = BIGRAM_SCORE if L <= SP.MAX_PALLAS_LANGS else BIGRAM_HIST
    launches = kernel.launches
    got = SP.score_batch_pallas(
        torch.from_numpy(batch), torch.from_numpy(lengths), w1, w2,
        torch.from_numpy(lim), spec=spec,
    ).numpy()
    assert kernel.launches == launches  # plain versions on the CPU
    jw1, jw2 = jpallas.weight_views(w, jspec)
    ref = np.asarray(jpallas.score_batch_pallas(
        jnp.asarray(batch), jnp.asarray(lengths), jw1, jw2, jnp.asarray(lim),
        spec=jspec, block=BLOCK, interpret=True,
    ))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(np.argmax(got, 1), np.argmax(ref, 1))
    gather = np.asarray(jscore.score_batch(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(w), None, spec=jspec,
        window_limit=jnp.asarray(lim),
    ))
    np.testing.assert_allclose(got, gather, atol=ATOL, rtol=RTOL)
    assert np.abs(gather).sum() > 0


def test_weight_views_match_jax_layout():
    spec, jspec = VocabSpec("exact", (1, 2)), JaxVocabSpec("exact", (1, 2))
    w = _dense(np.random.default_rng(1), spec, 4)
    w1, w2 = SP.weight_views(w, spec)
    jw1, jw2 = jpallas.weight_views(w, jspec)  # L <= 16: w2 is [L, 256, 256]
    np.testing.assert_array_equal(w1.numpy(), np.asarray(jw1))
    np.testing.assert_array_equal(
        w2.numpy(), np.asarray(jw2).transpose(1, 2, 0).reshape(65536, 4)
    )
    _, zeros = SP.weight_views(w[:256], VocabSpec("exact", (1,)))
    assert zeros.shape == (65536, 4) and not zeros.any()
    # Unigram-only vocabs beyond the bigram-score kernel's language ceiling
    # are not a pallas form, as in the JAX package.
    for L in (16, 17):
        args = (VocabSpec("exact", (1,)), 256, L)
        jargs = (JaxVocabSpec("exact", (1,)), 256, L)
        assert SP.pallas_supported(*args) == jpallas.pallas_supported(*jargs)


def test_bigram_wrappers_take_plain_versions_only_on_cpu():
    batch, lengths = pad_batch([b"abc", b"x"], 128)
    b, l = torch.from_numpy(batch), torch.from_numpy(lengths)
    lim = torch.full((2,), 128, dtype=torch.int32)
    w1 = torch.ones((256, 3))
    w2 = torch.ones((65536, 3))
    counts = BIGRAM_HIST.launches, BIGRAM_SCORE.launches
    hist = SP.bigram_hist(b, l, lim, 2)
    scores = SP.bigram_score(b, l, lim, w1, w2, True, True)
    assert (BIGRAM_HIST.launches, BIGRAM_SCORE.launches) == counts
    assert float(hist[0].sum()) == 2.0 and float(hist[1].sum()) == 0.0
    np.testing.assert_array_equal(scores.numpy(), [[5.0] * 3, [1.0] * 3])
    with pytest.raises(ValueError, match="CUDA"):
        SP.bigram_hist_kernel(b, l, lim, 2)
    with pytest.raises(ValueError, match="CUDA"):
        SP.bigram_score_kernel(b, l, lim, w1, w2, True, True)
    with pytest.raises(ValueError, match="exact-mode"):
        SP.score_batch_pallas(b, l, w1, w2, spec=VocabSpec("exact", (1, 2, 3)))
