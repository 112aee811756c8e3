"""The port's bigram kernels (plain versions on the CPU) against JAX.

The same dense exact profiles and documents (numpy seed) go through the JAX
package's ``ops.score_pallas`` (its Pallas kernels in interpret mode,
``block=128``), its gather scorer, and the port's ``score_pallas`` with CPU
tensors, which are the bigram-histogram and bigram-score kernels' plain
PyTorch versions.

* Bit-exact: ``bigram_hist`` against JAX ``_hist_batch``.
* Reduction-order (``atol=1e-4, rtol=1e-5``, labels identical):
  ``score_batch_pallas`` at L ≤ 16 (the bigram-score kernel) and L > 16
  (the bigram-histogram kernel and a float64 matmul), with window limits;
  and a numpy model of the bigram-score kernel's arithmetic (one key per
  window, counts per distinct key, count × (w2 row + folded w1 row), the
  last byte's unigram window) against JAX and the plain version.

The kernel itself runs only on a CUDA card: the ``cuda``-marked test holds
it against the plain version there and skips elsewhere.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_languagedetector_tpu.ops import score as jscore
from spark_languagedetector_tpu.ops import score_pallas as jpallas
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu_torch.ops import score_pallas as SP
from spark_languagedetector_tpu_torch.ops._kernels import BIGRAM_HIST, BIGRAM_SCORE, CSRC_DIR
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


# ------------------------------------------- the bigram-score kernel's model


def kernel_model(batch, lengths, lim, w1, w2, has1, has2):
    """numpy model of ``csrc/bigram_score.cu``'s arithmetic, in float64: one
    key per window (b0 * 256 + b1 over starts s < min(len - 1, lim) when
    has2, else b0 over s < min(len, lim)), counts per distinct key
    (``bincount``), then count x (w2[key] + w1[key >> 8]) or count x
    w1[key], and the last byte's unigram window once where has1 and has2
    and len - 1 < lim. Returns float32 [B, L]."""
    B, S = batch.shape
    out = np.zeros((B, w1.shape[1]))
    w1, w2 = w1.astype(np.float64), w2.astype(np.float64)
    for b in range(B):
        n, lm = int(lengths[b]), min(int(lim[b]), S)
        doc = batch[b].astype(np.int64)
        if has2:
            nwin = max(0, min(n - 1, lm))
            keys = doc[:nwin] * 256 + doc[1 : nwin + 1]
            rows = w2 + (np.repeat(w1, 256, axis=0) if has1 else 0.0)
        else:
            nwin = max(0, min(n, lm)) if has1 else 0
            keys, rows = doc[:nwin], w1
        counts = np.bincount(keys, minlength=rows.shape[0])
        out[b] = counts @ rows
        if has1 and has2 and n >= 1 and n - 1 < lm:
            out[b] += w1[doc[n - 1]]
    return out.astype(np.float32)


def _model_inputs(seed):
    """Edge documents (empty, 1 and 2 bytes, 0x00/0xFF, one filling the
    width) with limits of len - 1, len, less than len and the full width."""
    rng = np.random.default_rng(seed)
    docs = _docs(rng)
    batch, lengths = pad_batch(docs, PAD)
    lim = np.full(len(docs), PAD, np.int32)
    lim[0::4] = np.maximum(lengths[0::4] - 1, 0)
    lim[1::4] = lengths[1::4]
    lim[2::4] = rng.integers(1, 40, len(lim[2::4]))
    return rng, batch, lengths, lim


@pytest.mark.parametrize("L", [1, 10, 16])
@pytest.mark.parametrize("glens", [(1, 2), (2,), (1,)])
def test_kernel_model_matches_jax_and_plain(glens, L):
    rng, batch, lengths, lim = _model_inputs(L * 7 + len(glens))
    spec, jspec = VocabSpec("exact", glens), JaxVocabSpec("exact", glens)
    w = _dense(rng, spec, L)
    w1, w2 = SP.weight_views(w, spec)
    has1, has2 = 1 in glens, 2 in glens
    model = kernel_model(batch, lengths, lim, w1.numpy(), w2.numpy(), has1, has2)
    assert np.abs(model).sum() > 0

    plain = SP.bigram_score_plain(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(lim),
        w1, w2, has1, has2,
    ).numpy()
    np.testing.assert_allclose(model, plain, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(np.argmax(model, 1), np.argmax(plain, 1))

    # JAX's score_batch_pallas adds the 1-byte partial window under n = 2.
    if has2:
        model = model + np.where((lengths == 1)[:, None], w1.numpy()[batch[:, 0]], 0.0)
    jw1, jw2 = jpallas.weight_views(w, jspec)
    ref = np.asarray(jpallas.score_batch_pallas(
        jnp.asarray(batch), jnp.asarray(lengths), jw1, jw2, jnp.asarray(lim),
        spec=jspec, block=BLOCK, interpret=True,
    ))
    np.testing.assert_allclose(model, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(np.argmax(model, 1), np.argmax(ref, 1))


def test_kernel_model_folds_the_unigram_into_the_bigram_keys():
    """The fold's edge: the unigram sum equals the bigram keys' first bytes
    plus the last byte exactly when len - 1 < lim (w2 = 0 isolates it)."""
    batch, lengths = pad_batch([b"abcab", b"abcab", b"x", b""], 8)
    lim = np.asarray([8, 4, 8, 8], np.int32)  # start 4 owned, not owned, ...
    w1 = np.zeros((256, 1), np.float32)
    w1[[ord("a"), ord("b"), ord("c"), ord("x")], 0] = [1.0, 10.0, 100.0, 1000.0]
    got = kernel_model(batch, lengths, lim, w1, np.zeros((65536, 1), np.float32), True, True)
    np.testing.assert_array_equal(got[:, 0], [122.0, 112.0, 1000.0, 0.0])


def test_bigram_score_language_ceiling_matches_the_kernel_source():
    """The wrapper's MAX_PALLAS_LANGS is the kernel's register-sum ceiling."""
    src = (CSRC_DIR / "bigram_score.cu").read_text()
    assert int(re.search(r"kMaxPallasLangs = (\d+);", src).group(1)) == SP.MAX_PALLAS_LANGS


def _card_batch(kind, rng):
    """(docs, width, limits) of one card-test batch."""
    if kind == "edges":
        _, batch, lengths, lim = _model_inputs(3)
        return [bytes(row[:n]) for row, n in zip(batch, lengths)], PAD, lim
    if kind == "repeat":
        # One bigram (or byte) to the width: the largest counts.
        pad = 2048
        docs = [b"ab" * (pad // 2), b"a" * pad, b"\xff" * pad, b"xyz" * (pad // 3), b"e" * 100]
        return docs, pad, rng.integers(1, pad, len(docs)).astype(np.int32)
    # Random bytes: thousands of distinct bigrams a document, several
    # flushes of the kernel's key counts.
    pad = 8192
    docs = [bytes(rng.integers(0, 256, pad - i).tolist()) for i in range(4)]
    return docs, pad, rng.integers(pad // 2, pad, len(docs)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["edges", "repeat", "distinct"])
def test_bigram_score_kernel_matches_plain_on_the_card(kind):
    """Launches ``csrc/bigram_score.cu`` (built with nvcc on first use) and
    holds it against the plain version on the card for has1 + has2, has2
    and has1, L = 1, 10, 16, with and without limits: within the
    reduction-order tolerance, two launches bit-identical. On the repeated
    grams, whose signed weights times counts of 2,000 cancel to sums far
    below their terms, the reference is the float64 sum (``kernel_model``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU form")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(17)
    docs, pad, lim = _card_batch(kind, rng)
    batch, lengths = pad_batch(docs, pad)
    bd, ld = torch.from_numpy(batch).to(dev), torch.from_numpy(lengths).to(dev)
    for limit in (np.full(len(docs), pad, np.int32), lim):
        md = torch.from_numpy(limit).to(dev)
        for L in (1, 10, 16):
            w1_np, w2_np = (rng.normal(size=(n, L)).astype(np.float32) for n in (256, 65536))
            w1, w2 = torch.from_numpy(w1_np).to(dev), torch.from_numpy(w2_np).to(dev)
            for has1, has2 in ((True, True), (False, True), (True, False)):
                launches = BIGRAM_SCORE.launches
                got = SP.bigram_score(bd, ld, md, w1, w2, has1, has2)
                again = SP.bigram_score(bd, ld, md, w1, w2, has1, has2)
                torch.cuda.synchronize()
                assert BIGRAM_SCORE.launches == launches + 2
                assert torch.equal(got, again)
                if kind == "repeat":
                    ref = torch.from_numpy(
                        kernel_model(batch, lengths, limit, w1_np, w2_np, has1, has2)).to(dev)
                else:
                    ref = SP.bigram_score_plain(bd, ld, md, w1, w2, has1, has2)
                torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
