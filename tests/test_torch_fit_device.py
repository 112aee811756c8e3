"""The port's device fit (torch ops, ``device="cpu"``) against the JAX
package's (``ops/fit_tpu.py`` and ``ops/fit_pipeline.py`` under
``JAX_PLATFORMS=cpu``) and the host fit.

Count tables, the micro-batch plan and the fitted profiles are compared bit
for bit; the top-k selections as rows in the (value desc, id asc) order the
host fit ties by (``torch.topk`` and ``lax.top_k`` may list the entries
above the boundary in different orders, so both sides are put in that order
first); float32 weights exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_languagedetector_tpu import LanguageDetector as JaxDetector
from spark_languagedetector_tpu import Table as JaxTable
from spark_languagedetector_tpu.ops import fit_pipeline as jfp
from spark_languagedetector_tpu.ops import fit_tpu as jft
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu_torch import LanguageDetector, Table
from spark_languagedetector_tpu_torch.ops import fit_pipeline as fp
from spark_languagedetector_tpu_torch.ops import fit_tpu as ft
from spark_languagedetector_tpu_torch.ops.encoding import DEFAULT_LENGTH_BUCKETS, pad_batch
from spark_languagedetector_tpu_torch.ops.fit import COUNTS, PARITY, fit_profile_numpy
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, HASHED, VocabSpec

MAX_BUCKET = DEFAULT_LENGTH_BUCKETS[-1]


def _corpus(seed, n_docs=60, n_langs=3, max_len=150):
    """Random documents over a small alphabet (many shared grams, so
    plateaus), the edges (empty, shorter than every n > 1, 0x00/0xFF), two
    oversized documents and duplicated (document, language) pairs."""
    rng = np.random.default_rng(seed)
    docs = [
        bytes(rng.integers(97, 104, int(rng.integers(0, max_len))).tolist())
        for _ in range(n_docs)
    ]
    docs += [b"", b"a", b"ab", b"abc", b"\x00\xff\x00\xff", b"xyz" * 3000,
             bytes(rng.integers(97, 99, MAX_BUCKET + 7).tolist())]
    langs = [i % n_langs for i in range(len(docs))]
    docs += docs[:5] + [docs[-2]]
    langs += langs[:5] + [langs[-1]]
    return docs, np.asarray(langs)


SPECS = {
    "exact_n1_2": (EXACT, (1, 2)),
    "exact_n1_3": (EXACT, (1, 2, 3)),
    "hashed_fnv1a_n1_5": (HASHED, (1, 2, 3, 4, 5), 12),
    "hashed_exact12_n1_5": (HASHED, (1, 2, 3, 4, 5), 17),
}


def _batch(docs, langs, pad):
    batch, lengths = pad_batch(docs, pad)
    return batch, lengths, np.asarray(langs, np.int32)


@pytest.mark.parametrize("with_mult", [False, True])
@pytest.mark.parametrize("name", list(SPECS))
def test_gram_counts_dense_equals_jax_table(name, with_mult):
    """One padded batch's int32 [V, L] table, partial windows of short
    documents and per-row multiplicities included, bit for bit."""
    args = SPECS[name]
    spec, jspec = VocabSpec(*args), JaxVocabSpec(*args)
    docs, langs = _corpus(1, n_docs=20)
    docs = [d[:512] for d in docs]
    batch, lengths, lang_ids = _batch(docs, langs, 512)
    L = 2 if name == "exact_n1_3" else 3  # 16.8M rows: keep the table small
    lang_ids %= L
    mult = np.arange(1, len(docs) + 1, dtype=np.int32) if with_mult else None
    got = ft.gram_counts_dense(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(lang_ids),
        None if mult is None else torch.from_numpy(mult), spec=spec, num_langs=L,
    ).numpy()
    ref = np.asarray(jft.gram_counts_dense(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(lang_ids),
        None if mult is None else jnp.asarray(mult), spec=jspec, num_langs=L,
    ))
    assert got.dtype == ref.dtype == np.int32
    assert got.sum() > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", [PARITY, COUNTS])
def test_weights_from_counts_and_masked_candidates_equal_jax(mode):
    """float32 weights: parity's log1p(1/n) bit for bit; in counts mode the
    ratios are the same correctly rounded quotients, and the float32 log1p
    of the two libraries differ by up to two ulps (on this table torch's is
    within one ulp of the correctly rounded value, XLA's within two). The
    fit recomputes the winners' weights in float64 on the host, so only a
    selection between grams whose weights differ by that little could
    move."""
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 50, (500, 7)).astype(np.int32)
    counts[rng.random((500, 7)) < 0.6] = 0
    counts[::9] = 0  # rows no language saw
    for fn in ("weights_from_counts", "masked_candidate_weights"):
        got = getattr(ft, fn)(torch.from_numpy(counts), weight_mode=mode).numpy()
        ref = np.asarray(getattr(jft, fn)(jnp.asarray(counts), weight_mode=mode))
        assert got.dtype == ref.dtype == np.float32
        if mode == PARITY:
            np.testing.assert_array_equal(got, ref)
        else:
            fin = np.isfinite(ref)
            np.testing.assert_array_equal(np.isfinite(got), fin)
            np.testing.assert_array_max_ulp(got[fin], ref[fin], maxulp=2)
    assert np.isneginf(got[::9]).all()


def _plateau_table(seed, V=1100, L=4):
    """Few distinct values, so plateaus of hundreds of equal weights cross
    every block boundary; one language with fewer candidates than k."""
    rng = np.random.default_rng(seed)
    levels = np.asarray([-np.inf, 0.0, 0.3, 0.6931472, 1.1], np.float32)
    w = levels[rng.integers(0, len(levels), (V, L))]
    w[:, 0] = -np.inf
    w[rng.choice(V, 9, replace=False), 0] = 0.5
    return w


def _ordered(rows, w):
    """Each language's rows in the (value desc, id asc) order."""
    return [sorted(r.tolist(), key=lambda i: (-float(w[i, l]), i)) for l, r in enumerate(rows)]


def _numpy_top_k(w, k):
    return [
        np.lexsort((np.arange(w.shape[0]), -w[:, l]))[:k].tolist() for l in range(w.shape[1])
    ]


@pytest.mark.parametrize("k", [20, 37])
@pytest.mark.parametrize("seed", [0, 1])
def test_top_k_rows_and_blocked_equal_jax_and_numpy_order(seed, k):
    w = _plateau_table(seed)
    want = _numpy_top_k(w, k)
    got = ft.top_k_rows(torch.from_numpy(w), k=k).numpy()
    ref = np.asarray(jft.top_k_rows(jnp.asarray(w), k=k))
    assert _ordered(got, w)[1:] == _ordered(ref, w)[1:] == want[1:]
    # Language 0 has 9 candidates: its other slots are -inf rows, lowest id first.
    assert _ordered(got, w)[0] == want[0]
    for block in (64, 550, 1100 // 3 + 1):
        got_b = ft.top_k_rows_blocked(torch.from_numpy(w), k=k, block=block).numpy()
        ref_b = np.asarray(jft.top_k_rows_blocked(jnp.asarray(w), k=k, block=block))
        assert _ordered(got_b, w)[1:] == _ordered(ref_b, w)[1:] == want[1:], block
        assert set(got_b[0].tolist()) >= set(np.flatnonzero(w[:, 0] > -np.inf).tolist())


@pytest.mark.parametrize("mode", [PARITY, COUNTS])
def test_finalize_topk_blocked_equals_jax_and_naive(mode):
    """The block walk (tail block sliding back) selects the naive top-k's
    rows in the same order, and the JAX walk's, among rows some language
    saw."""
    rng = np.random.default_rng(23)
    V, L, k = 700, 4, 25
    counts = rng.integers(0, 4, (V, L)).astype(np.int32)
    counts[rng.random((V, L)) < 0.7] = 0
    counts[:, 2] = 0  # a language with no occurrences
    tc = torch.from_numpy(counts)
    w = ft.masked_candidate_weights(tc, weight_mode=mode).numpy()
    occ = counts.sum(axis=1) > 0
    naive = ft.top_k_rows(torch.from_numpy(w), k=k).numpy()
    for block in (96, 350, 701):
        got = ft.finalize_topk_blocked(tc, weight_mode=mode, k=k, block=block).numpy()
        ref = np.asarray(jft.finalize_topk_blocked(jnp.asarray(counts), weight_mode=mode,
                                                    k=k, block=block))
        for lang in range(L):
            seen = [[i for i in rows[lang] if i < V and occ[i]] for rows in (got, ref, naive)]
            assert (
                sorted(seen[0], key=lambda i: (-w[i, lang], i))
                == sorted(seen[1], key=lambda i: (-w[i, lang], i))
                == sorted(seen[2], key=lambda i: (-w[i, lang], i))
            ), (block, lang)


@pytest.mark.parametrize("batch_rows", [None, 16])
def test_plan_fit_batches_equals_jax(batch_rows):
    """Items, languages, plan, straddle windows and multiplicities, on
    oversized and duplicated documents."""
    docs, langs = _corpus(5)
    for args in (SPECS["exact_n1_3"], SPECS["hashed_exact12_n1_5"]):
        spec, jspec = VocabSpec(*args), JaxVocabSpec(*args)
        got = fp.plan_fit_batches(docs, langs, spec, batch_rows=batch_rows)
        ref = jfp.plan_fit_batches(docs, langs, jspec, batch_rows=batch_rows)
        items, item_langs, plan, straddle, mult = got
        assert items == ref[0]
        np.testing.assert_array_equal(item_langs, ref[1])
        assert len(plan) == len(ref[2])
        for (sel, pad_to), (rsel, rpad) in zip(plan, ref[2]):
            np.testing.assert_array_equal(sel, rsel)
            assert pad_to == rpad
        assert straddle is not None and len(straddle[0]) > 0
        for a, b in zip(straddle, ref[3]):
            np.testing.assert_array_equal(a, b)
        assert mult is not None and mult.max() == 2
        np.testing.assert_array_equal(mult, ref[4])
        assert max(len(d) for d in items) <= MAX_BUCKET


def test_split_bounds_and_adaptive_rows_equal_jax():
    for doc_len, max_len, tail in ((10, 4, 3), (9000, 8192, 5), (16385, 8192, 5), (7, 8, 2)):
        assert fp.split_bounds(doc_len, max_len, tail) == jfp.split_bounds(doc_len, max_len, tail)
    for pad_to in DEFAULT_LENGTH_BUCKETS:
        assert fp.rows_for_fit_bucket(pad_to) == jfp.rows_for_fit_bucket(pad_to)


def test_iter_device_batches_are_pad_batch_in_plan_order():
    docs, langs = _corpus(6)
    spec = VocabSpec(*SPECS["hashed_fnv1a_n1_5"])
    items, item_langs, plan, _, mult = fp.plan_fit_batches(docs, langs, spec, batch_rows=8)
    got = list(fp.iter_device_batches(items, item_langs, plan, item_mult=mult,
                                      device=torch.device("cpu")))
    assert len(got) == len(plan)
    for (batch, lengths, blangs, bmult, rows, pad_to), (sel, want_pad) in zip(got, plan):
        want_b, want_l = pad_batch([items[i] for i in sel], want_pad)
        assert (rows, pad_to) == (len(sel), want_pad)
        np.testing.assert_array_equal(batch.numpy(), want_b)
        np.testing.assert_array_equal(lengths.numpy(), want_l)
        np.testing.assert_array_equal(blangs.numpy(), item_langs[sel])
        np.testing.assert_array_equal(bmult.numpy(), mult[sel])


@pytest.mark.parametrize("batch_rows", [None, 7])
@pytest.mark.parametrize("mode", [PARITY, COUNTS])
@pytest.mark.parametrize("name", ["exact_n1_2", "hashed_fnv1a_n1_5", "hashed_exact12_n1_5"])
def test_fit_profile_device_equals_jax_device_fit_and_host_fit(name, mode, batch_rows):
    args = SPECS[name]
    spec, jspec = VocabSpec(*args), JaxVocabSpec(*args)
    docs, langs = _corpus(7)
    host = fit_profile_numpy(docs, langs, 3, spec, 30, mode)
    got = ft.fit_profile_device(docs, langs, 3, spec, 30, mode, batch_rows=batch_rows,
                                device="cpu")
    ref = jft.fit_profile_device(docs, langs, 3, jspec, 30, mode, batch_rows=batch_rows)
    for a, b in ((got, host), (got, ref)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert got[1].dtype == np.float64 and len(got[0]) > 30


def test_fit_profile_device_blocked_finalize_route_equals_host_fit(monkeypatch):
    """The block walk of the finalize, forced by a tiny element budget and a
    small block, gives the host fit's profile."""
    spec = VocabSpec(*SPECS["exact_n1_2"])
    docs, langs = _corpus(8)
    monkeypatch.setattr(ft, "TOPK_SORT_BUDGET_ELEMS", 1)
    monkeypatch.setattr(ft, "TOPK_BLOCK", 1000)
    got = ft.fit_profile_device(docs, langs, 3, spec, 40, device="cpu")
    want = fit_profile_numpy(docs, langs, 3, spec, 40)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("mode", [PARITY, COUNTS])
def test_fit_profile_device_split_equals_jax_and_host_fit(mode):
    """Exact n = 1..5: lengths <= 3 on the device (the short documents'
    partial windows of the long classes added as extra counts), 4..5 on the
    host, merged by the joint top-k."""
    args = (EXACT, (1, 2, 3, 4, 5))
    spec, jspec = VocabSpec(*args), JaxVocabSpec(*args)
    docs, langs = _corpus(9, n_docs=40, max_len=80)
    host = fit_profile_numpy(docs, langs, 3, spec, 40, mode)
    got = ft.fit_profile_device_split(docs, langs, 3, spec, 40, mode, device="cpu")
    refs = [host]
    if mode == PARITY:  # the JAX split fit takes about 30 s on this CPU
        refs.append(jft.fit_profile_device_split(docs, langs, 3, jspec, 40, mode))
    for ref in refs:
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    assert (got[0] >= spec.offsets[4]).any() and (got[0] < spec.offsets[4]).any()


def test_estimator_device_fit_equals_host_fit_and_jax():
    """``fitBackend='device'`` through the estimator, with ``fitBatchRows``
    honoured: the profile of the host fit and of the JAX device fit; the
    split fit for exact n = 1..5."""
    rng = np.random.default_rng(12)
    langs = ["aa", "bb", "cc"]
    words = [["".join(rng.choice(list("abcdefghij"[i:i + 6]), 4)) for _ in range(20)]
             for i in range(3)]
    texts = [" ".join(rng.choice(words[i % 3], 12)) for i in range(45)] + ["", "a"]
    labels = [langs[i % 3] for i in range(47)]
    table, jtable = Table({"lang": labels, "fulltext": texts}), JaxTable(
        {"lang": labels, "fulltext": texts})
    for grams, vocab in (([1, 2, 3], "exact"), ([1, 2, 3, 4, 5], "hashed"),
                         ([1, 2, 3, 4, 5], "exact")):
        det = (LanguageDetector(langs, grams, 25, device="cpu").set_vocab_mode(vocab)
               .set_hash_bits(14))
        host = det.fit(table)
        dev = det.copy({"fitBackend": "device", "fitBatchRows": 5}).fit(table)
        jdev = (JaxDetector(langs, grams, 25).set_vocab_mode(vocab).set_hash_bits(14)
                .set_fit_backend("device").fit(jtable))
        for other in (host, jdev):
            np.testing.assert_array_equal(dev.profile.ids, other.profile.ids)
            np.testing.assert_array_equal(dev.profile.weights, other.profile.weights)
        probe = Table({"fulltext": ["abcd abce", "ghij", ""]})
        assert (dev.transform(probe).column("lang").tolist()
                == host.transform(probe).column("lang").tolist())


def test_device_fit_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = VocabSpec(EXACT, (1,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.fit_profile_device([b"ab"], [0], 1, spec, 5)
