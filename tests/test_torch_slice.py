"""The slice end to end on the CPU: fit → transform in both packages.

A small synthetic corpus (six languages, numpy seed) goes through the JAX
``LanguageDetector(...).fit(...).transform(...)`` and the port's, with the
port on ``device="cpu"`` (the fused kernel's plain version). Profiles must be
bit-identical and labels identical; a JAX-fitted profile carried across with
``convert`` must label identically; a document longer than the largest
length bucket is chunked and must label identically; an int16 model must
label like the f32 ones.
"""

import functools
import json

import numpy as np
import pytest

from spark_languagedetector_tpu import LanguageDetector as JaxDetector
from spark_languagedetector_tpu import Table as JaxTable
from spark_languagedetector_tpu.api.runner import BatchRunner as JaxRunner
from spark_languagedetector_tpu_torch import LanguageDetector, Table
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.convert import model_from_arrays
from spark_languagedetector_tpu_torch.ops.score import score_batch_numpy

LANGS = ["aa", "bb", "cc", "dd", "ee", "ff"]
CONFIGS = {
    "exact_n1_3": dict(grams=[1, 2, 3], vocab="exact", bits=20),
    "hashed_exact12_n1_5": dict(grams=[1, 2, 3, 4, 5], vocab="hashed", bits=18),
}


def _words(lang_i, rng):
    # Each language draws words from its own 9 letters; neighbours share
    # three letters, so short documents can be ambiguous.
    letters = list("abcdefghijklmnopqrstuvwxyzäöü")[3 * lang_i : 3 * lang_i + 9]
    return ["".join(rng.choice(letters, int(rng.integers(2, 7)))) for _ in range(30)]


def _corpus(n_per_lang, seed, mean_words=25):
    rng = np.random.default_rng(seed)
    vocab = [_words(i, np.random.default_rng(100 + i)) for i in range(len(LANGS))]
    texts, labels = [], []
    for k in range(n_per_lang * len(LANGS)):
        i = k % len(LANGS)
        n = max(1, int(rng.normal(mean_words, mean_words / 3)))
        texts.append(" ".join(rng.choice(vocab[i], n)))
        labels.append(LANGS[i])
    return texts, labels


@functools.lru_cache(maxsize=None)
def _fitted(name):
    cfg = CONFIGS[name]
    texts, labels = _corpus(20, seed=1)
    jax_model = (
        JaxDetector(LANGS, cfg["grams"], 60)
        .set_vocab_mode(cfg["vocab"]).set_hash_bits(cfg["bits"])
        .fit(JaxTable({"lang": labels, "fulltext": texts}))
    )
    model = (
        LanguageDetector(LANGS, cfg["grams"], 60, device="cpu")
        .set_vocab_mode(cfg["vocab"]).set_hash_bits(cfg["bits"])
        .fit(Table({"lang": labels, "fulltext": texts}))
    )
    return jax_model, model


def _eval_texts():
    texts, _ = _corpus(8, seed=2, mean_words=6)
    return texts + ["", "a", "zz", "qqqqqq", "äöü"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_transform_matches_jax(name):
    jax_model, model = _fitted(name)
    np.testing.assert_array_equal(model.profile.ids, jax_model.profile.ids)
    np.testing.assert_array_equal(model.profile.weights, jax_model.profile.weights)
    assert model.profile.spec.hash_scheme == jax_model.profile.spec.hash_scheme
    texts = _eval_texts()
    got = model.transform(Table({"fulltext": texts})).column("lang").tolist()
    ref = jax_model.transform(JaxTable({"fulltext": texts})).column("lang").tolist()
    assert model.runner.strategy == "fused"
    assert got == ref
    assert model.detect(texts[0]) == ref[0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converted_jax_model_labels_identically(name):
    jax_model, _ = _fitted(name)
    p = jax_model.profile
    model = model_from_arrays(
        p.spec.mode, p.spec.gram_lengths, p.spec.hash_bits, p.spec.hash_scheme,
        p.languages, p.ids, p.weights, device="cpu",
    )
    texts = _eval_texts()
    got = model.transform(Table({"fulltext": texts})).column("lang").tolist()
    ref = jax_model.transform(JaxTable({"fulltext": texts})).column("lang").tolist()
    assert got == ref


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chunked_long_document_labels_identically(name):
    """A 2KB document over (128, 256) buckets splits into chunks whose score
    rows sum before the argmax; labels and scores match the JAX runner."""
    jax_model, model = _fitted(name)
    texts = _eval_texts()[:10]
    long_doc = " ".join(texts * 8)
    docs = [t.encode() for t in texts] + [long_doc.encode(), long_doc[:300].encode()]
    w, lut = model.profile.host_membership()
    runner = BatchRunner(
        weights=w, lut=lut, spec=model.profile.spec, device="cpu",
        length_buckets=(128, 256),
    )
    jw, jlut = jax_model.profile.device_arrays()
    jrunner = JaxRunner(
        weights=jw, lut=jlut, spec=jax_model.profile.spec, strategy="gather",
        length_buckets=(128, 256),
    )
    assert len(docs[-2]) > runner.max_chunk
    np.testing.assert_array_equal(runner.predict_ids(docs), jrunner.predict_ids(docs))
    np.testing.assert_allclose(
        runner.score(docs), jrunner.score(docs), atol=1e-4, rtol=1e-5
    )
    host_w, sorted_ids = model.profile.host_arrays()
    oracle = score_batch_numpy(docs, host_w, sorted_ids, model.profile.spec)
    np.testing.assert_allclose(runner.score(docs), oracle, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_int16_model_labels_identically(name):
    jax_model, model = _fitted(name)
    texts = _eval_texts()
    ref = jax_model.transform(JaxTable({"fulltext": texts})).column("lang").tolist()
    q = model.copy({"quantization": "int16"})
    assert q.runner.layout.quant == "int16"
    assert q.transform(Table({"fulltext": texts})).column("lang").tolist() == ref


def test_estimator_keeps_reference_validation_messages():
    det = LanguageDetector(["aa", "bb"], [1, 2], 10, device="cpu")
    with pytest.raises(ValueError, match="Input data contians cc, but it is not in the list"):
        det.fit(Table({"lang": ["aa", "cc"], "fulltext": ["x", "y"]}))
    with pytest.raises(ValueError, match="No training examples found for language bb"):
        det.fit(Table({"lang": ["aa"], "fulltext": ["x"]}))
    # The device fit is in the port now: on the CPU it gives the host fit's profile.
    small = Table({"lang": ["aa", "bb"], "fulltext": ["x", "y"]})
    dev_model = det.copy({"fitBackend": "device"}).fit(small)
    host_model = det.fit(small)
    np.testing.assert_array_equal(dev_model.profile.ids, host_model.profile.ids)
    np.testing.assert_array_equal(dev_model.profile.weights, host_model.profile.weights)
    model = det.fit(Table({"lang": ["aa", "bb"], "fulltext": ["xy", "yz"]}))
    # Segment mode is in the port now: the output column carries JSON.
    seg = model.copy({"resultMode": "segment"}).transform(Table({"fulltext": ["x"]}))
    assert json.loads(seg.column("lang")[0])["spans"][0]["end"] == 1
    with pytest.raises(TypeError, match="Input type must be string"):
        model.transform(Table({"fulltext": np.asarray([1, 2])}))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_device_membership_and_quantization_match_jax(name):
    """The profile's device form (dense table or LUT + compact rows) and its
    quantized tables are the JAX package's, bit for bit."""
    from spark_languagedetector_tpu.models.profile import quantize_weights as jq
    from spark_languagedetector_tpu_torch.models.profile import quantize_weights as tq

    jax_model, model = _fitted(name)
    w, lut, cuckoo = model.profile.device_membership(device="cpu")
    jw, jlut = jax_model.profile.device_arrays()
    assert cuckoo is None and (lut is None) == (jlut is None)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    if lut is not None:
        np.testing.assert_array_equal(lut.numpy(), np.asarray(jlut))
    for dtype in ("int8", "int16"):
        q, s = tq(w.numpy(), dtype)
        jqq, js = jq(np.asarray(jw), dtype)
        np.testing.assert_array_equal(q, jqq)
        np.testing.assert_array_equal(s, js)


# --- exact n = 1..5: cuckoo membership through the hybrid strategy --------

_LETTERS = list("abcdefghijklmnopqrstuvwxyzàáâãäåæçèéêëìíîïðñòóôõöøùúûüýþÿ") + list(
    "αβγδεζηθικλμνξοπρστυφχψω"
)


def _corpus_n(n_langs, n_per_lang, seed, mean_words=25):
    """Like ``_corpus`` for up to 20 languages (letters from a wider
    alphabet, neighbours sharing three)."""
    rng = np.random.default_rng(seed)
    vocab = []
    for i in range(n_langs):
        wr = np.random.default_rng(200 + i)
        letters = _LETTERS[3 * i : 3 * i + 9]
        vocab.append(["".join(wr.choice(letters, int(wr.integers(2, 7)))) for _ in range(30)])
    langs = [f"l{i:02d}" for i in range(n_langs)]
    texts, labels = [], []
    for k in range(n_per_lang * n_langs):
        i = k % n_langs
        n = max(1, int(rng.normal(mean_words, mean_words / 3)))
        texts.append(" ".join(rng.choice(vocab[i], n)))
        labels.append(langs[i])
    return langs, texts, labels


@functools.lru_cache(maxsize=None)
def _fitted_exact5(n_langs):
    langs, texts, labels = _corpus_n(n_langs, 12, seed=1)
    table = {"lang": labels, "fulltext": texts}
    jax_model = (
        JaxDetector(langs, [1, 2, 3, 4, 5], 60).set_vocab_mode("exact").fit(JaxTable(table))
    )
    model = (
        LanguageDetector(langs, [1, 2, 3, 4, 5], 60, device="cpu")
        .set_vocab_mode("exact").fit(Table(table))
    )
    return langs, jax_model, model


def _eval_exact5(n_langs):
    _, texts, _ = _corpus_n(n_langs, 4, seed=2, mean_words=6)
    return texts + ["", "a", "zz", "qqqq", "äöü", "\x01\x02\x03\x04\x05"]


@pytest.mark.parametrize("n_langs", [6, 20])
def test_exact_n1_5_fit_transform_matches_jax(n_langs):
    """Exact n = 1..5 fits bit-identically, auto picks hybrid (bigram
    kernels for n <= 2 — the score kernel at 6 languages, the histogram at
    20 — and the row histogram for n = 3..5), and labels equal the JAX
    package's; scores are in the reduction-order class."""
    langs, jax_model, model = _fitted_exact5(n_langs)
    np.testing.assert_array_equal(model.profile.ids, jax_model.profile.ids)
    np.testing.assert_array_equal(model.profile.weights, jax_model.profile.weights)
    texts = _eval_exact5(n_langs)
    got = model.transform(Table({"fulltext": texts})).column("lang").tolist()
    ref = jax_model.transform(JaxTable({"fulltext": texts})).column("lang").tolist()
    runner = model.runner
    assert runner.strategy == "hybrid" and runner.hist_state is not None
    assert runner.pallas_state.rest == (3, 4, 5)
    assert got == ref
    assert got[-6] == got[-1] == langs[0]  # empty and all-miss label 0
    docs = [t.encode() for t in texts]
    np.testing.assert_allclose(
        runner.score(docs), jax_model._get_runner().score(docs), atol=1e-4, rtol=1e-5
    )
    host_w, sorted_ids = model.profile.host_arrays()
    oracle = score_batch_numpy(docs, host_w, sorted_ids, model.profile.spec)
    np.testing.assert_allclose(runner.score(docs), oracle, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("strategy", ["hybrid", "hist", "gather"])
def test_exact_n1_5_chunked_document_labels_identically(strategy):
    """A long document over (128, 256) buckets is chunked; every strategy
    of a cuckoo profile sums the chunks' scores exactly like the JAX
    gather runner."""
    _, jax_model, model = _fitted_exact5(6)
    texts = _eval_exact5(6)[:10]
    long_doc = " ".join(texts * 8)
    docs = [t.encode() for t in texts] + [long_doc.encode(), long_doc[:300].encode()]
    w, lut, cuckoo = model.profile.device_membership(device="cpu")
    assert lut is None and cuckoo is not None
    runner = BatchRunner(
        weights=w, lut=lut, cuckoo=cuckoo, spec=model.profile.spec, device="cpu",
        length_buckets=(128, 256), strategy=strategy,
    )
    jw, jlut, jcuckoo = jax_model.profile.device_membership()
    jrunner = JaxRunner(
        weights=jw, lut=jlut, cuckoo=jcuckoo, spec=jax_model.profile.spec,
        strategy="gather", length_buckets=(128, 256),
    )
    assert len(docs[-2]) > runner.max_chunk
    np.testing.assert_array_equal(runner.predict_ids(docs), jrunner.predict_ids(docs))
    np.testing.assert_allclose(
        runner.score(docs), jrunner.score(docs), atol=1e-4, rtol=1e-5
    )


def test_exact_n1_5_converted_jax_model_builds_the_same_tables():
    """A JAX-fitted exact n = 1..5 profile crosses over; its port runner
    holds the JAX runner's cuckoo table, bucket table and dense n <= 2
    sub-table bit for bit, and labels identically."""
    _, jax_model, _ = _fitted_exact5(6)
    p = jax_model.profile
    model = model_from_arrays(
        p.spec.mode, p.spec.gram_lengths, p.spec.hash_bits, p.spec.hash_scheme,
        p.languages, p.ids, p.weights, device="cpu",
    )
    texts = _eval_exact5(6)
    got = model.transform(Table({"fulltext": texts})).column("lang").tolist()
    ref = jax_model.transform(JaxTable({"fulltext": texts})).column("lang").tolist()
    assert got == ref
    jw, _, jcuckoo = p.device_membership()
    jrunner = JaxRunner(weights=jw, lut=None, cuckoo=jcuckoo, spec=p.spec, strategy="hybrid")
    runner = model.runner
    np.testing.assert_array_equal(runner.cuckoo.slots, jcuckoo.slots)
    assert (runner.cuckoo.seed1, runner.cuckoo.seed2) == (jcuckoo.seed1, jcuckoo.seed2)
    wp, rhi, _, bucket, seed, kind = jrunner._hist_state()
    h = runner.hist_state
    assert (h.rhi, h.seed, h.kind) == (rhi, seed, kind)
    np.testing.assert_array_equal(h.bucket.numpy(), np.asarray(bucket))
    np.testing.assert_array_equal(h.weights_pad.numpy(), np.asarray(wp))
    _, _, w1, w2, rest = jrunner._hybrid_state()
    st = runner.pallas_state
    assert st.rest == rest
    np.testing.assert_array_equal(st.w1.numpy(), np.asarray(w1))
    # L <= 16: the JAX view is [L, 256, 256]; the port's is [65536, L].
    np.testing.assert_array_equal(
        st.w2.numpy(), np.asarray(w2).transpose(1, 2, 0).reshape(65536, -1)
    )
