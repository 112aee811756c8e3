"""Segment mode end to end on the CPU: the port against the JAX package.

* ``BatchRunner.segment_cells``: per-document cell arrays of the port's
  fused, gather and hybrid (cuckoo) runners against the JAX runner's on the
  same profile and documents (the JAX fused runner runs its Pallas kernel in
  interpret mode), and against the float64 host oracle. ``atol=1e-3`` per
  cell, the JAX package's own fused-vs-gather tolerance (sums in another
  order).
* ``segment/``: the port's numpy copies of the span decoder, the top-k
  decode and the calibration give the JAX package's results exactly.
* The slice as a whole: a JAX-fitted, JAX-calibrated model carried across by
  ``convert``; ``transform`` in segment mode on code-switched documents
  (``bench.make_codeswitch_corpus``) gives the JAX model's JSON: spans'
  ``start``/``end``/``lang`` and every other key exactly, ``confidence`` and
  ``prob`` within ``1e-4`` (the JAX model on the CPU scores cells with its
  gather program, the port with the fused kernel's plain version: another
  f32 summation order, which can move a six-decimal probability's last
  digit).
"""

import functools
import json

import numpy as np
import pytest

from spark_languagedetector_tpu import LanguageDetector as JaxDetector
from spark_languagedetector_tpu import Table as JaxTable
from spark_languagedetector_tpu.api.runner import SEGMENT_CELL as JAX_SEGMENT_CELL
from spark_languagedetector_tpu.api.runner import BatchRunner as JaxRunner
from spark_languagedetector_tpu.segment import SegmentOptions as JaxSegmentOptions
from spark_languagedetector_tpu.segment import calibrate as jax_calibrate
from spark_languagedetector_tpu.segment import spans as jax_spans
from spark_languagedetector_tpu.segment import topk as jax_topk
from spark_languagedetector_tpu_torch import Table
from spark_languagedetector_tpu_torch.api.runner import SEGMENT_CELL, BatchRunner
from spark_languagedetector_tpu_torch.convert import model_from_arrays
from spark_languagedetector_tpu_torch.ops.score import window_scores_numpy
from spark_languagedetector_tpu_torch.segment import (
    UNKNOWN,
    Calibration,
    SegmentOptions,
    segment_documents,
)
from spark_languagedetector_tpu_torch.segment import calibrate, spans, topk

LANGS = ("en", "de", "fr", "es")
ATOL = 1e-3
CONFIGS = {
    # name -> (gram lengths, vocab mode, hash bits, the port's auto strategy)
    "exact_n1_3": ((1, 2, 3), "exact", 20, "fused"),
    "hashed_exact12_n1_5": ((1, 2, 3, 4, 5), "hashed", 16, "fused"),
    "exact_cuckoo_n1_5": ((1, 2, 3, 4, 5), "exact", 20, "hybrid"),
}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX model, the same profile in the port), JAX-fitted and calibrated
    on a held-out table; the calibration crosses as its plain dict."""
    import bench

    grams, vocab, bits, _ = CONFIGS[name]
    docs, labels = bench.make_corpus(list(LANGS), 48, mean_len=300, seed=3)
    jax_model = (
        JaxDetector(list(LANGS), list(grams), 200)
        .set_vocab_mode(vocab).set_hash_bits(bits)
        .fit(JaxTable({"lang": labels, "fulltext": docs}))
    )
    held, held_labels = _heldout()
    jax_model.calibrate(JaxTable({"fulltext": held, "lang": held_labels}))
    p = jax_model.profile
    model = model_from_arrays(
        p.spec.mode, p.spec.gram_lengths, p.spec.hash_bits, p.spec.hash_scheme,
        p.languages, p.ids, p.weights, device="cpu",
        calibration=jax_model.calibration.to_dict(),
    )
    return jax_model, model


@functools.lru_cache(maxsize=None)
def _heldout():
    import bench

    return bench.make_corpus(list(LANGS), 60, mean_len=250, seed=77)


def _parity_docs(long_bytes):
    import bench

    docs, _ = bench.make_corpus(list(LANGS), 8, mean_len=300, seed=21)
    rng = np.random.default_rng(7)
    return [d.encode() for d in docs] + [
        b"", b"a", "köln 京都".encode(), "é".encode(),
        bytes(rng.integers(0, 256, 700).tolist()),
        (" ".join(docs) * 4).encode()[:long_bytes],  # chunked
    ]


def _port_runner(model, strategy, **kw):
    w, lut, cuckoo = model.profile.device_membership(device="cpu")
    return BatchRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=model.profile.spec,
                       device="cpu", strategy=strategy, **kw)


def _jax_runner(jax_model, strategy, **kw):
    w, lut, cuckoo = jax_model.profile.device_membership()
    return JaxRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=jax_model.profile.spec,
                     strategy=strategy, **kw)


def _check_cells(got, ref, docs, cell, n_langs):
    assert len(got) == len(ref) == len(docs)
    for g, r, d in zip(got, ref, docs):
        assert g.shape == (max(1, -(-len(d) // cell)), n_langs) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(r), atol=ATOL)


# ------------------------------------------------- runner.segment_cells ----


def test_segment_cell_default_is_the_jax_default():
    assert SEGMENT_CELL == JAX_SEGMENT_CELL == 256


@pytest.mark.parametrize("name", ["exact_n1_3", "hashed_exact12_n1_5"])
def test_segment_cells_fused_runner_matches_jax_fused_runner(name):
    """Both fused runners, the JAX one in interpret mode; narrow length
    buckets keep the interpreted kernel small, and a 2,500-byte document
    chunks on the cell-aligned stride of 768 under the 1,024 bucket."""
    jax_model, model = _models(name)
    buckets = (256, 512, 1024)
    runner = _port_runner(model, "fused", length_buckets=buckets)
    jrunner = _jax_runner(jax_model, "fused", length_buckets=buckets)
    assert runner.strategy == jrunner.strategy == "fused"
    docs = _parity_docs(2500)
    assert len(docs[-1]) > runner.max_chunk
    cells, scored = runner.segment_cells(docs)
    jcells, jscored = jrunner.segment_cells(docs)
    assert scored == jscored == docs
    _check_cells(cells, jcells, docs, SEGMENT_CELL, len(LANGS))
    # Summing a document's cells restores its whole-document score.
    np.testing.assert_allclose(
        np.stack([c.sum(axis=0) for c in cells]), runner.score(docs), rtol=1e-4, atol=1e-2
    )


@pytest.mark.parametrize("cell", [SEGMENT_CELL, 512])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_segment_cells_auto_and_gather_match_jax_gather_and_host_oracle(name, cell):
    """The port's auto strategy (fused, or hybrid for the cuckoo profile,
    whose segment requests ride the gather cell scorer) and its explicit
    gather against the JAX gather runner and the float64 oracle, with a
    9,000-byte document that chunks under the default buckets."""
    jax_model, model = _models(name)
    runner = model.runner
    assert runner.strategy == CONFIGS[name][3]
    docs = _parity_docs(9000)
    assert len(docs[-1]) > runner.max_chunk
    jcells, _ = _jax_runner(jax_model, "gather").segment_cells(docs, cell=cell)
    w, sorted_ids = model.profile.host_arrays()
    oracle = window_scores_numpy(docs, w, sorted_ids, model.profile.spec, cell)
    for r in (runner, _port_runner(model, "gather")):
        cells, scored = r.segment_cells(docs, cell=cell)
        assert scored == docs
        _check_cells(cells, jcells, docs, cell, len(LANGS))
        _check_cells(cells, oracle, docs, cell, len(LANGS))
        assert not cells[len(docs) - 6].any()  # the empty document: one zero cell


def test_segment_cells_validation_messages_are_the_jax_runner_s():
    jax_model, model = _models("exact_n1_3")
    runner = _port_runner(model, "gather")
    jrunner = _jax_runner(jax_model, "gather")
    tight = _port_runner(model, "gather", length_buckets=(256,))
    jtight = _jax_runner(jax_model, "gather", length_buckets=(256,))
    for mine, theirs, kw, docs in (
        (runner, jrunner, {"cell": 200}, [b"x"]),
        (runner, jrunner, {"cell": runner.max_chunk * 2}, [b"x"]),
        (tight, jtight, {}, [b"x" * 300]),
    ):
        with pytest.raises(ValueError) as e_mine:
            mine.segment_cells(docs, **kw)
        with pytest.raises(ValueError) as e_theirs:
            theirs.segment_cells(docs, **kw)
        assert str(e_mine.value) == str(e_theirs.value)
    with pytest.raises(ValueError, match="needs chunking"):
        tight.segment_cells([b"x" * 300])
    # A runner whose largest bucket equals the cell width has no cell-aligned
    # chunk stride; documents that fit in one chunk still segment.
    tight_cells, _ = tight.segment_cells([b"abab", b"z" * 256])
    assert [c.shape for c in tight_cells] == [(1, len(LANGS))] * 2
    np.testing.assert_allclose(
        tight_cells[0], runner.segment_cells([b"abab"])[0][0], atol=ATOL
    )
    assert runner.segment_cells([]) == ([], [])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_doc_scores_identical_around_segment_traffic(name):
    _, model = _models(name)
    runner = _port_runner(model, "auto")
    docs = _parity_docs(9000)
    before, ids_before = runner.score(docs), runner.predict_ids(docs)
    runner.segment_cells(docs)
    segment_documents(runner, docs, LANGS)
    np.testing.assert_array_equal(runner.score(docs), before)
    np.testing.assert_array_equal(runner.predict_ids(docs), ids_before)


def test_segment_cells_describe_the_truncated_documents():
    jax_model, model = _models("exact_n1_3")
    runner = _port_runner(model, "fused", max_score_bytes=300)
    jrunner = _jax_runner(jax_model, "gather", max_score_bytes=300)
    docs = ["é".encode() * 400, b"abc" * 300, b"short"]
    cells, scored = runner.segment_cells(docs)
    jcells, jscored = jrunner.segment_cells(docs)
    assert scored == jscored and [len(d) for d in scored] == [300, 300, 5]
    _check_cells(cells, jcells, scored, SEGMENT_CELL, len(LANGS))


# ------------------------------------------------- segment/ (host decode) --


@pytest.mark.parametrize("seed", range(6))
def test_span_decode_matches_jax_package(seed):
    rng = np.random.default_rng(seed)
    n_cells, L, cell = int(rng.integers(1, 14)), 5, 256
    cells = rng.normal(size=(n_cells, L)).astype(np.float32)
    cells[rng.integers(0, n_cells)] = 0.0  # a tie: first maximum wins
    doc = ("añb€" * 400).encode()[: n_cells * cell - int(rng.integers(0, cell))]
    for width in (1, 3, 5):
        sm, jsm = spans.smooth_cells(cells, width), jax_spans.smooth_cells(cells, width)
        np.testing.assert_array_equal(sm, jsm)
        (w, m), (jw, jm) = spans.decode_cells(sm), jax_spans.decode_cells(jsm)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(m, jm)
        for min_span in (1, 16, 300):
            kw = dict(cell=cell, doc_len=len(doc), doc=doc, min_span_bytes=min_span)
            got = spans.merge_spans(w, m, **kw)
            ref = jax_spans.merge_spans(jw, jm, **kw)
            assert [(s.start, s.end, s.lang_id, s.margin) for s in got] == [
                (s.start, s.end, s.lang_id, s.margin) for s in ref
            ]
            assert got[0].start == 0 and got[-1].end == len(doc)


@pytest.mark.parametrize("threshold", [0.0, 0.5, 0.99])
def test_topk_decode_matches_jax_package(threshold):
    rng = np.random.default_rng(5)
    p = rng.dirichlet(np.ones(6))
    p[2] = p[4]  # a tie keeps ascending index order
    names = [f"l{i}" for i in range(6)]
    for k in (1, 3, 9):
        assert topk.topk_decode(p, names, k, threshold) == jax_topk.topk_decode(
            p, names, k, threshold
        )
    assert topk.UNKNOWN == jax_topk.UNKNOWN == UNKNOWN
    with pytest.raises(ValueError, match="disagrees"):
        topk.topk_decode(p, names[:3], 1, 0.0)


def test_calibration_fit_and_codec_match_jax_package():
    rng = np.random.default_rng(9)
    y = rng.integers(0, 4, 80)
    s = rng.normal(size=(80, 4)) * 0.05
    s[np.arange(80), y] += 0.08
    got = calibrate.fit_calibration(s, y, 4)
    ref = jax_calibrate.fit_calibration(s, y, 4)
    np.testing.assert_array_equal(got.temperatures, ref.temperatures)
    assert got.meta == ref.meta and got.version == ref.version and got.calibrated
    assert got.to_dict() == ref.to_dict()
    back = Calibration.from_dict(json.loads(json.dumps(ref.to_dict())))
    np.testing.assert_array_equal(back.temperatures, ref.temperatures)
    state = ref.to_dict()
    state["temperatures"][0] *= 2
    with pytest.raises(ValueError, match="does not match"):
        Calibration.from_dict(state)
    ident = Calibration.identity(4)
    assert not ident.calibrated and ident.version == jax_calibrate.Calibration.identity(4).version
    with pytest.raises(ValueError, match="non-empty"):
        calibrate.fit_calibration(s[:0], y[:0], 4)
    np.testing.assert_array_equal(
        calibrate.calibrated_probs(calibrate.normalize_scores(s, y + 1), got.temperatures),
        jax_calibrate.calibrated_probs(jax_calibrate.normalize_scores(s, y + 1), ref.temperatures),
    )


def test_segment_options_validation_and_key_match_jax_package():
    for bad in (dict(cell=200), dict(cell=0), dict(smooth=0), dict(top_k=0),
                dict(reject_threshold=1.0), dict(min_span_bytes=0)):
        with pytest.raises(ValueError) as mine:
            SegmentOptions(**bad)
        with pytest.raises(ValueError) as theirs:
            JaxSegmentOptions(**bad)
        assert str(mine.value) == str(theirs.value)
    for kw in ({}, dict(cell=512, smooth=5), dict(top_k=1, reject_threshold=0.25,
                                                  min_span_bytes=4)):
        assert SegmentOptions(**kw).key() == JaxSegmentOptions(**kw).key()


# ------------------------------------------------- the slice as a whole ----


def _assert_results_match(got, ref):
    """Result dicts key for key: everything exact except the six-decimal
    probabilities, held within 1e-4 (see the module docstring)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"label", "rejected", "calibrated", "topk", "spans"}
        assert (g["label"], g["rejected"], g["calibrated"]) == (
            r["label"], r["rejected"], r["calibrated"])
        assert [(s["start"], s["end"], s["lang"]) for s in g["spans"]] == [
            (s["start"], s["end"], s["lang"]) for s in r["spans"]]
        assert [e["lang"] for e in g["topk"]] == [e["lang"] for e in r["topk"]]
        np.testing.assert_allclose([s["confidence"] for s in g["spans"]],
                                   [s["confidence"] for s in r["spans"]], atol=1e-4)
        np.testing.assert_allclose([e["prob"] for e in g["topk"]],
                                   [e["prob"] for e in r["topk"]], atol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_segment_mode_transform_matches_jax_model(name):
    import bench

    jax_model, model = _models(name)
    texts, truth = bench.make_codeswitch_corpus(list(LANGS), 10, seed=31)
    texts += ["", "a", "köln 京都", "the quick brown fox"]
    seg = model.copy({"resultMode": "segment", "topK": 2})
    jseg = jax_model.copy().set_result_mode("segment").set_top_k(2)
    jseg.calibration = jax_model.calibration
    assert seg.calibration is not None
    out = seg.transform(Table({"fulltext": texts})).column("lang").tolist()
    ref = jseg.transform(JaxTable({"fulltext": texts})).column("lang").tolist()
    parsed = [json.loads(v) for v in out]
    _assert_results_match(parsed, [json.loads(v) for v in ref])
    # Canonical JSON, one object per row; the model's other entry points
    # decode the same results.
    assert out == [json.dumps(r, sort_keys=True) for r in parsed]
    assert parsed == seg.segment(texts)
    assert all(len(r["topk"]) == 2 and r["calibrated"] for r in parsed)
    assert seg.detect(texts[0]) == parsed[0]
    assert model.detect(texts[-1]) in LANGS  # label mode still answers a label
    # The code-switched documents really decode into several spans.
    assert sum(len(r["spans"]) for r in parsed[: len(truth)]) > len(truth)
    assert parsed[len(truth)]["spans"] == []  # the empty document


@pytest.mark.parametrize("name", list(CONFIGS))
def test_calibrate_matches_jax_model(name):
    jax_model, model = _models(name)
    held, held_labels = _heldout()
    fresh = model.copy()
    fresh.calibration = None
    uncal = fresh.segment(["the quick brown fox"])[0]
    assert uncal["calibrated"] is False
    assert fresh.calibrate(Table({"fulltext": held, "lang": held_labels})) is fresh
    np.testing.assert_allclose(
        fresh.calibration.temperatures, jax_model.calibration.temperatures, atol=1e-6
    )
    assert fresh.calibration.meta["heldout_docs"] == len(held)
    assert fresh.segment(["the quick brown fox"])[0]["calibrated"] is True
    with pytest.raises(ValueError, match="not in supportedLanguages"):
        fresh.calibrate(Table({"fulltext": ["x"], "lang": ["xx"]}))


def test_reject_threshold_and_language_mismatch():
    _, model = _models("exact_n1_3")
    doc = ["the quick brown fox jumps over the lazy dog"]
    fresh = model.copy({"rejectThreshold": 0.9})
    fresh.calibration = None  # uncalibrated 4-language probabilities sit near 1/4
    rej = fresh.segment(doc)[0]
    assert rej["label"] == UNKNOWN and rej["rejected"] and len(rej["topk"]) == 3
    assert all(s["lang"] == UNKNOWN for s in rej["spans"])
    with pytest.raises(ValueError, match="language names"):
        segment_documents(model.runner, [b"x"], ["only-one"])
    with pytest.raises(ValueError, match="calibration covers"):
        segment_documents(model.runner, [b"x"], LANGS, calibration=Calibration.identity(2))
