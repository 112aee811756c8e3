"""The port's stage spans around ``transform`` and the device fit, on the CPU.

A ``transform`` call records ``transform/encode``, ``runner/prepare``,
``score``, ``runner/finish`` and ``transform/result`` once each, in that
order and under one trace id; none of them encloses ``score``, whose path
stays ``"score"``. A device fit records ``fit/encode``, ``fit/plan``,
``fit/winners``, ``fit/collect/copy``, ``fit/collect/weigh`` and
``fit/profile`` once each. An exported span's ``ts - wall_s`` is the
host's wall clock at the span's start, fence wait or not.
"""

import time

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu_torch import LanguageDetector, LanguageDetectorModel, Table
from spark_languagedetector_tpu_torch.telemetry import REGISTRY, Registry, span, spans

TRANSFORM_STAGES = ["transform/encode", "runner/prepare", "score", "runner/finish",
                    "transform/result"]
FIT_STAGES = ["fit/encode", "fit/plan", "fit/winners", "fit/collect/copy",
              "fit/collect/weigh", "fit/profile"]
GRAMS = {b"ab": [1.0, 0.0], b"xy": [0.0, 1.0]}


class ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event):
        if event.get("event") == "telemetry.span":
            self.events.append(event)


@pytest.fixture
def sink():
    got = ListSink()
    REGISTRY.add_sink(got)
    try:
        yield got
    finally:
        REGISTRY.remove_sink(got)


def _model():
    # Small batches, so one call plans several: the stages stay one per call.
    return LanguageDetectorModel.from_gram_map(GRAMS, [2], ["a", "x"], device="cpu") \
        .set_batch_size(4)


def _docs():
    """Distinct short documents, repeats (the dedup's scatter-back) and one
    document longer than the largest bucket (the chunked argmax)."""
    docs = [("ab" * (i + 1)) if i % 2 else ("xy" * (i + 1)) for i in range(13)]
    return docs + docs[:5] + ["xy" * 5000]


def test_transform_records_each_stage_once_per_call_beside_score(sink):
    model, docs = _model(), _docs()
    want = ["a" if i % 2 else "x" for i in range(13)]
    want = want + want[:5] + ["x"]
    for _ in range(2):
        assert model.transform(Table({"fulltext": docs})).column("lang").tolist() == want
    got = [e["path"] for e in sink.events]
    first = sink.events[: got.index("transform/encode", 1)]
    paths = [e["path"] for e in first if e["path"] in TRANSFORM_STAGES]
    assert paths == TRANSFORM_STAGES
    # The per-batch spans nest under score; no stage is repeated per batch.
    assert sum(e["path"] == "score/pack" for e in first) > 1
    assert len({e["trace_id"] for e in first}) == 1 and first[0]["trace_id"]
    for stage in TRANSFORM_STAGES:
        assert got.count(stage) == 2, stage
    assert not any(p.startswith("transform/score") for p in got)


def test_runner_alone_records_prepare_score_finish_under_one_trace(sink):
    runner = _model().runner
    ids = runner.predict_ids([b"abab", b"xyxy", b"abab"])
    assert ids.tolist() == [0, 1, 0]
    assert runner.predict([b"abab", b"xyxy"], ["a", "x"]) == ["a", "x"]
    first = [e for e in sink.events if e["path"] in TRANSFORM_STAGES][:3]
    assert [e["path"] for e in first] == ["runner/prepare", "score", "runner/finish"]
    assert first[0]["docs"] == 3 and first[0]["unique"] == 2
    assert len({e["trace_id"] for e in first}) == 1


def test_transform_stages_merge_under_an_ambient_stream_span(sink):
    REGISTRY.reset()
    with span("stream/transform"):
        _model().transform(Table({"fulltext": ["abab", "xyxy"]}))
    paths = [e["path"] for e in sink.events]
    assert [p for p in paths if not p.startswith("stream/transform/score/")] == [
        "stream/transform/encode", "stream/transform/runner/prepare",
        "stream/transform/score", "stream/transform/runner/finish",
        "stream/transform/result", "stream/transform",
    ]
    assert "transform" not in REGISTRY.stage_summary()


def _fit_rows():
    return {
        "lang": ["de"] * 4 + ["en"] * 4,
        "fulltext": [
            "der schnelle braune fuchs", "das ist ja sehr schön",
            "noch ein deutscher satz", "wo ist der bahnhof bitte",
            "the quick brown fox", "that is very nice",
            "one more english sentence", "where is the station please",
        ],
    }


def test_device_fit_records_each_stage_once_and_the_same_profile():
    det = LanguageDetector(["de", "en"], [1, 2], 30, device="cpu").set_fit_backend("device")
    plain = det.fit(Table(_fit_rows())).profile
    got = ListSink()
    REGISTRY.add_sink(got)
    try:
        traced = det.fit(Table(_fit_rows())).profile
    finally:
        REGISTRY.remove_sink(got)
    np.testing.assert_array_equal(traced.ids, plain.ids)
    np.testing.assert_array_equal(traced.weights, plain.weights)
    paths = [e["path"] for e in got.events]
    for stage in FIT_STAGES:
        assert paths.count(stage) == 1, stage
    assert [p for p in paths if p in FIT_STAGES] == [
        "fit/encode", "fit/plan", "fit/winners", "fit/collect/copy", "fit/collect/weigh",
        "fit/profile",
    ]
    # encode and profile are siblings of the fit root, not its children.
    assert paths.index("fit/encode") < paths.index("fit") < paths.index("fit/profile")
    assert len({e["trace_id"] for e in got.events if e["path"] in FIT_STAGES + ["fit"]}) == 1
    assert got.events[0]["docs"] == 8


def test_span_ts_is_the_start_plus_wall_under_a_fence_wait(monkeypatch):
    """The fence wait happens after ``wall_s`` stops; the event's start,
    ``ts - wall_s``, is still the span's start on the host's wall clock."""
    monkeypatch.setattr(spans, "_wait", lambda t: time.sleep(0.05))
    reg, got = Registry(), ListSink()
    reg.add_sink(got)
    start = time.time()
    with span("fenced", registry=reg, fence=True) as sp:
        sp.fence(torch.zeros(1))
    (ev,) = got.events
    assert ev["device_s"] >= 0.05 > ev["wall_s"]
    assert ev["ts"] - ev["wall_s"] == pytest.approx(start, abs=0.005)
