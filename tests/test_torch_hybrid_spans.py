"""The spans, counters and gauges of the hybrid route and of the split
device fit's host half, on the CPU.

A ``hybrid`` batch's dispatch records ``hybrid/short`` and ``hybrid/long``
once each inside ``score/dispatch`` (the long part naming its route); a
runner with row-histogram operands sets ``runner/hist_rows`` to their padded
row count, and only a launch of the CUDA kernel past the shared-memory limit
counts ``score/hist/global_atomic``. A runner of another strategy records
neither part. The split fit records ``fit/long/count``, ``fit/long/select``
and ``fit/merge`` once each, after its dense half, the first two with
``backend="device"`` (the long half's keys are counted and ranked on the
fit's device), and counts the n = 4..5 windows and distinct (gram,
language) pairs it counted: the host count's numbers on the same corpus.
"""

import numpy as np
import pytest

from spark_languagedetector_tpu_torch import LanguageDetector, LanguageDetectorModel, Table
from spark_languagedetector_tpu_torch.ops import fit as tfit
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, VocabSpec
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

EXACT5 = {b"a": [1.0, 0.0], b"ab": [0.5, 0.0], b"xyz": [0.0, 1.0], b"abcd": [2.0, 0.0],
          b"hello": [0.0, 3.0]}
LONG = ("fit/long/count", "fit/long/select", "fit/merge")


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


def _counter(name):
    return REGISTRY.snapshot()["counters"].get(name, 0)


def test_hybrid_dispatch_records_its_two_parts(sink):
    model = LanguageDetectorModel.from_gram_map(
        EXACT5, [1, 2, 3, 4, 5], ["a", "x"], device="cpu").set_batch_size(4)
    # Distinct documents (the dedup keeps them all), several batches of 4.
    docs = [("abcd " if i % 2 else "hello xyz ") * (i + 1) for i in range(12)]
    before = _counter("score/hist/global_atomic")
    got = model.transform(Table({"fulltext": docs})).column("lang").tolist()
    assert got == ["x", "a"] * 6
    runner = model.runner
    assert runner.strategy == "hybrid" and runner.long_route == "bucket"
    paths = [e["path"] for e in sink.events]
    dispatches = paths.count("score/dispatch")
    assert dispatches > 1
    assert paths.count("score/dispatch/hybrid/short") == dispatches
    assert paths.count("score/dispatch/hybrid/long") == dispatches
    longs = [e for e in sink.events if e["path"] == "score/dispatch/hybrid/long"]
    assert {e["route"] for e in longs} == {"bucket"}
    rows = runner.hist_state.weights_pad.shape[0]
    assert rows % 256 == 0 and REGISTRY.snapshot()["gauges"]["runner/hist_rows"][""] == rows
    assert _counter("score/hist/global_atomic") == before  # the plain version ran


def test_other_strategies_record_no_hybrid_part(sink):
    model = LanguageDetectorModel.from_gram_map(
        {b"ab": [1.0, 0.0], b"xy": [0.0, 1.0]}, [2], ["a", "x"], device="cpu")
    assert model.transform(Table({"fulltext": ["abab", "xyxy"]})).column("lang").tolist() == [
        "a", "x"]
    assert model.runner.strategy == "fused" and model.runner.long_route is None
    assert not any("hybrid" in e["path"] for e in sink.events)


def _long_windows_and_pairs(texts, labels):
    """n = 4..5 windows of the documents (a 4-byte document's partial n = 5
    window included) and their distinct (gram, language) pairs."""
    windows, pairs = 0, set()
    for t, lang in zip(texts, labels):
        b = t.encode()
        grams = [b[s : s + n] for n in (4, 5) for s in range(len(b) - n + 1)]
        if len(b) == 4:
            grams.append(b)
        windows += len(grams)
        pairs |= {(g, lang) for g in grams}
    return windows, len(pairs)


def test_split_fit_records_its_host_half(sink):
    texts = ["der schnelle braune fuchs", "das ist ja sehr schön", "abcd",
             "the quick brown fox", "that is very nice", "xyz"]
    labels = ["de", "de", "de", "en", "en", "en"]
    det = (LanguageDetector(["de", "en"], [1, 2, 3, 4, 5], 30, device="cpu")
           .set_vocab_mode("exact").set_fit_backend("device"))
    before = {k: _counter(k) for k in ("fit/long/windows", "fit/long/pairs")}
    det.fit(Table({"lang": labels, "fulltext": texts}))
    paths = [e["path"] for e in sink.events]
    for stage in LONG:
        assert paths.count(stage) == 1, stage
    assert [p for p in paths if p in LONG] == list(LONG)
    # The host half runs after the device half, inside the fit root.
    assert paths.index("fit/collect") < paths.index("fit/long/count")
    assert paths.index("fit/merge") < paths.index("fit")
    windows, pairs = _long_windows_and_pairs(texts, labels)
    gc = tfit.extract_gram_counts(
        [t.encode() for t in texts], np.array([0, 0, 0, 1, 1, 1]), 2,
        VocabSpec(EXACT, (1, 2, 3, 4, 5)), gram_lengths_subset=(4, 5), min_partial_gram_len=4)
    assert (int(gc.counts.sum()), gc.ids.size) == (windows, pairs)  # the host's count
    assert _counter("fit/long/windows") - before["fit/long/windows"] == windows
    assert _counter("fit/long/pairs") - before["fit/long/pairs"] == pairs
    (count,) = [e for e in sink.events if e["path"] == "fit/long/count"]
    assert count["windows"] == windows and count["pairs"] == pairs
    assert np.isfinite(count["wall_s"])
    for stage in ("fit/long/count", "fit/long/select"):
        (event,) = [e for e in sink.events if e["path"] == stage]
        assert event["backend"] == "device", stage
