"""The port's telemetry core against the JAX package's.

* the same observations give the same registry snapshot: counters, gauges
  and every histogram statistic, percentiles included, and the same merged
  sketches;
* span paths nest as the JAX package's do, and every span record carries
  ``trace_id`` and ``tid``; fencing waits on CPU tensors harmlessly;
* a score call that raises dumps the flight recorder, once;
* the Chrome trace CLI renders a capture of the port as the JAX one does.
"""

import json
import threading

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu.telemetry import registry as jregistry
from spark_languagedetector_tpu.telemetry import spans as jspans
from spark_languagedetector_tpu.telemetry import tracing as jtracing
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, VocabSpec
from spark_languagedetector_tpu_torch.telemetry import (
    REGISTRY,
    Registry,
    current_span,
    current_trace_id,
    flightrec,
    span,
    trace_request,
    tracing,
)
from spark_languagedetector_tpu_torch.telemetry.registry import Histogram


class ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)


def _feed(reg):
    rng = np.random.default_rng(0)
    for v in rng.exponential(size=2000):
        reg.observe("score/batch_latency_s", float(v))
    for v in rng.random(50):
        reg.observe("score/batch_fill_ratio", float(v))
    reg.incr("score/real_bytes", 12345)
    reg.incr("score/retries")
    reg.set_gauge("langdetect_breaker_state", 2.0, breaker="score")
    reg.set_gauge("langdetect_degraded", 1.0)
    reg.record_span("score/pack", 0.25, None, {"rows": 3})
    reg.record_span("score/dispatch", 0.5, 0.75, {"rows": 3})


def test_registry_snapshot_equals_jax():
    reg, jreg = Registry(), jregistry.Registry()
    _feed(reg)
    _feed(jreg)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.stage_summary() == jreg.stage_summary()
    assert reg.gauge_series() == jreg.gauge_series()
    mine, theirs = reg.mergeable_snapshot(), jreg.mergeable_snapshot()
    mine.pop("ts"), theirs.pop("ts")
    assert mine == theirs
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "histograms": {}, "gauges": {}}


def test_histogram_percentiles_and_merge_equal_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=3000), rng.normal(size=700)
    h, jh = Histogram(), jregistry.Histogram()
    for v in a:
        h.record(float(v))
        jh.record(float(v))
    for p in (0, 1, 50, 90, 99, 100):
        assert h.percentile(p) == jh.percentile(p)
    other, jother = Histogram(), jregistry.Histogram()
    for v in b:
        other.record(float(v))
        jother.record(float(v))
    h.merge(other)
    jh.merge(jother.state())
    assert h.snapshot() == jh.snapshot()
    assert Histogram.from_state(h.state()).snapshot() == h.snapshot()
    assert np.isnan(Histogram().percentile(50))


def test_span_paths_trace_ids_and_threads_equal_jax():
    def capture(span_fn, reg, trace_fn):
        sink = ListSink()
        reg.add_sink(sink)
        with trace_fn("t-1"):
            with span_fn("score", registry=reg, docs=3) as root:
                with span_fn("score/pack", registry=reg, rows=2):
                    pass
                with span_fn("pack", registry=reg):
                    pass

                def worker():
                    with span_fn("score/dispatch", parent=root, registry=reg):
                        pass

                t = threading.Thread(target=worker)
                t.start()
                t.join()
            with span_fn("stream/transform", registry=reg) as st:
                with span_fn("score", registry=reg):
                    with span_fn("score/pack", registry=reg):
                        pass
            del st
        reg.remove_sink(sink)
        return sink.events

    ev = capture(span, Registry(), trace_request)
    jev = capture(jspans.span, jregistry.Registry(), jtracing.trace_request)
    paths = [e["path"] for e in ev]
    assert paths == [e["path"] for e in jev]
    assert paths == ["score/pack", "score/pack", "score/dispatch", "score",
                     "stream/transform/score/pack", "stream/transform/score",
                     "stream/transform"]
    assert all(e["trace_id"] == "t-1" and isinstance(e["tid"], int) for e in ev)
    assert ev[0]["rows"] == 2 and ev[3]["docs"] == 3
    assert current_span() is None and current_trace_id() is None
    with trace_request() as a:
        with trace_request() as b:
            assert a == b == current_trace_id() and len(a) == 16


def test_fence_waits_on_tensors_and_records_device_time():
    reg = Registry()
    with span("score/dispatch", registry=reg, fence=True) as sp:
        sp.fence(torch.ones(3), None)
    with span("score/dispatch", registry=reg, fence=False) as sp:
        sp.fence(torch.ones(3))
    summary = reg.stage_summary()["score/dispatch"]
    assert summary["count"] == 2 and "device_total_s" in summary
    assert reg.histograms["span_device:score/dispatch"].count == 1


def test_score_call_that_raises_dumps_the_flight_recorder(tmp_path, monkeypatch):
    flightrec.uninstall()
    rec = flightrec.install(str(tmp_path), capacity=64)
    try:
        spec = VocabSpec(EXACT, (1, 2))
        w = np.random.default_rng(3).normal(size=(spec.id_space_size, 3)).astype(np.float32)
        runner = BatchRunner(weights=w, lut=None, spec=spec, device="cpu",
                             strategy="gather", batch_size=8, length_buckets=(128,))
        runner.score([b"abc", b"de"])  # fills the ring with real spans

        def broken(*a, **kw):
            raise ValueError("programming error")

        monkeypatch.setattr(BatchRunner, "_dispatch_device", broken)
        with pytest.raises(ValueError, match="programming error"):
            runner.score([b"abc", b"xyz"])
        path = flightrec.last_dump_path()
        assert path is not None and path.startswith(str(tmp_path))
        lines = [json.loads(x) for x in open(path)]
        assert lines[0]["event"] == "flightrec.dump" and lines[0]["context"] == "score"
        assert "programming error" in lines[0]["error"]
        assert any(e.get("path") == "score" for e in lines[1:])
        # A second hook on the same exception does not dump again.
        with pytest.raises(ValueError) as info:
            runner.score([b"q"])
        assert flightrec.record_crash("outer", info.value) is None
        assert len(rec) <= 64
    finally:
        flightrec.uninstall()


def test_chrome_trace_cli_renders_a_port_capture(tmp_path):
    sink = ListSink()
    REGISTRY.add_sink(sink)
    try:
        with trace_request():
            with span("score"):
                with span("score/pack"):
                    pass
    finally:
        REGISTRY.remove_sink(sink)
    src = tmp_path / "cap.jsonl"
    src.write_text("\n".join(json.dumps(e) for e in sink.events) + "\nnot json\n")
    out = tmp_path / "cap.trace.json"
    assert tracing.main([str(src), str(out)]) == 0
    trace = json.loads(out.read_text())
    names = [e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert sorted(names) == ["score", "score/pack"]
    ref = jtracing.render_chrome_trace(sink.events)
    assert [e["name"] for e in ref["traceEvents"] if e.get("ph") == "X"] == names
    assert tracing.main([]) == 2
