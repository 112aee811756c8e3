"""The port's streaming engine held against the JAX package's, on the CPU.

The cases of the JAX package's stream tests run through the port's
``run_stream`` (order, ``max_batches``, a transient retry, the progress
callback, ``prefetch`` 0 and deep, one worker, worker spans under the
stream's root, ``kafka_source`` gated and driven by a stand-in ``kafka``
module), each where it can beside the JAX engine on the same rows. Added:
the chaos plan of the JAX package's chaos smoke through both engines
(identical sunk labels and dead-letter rows), a checkpoint kill and
resume, kernel failures that propagate instead of being quarantined, and
the shared-runner hazard: four concurrent transforms of one model give what
one gives.
"""

import sys
import threading
import types
from itertools import islice

import numpy as np
import pytest

from spark_languagedetector_tpu import LanguageDetector as JaxDetector
from spark_languagedetector_tpu import LanguageDetectorModel as JaxModel
from spark_languagedetector_tpu import Table as JaxTable
from spark_languagedetector_tpu.resilience import faults as jfaults
from spark_languagedetector_tpu.resilience.dlq import DeadLetterQueue as JaxDLQ
from spark_languagedetector_tpu.resilience.faults import FaultPlan as JaxPlan
from spark_languagedetector_tpu.resilience.policy import RetryPolicy as JaxPolicy
from spark_languagedetector_tpu.stream import microbatch as jstream
from spark_languagedetector_tpu_torch import LanguageDetector, LanguageDetectorModel, Table
from spark_languagedetector_tpu_torch.ops import KernelBuildError, KernelLaunchError
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.dlq import DeadLetterQueue
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.resilience.policy import RetryPolicy
from spark_languagedetector_tpu_torch.stream.microbatch import (
    kafka_source,
    memory_source,
    run_stream,
)
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

GRAMS = {b"ab": [1.0, 0.0], b"xy": [0.0, 1.0]}


def _model():
    return LanguageDetectorModel.from_gram_map(GRAMS, [2], ["a", "x"], device="cpu")


def _jax_model():
    return JaxModel.from_gram_map(GRAMS, [2], ["a", "x"])


def _labels_of(run, model, source, **kw):
    out = []
    query = run(model, source, lambda t: out.extend(t.column("lang").tolist()), **kw)
    return out, query


@pytest.mark.parametrize("prefetch,workers", [(None, None), (0, None), (3, None), (3, 1),
                                              (3, 3)])
def test_stream_scores_all_batches_in_order(prefetch, workers):
    rows = [{"fulltext": "ababab"}, {"fulltext": "xyxy"}] * 20
    kw = dict(prefetch=prefetch, workers=workers)
    out, query = _labels_of(run_stream, _model(), memory_source(rows, 3), **kw)
    assert query.batches == 14 and query.rows == 40
    assert out == ["a", "x"] * 20
    assert query.rows_per_second > 0
    ref, _ = _labels_of(jstream.run_stream, _jax_model(), jstream.memory_source(rows, 3), **kw)
    assert out == ref


@pytest.mark.parametrize("prefetch", [0, 2])
def test_stream_max_batches_limits_consumption(prefetch):
    rows = [{"fulltext": "ab"}] * 100
    pulled = []

    def source():
        for t in memory_source(rows, 10):
            pulled.append(t)
            yield t

    seen = []
    query = run_stream(_model(), source(), sink=lambda t: seen.append(t.num_rows),
                       max_batches=3, prefetch=prefetch)
    assert query.batches == 3
    assert seen == [10, 10, 10]
    assert len(pulled) == 3  # the budget bounds pulls, not just sinks


def test_stream_retries_transient_failure_once():
    rows = [{"fulltext": "ab"}] * 4
    model = _model()
    real_transform = model.transform
    fails = {"left": 1}

    def flaky(batch):
        if fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("transient device hiccup")
        return real_transform(batch)

    model.transform = flaky
    REGISTRY.reset()
    query = run_stream(model, memory_source(rows, 2), sink=lambda t: None)
    assert query.batches == 2
    assert query.metrics.counters["retries"] == 1
    assert REGISTRY.snapshot()["counters"]["stream/retries"] == 1


def test_stream_progress_callback():
    rows = [{"fulltext": "ab"}] * 6
    snapshots = []
    run_stream(
        _model(), memory_source(rows, 2), sink=lambda t: None,
        on_progress=lambda q: snapshots.append(
            (q.batches, q.last_batch_rows, q.last_batch_trace_id)),
    )
    assert [s[:2] for s in snapshots] == [(1, 2), (2, 2), (3, 2)]
    assert len({s[2] for s in snapshots}) == 3 and all(s[2] for s in snapshots)


def test_stream_prefetch_worker_spans_attach_to_stream_parent():
    """Spans of prefetch worker threads land under the engine's "stream"
    root with exact counts, and the queue depth and stall are recorded per
    batch."""
    REGISTRY.reset()
    captured = []
    REGISTRY.add_sink(type("S", (), {"emit": staticmethod(captured.append)})())
    try:
        rows = [{"fulltext": "ababab"}, {"fulltext": "xyxy"}] * 20
        query = run_stream(_model(), memory_source(rows, batch_rows=4), sink=lambda t: None,
                           prefetch=3, workers=3)
    finally:
        REGISTRY.clear_sinks()
    assert query.batches == 10
    stages = REGISTRY.stage_summary()
    assert stages["stream/transform"]["count"] == 10
    assert stages["stream/batch"]["count"] == 10
    assert stages["stream/batch/sink"]["count"] == 10
    assert stages["stream"]["count"] == 1
    assert "transform" not in stages
    assert stages["stream/transform/score"]["count"] == 10
    span_paths = {e["path"] for e in captured if e["event"] == "telemetry.span"}
    assert {"stream", "stream/transform", "stream/batch", "stream/batch/sink"} <= span_paths
    snap = REGISTRY.snapshot()
    assert snap["histograms"]["stream/queue_depth"]["count"] == 10
    assert snap["histograms"]["stream/prefetch_stall_s"]["count"] == 10


def test_stream_synchronous_path_records_spans_without_stall():
    REGISTRY.reset()
    rows = [{"fulltext": "ab"}] * 6
    run_stream(_model(), memory_source(rows, 2), sink=lambda t: None, prefetch=0)
    stages = REGISTRY.stage_summary()
    assert stages["stream/transform"]["count"] == 3
    assert "stream/prefetch_stall_s" not in REGISTRY.snapshot()["histograms"]


def test_stream_knobs_resolve_through_exec_config(monkeypatch):
    """``prefetch``/``workers`` left None read ``LANGDETECT_STREAM_PREFETCH``
    and ``LANGDETECT_STREAM_WORKERS``; workers default to min(2, prefetch)."""
    REGISTRY.reset()
    captured = []
    REGISTRY.add_sink(type("S", (), {"emit": staticmethod(captured.append)})())
    monkeypatch.setenv("LANGDETECT_STREAM_PREFETCH", "4")
    try:
        run_stream(_model(), memory_source([{"fulltext": "ab"}] * 4, 2), lambda t: None)
        monkeypatch.setenv("LANGDETECT_STREAM_WORKERS", "3")
        run_stream(_model(), memory_source([{"fulltext": "ab"}] * 4, 2), lambda t: None)
    finally:
        REGISTRY.clear_sinks()
    roots = [e for e in captured if e["event"] == "telemetry.span" and e["path"] == "stream"]
    assert [(e["prefetch"], e["workers"]) for e in roots] == [(4, 2), (4, 3)]


# ------------------------------------------------------------ chaos leg -----
def _fitted(n_langs=3):
    """A small fitted model in each package, on the same corpus."""
    rng = np.random.default_rng(3)
    langs = ["aa", "bb", "cc"][:n_langs]
    letters = {"aa": "abcdefg", "bb": "hijklmn", "cc": "opqrstu"}
    docs, labels = [], []
    for i in range(60):
        lang = langs[i % n_langs]
        words = ["".join(rng.choice(list(letters[lang]), int(rng.integers(2, 7))))
                 for _ in range(int(rng.integers(3, 30)))]
        docs.append(" ".join(words))
        labels.append(lang)
    port = LanguageDetector(langs, [1, 2], 200, device="cpu").fit(
        Table({"lang": labels, "fulltext": docs}))
    jax = JaxDetector(langs, [1, 2], 200).fit(JaxTable({"lang": labels, "fulltext": docs}))
    return port, jax, docs


PLAN = "seed=7;stream/batch:error@2;score/dispatch:error@6;stream/batch:poison=2@3"


def test_stream_chaos_plan_matches_the_jax_engine(tmp_path):
    """The JAX chaos smoke's plan through both engines: the same sunk
    labels (the fault-free run's minus the poison rows) and the same
    dead-letter rows, with their batch and row indices."""
    port, jax, docs = _fitted()
    rows = [{"fulltext": d} for d in docs]
    oracle, _ = _labels_of(run_stream, port, memory_source(rows, 10))
    jref, _ = _labels_of(jstream.run_stream, jax, jstream.memory_source(rows, 10))
    assert oracle == jref

    poison = FaultPlan.parse(PLAN).poison_rows(3, 10)
    assert poison == JaxPlan.parse(PLAN).poison_rows(3, 10) and len(poison) == 2
    REGISTRY.reset()
    dlq, jdlq = DeadLetterQueue(str(tmp_path / "dlq.jsonl")), JaxDLQ()
    with faults.plan_scope(FaultPlan.parse(PLAN)):
        out, query = _labels_of(run_stream, port.copy(), memory_source(rows, 10),
                                retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0),
                                dlq=dlq, checkpoint_path=str(tmp_path / "ck.json"))
    with jfaults.plan_scope(JaxPlan.parse(PLAN)):
        jout, jquery = _labels_of(jstream.run_stream, jax.copy(), jstream.memory_source(rows, 10),
                                  retry_policy=JaxPolicy(max_attempts=3, base_delay_s=0.0),
                                  dlq=jdlq)
    expected = [lab for i, lab in enumerate(oracle) if i not in {20 + r for r in poison}]
    assert out == expected == jout
    assert query.batches == jquery.batches == 6
    assert query.quarantined_batches == jquery.quarantined_batches == 1
    mine = [(r["batch"], r["row_index"], r["row"]) for r in dlq.records]
    assert mine == [(r["batch"], r["row_index"], r["row"]) for r in jdlq.records]
    assert mine == [(2, r, rows[20 + r]) for r in poison]
    assert all("PoisonRowError" in r["error"] for r in dlq.records)
    assert [r["row_index"] for r in DeadLetterQueue.load(str(tmp_path / "dlq.jsonl"))] == poison
    dlq.close()
    counters = REGISTRY.snapshot()["counters"]
    assert counters["stream/retries"] >= 1
    assert counters["resilience/quarantined_batches"] == 1
    assert counters["resilience/dlq_rows"] == 2


@pytest.mark.parametrize("exc", [KernelLaunchError, KernelBuildError, ValueError])
def test_stream_failure_that_is_not_poison_propagates(exc, tmp_path):
    """A kernel that fails to build or launch is neither replayed nor
    bisected into the DLQ: it raises out of ``run_stream``, nothing is
    quarantined and the failing batch is not committed. Without a DLQ a
    deterministic ``ValueError`` raises too, after one attempt."""
    rows = [{"fulltext": "ab"}] * 6
    model = _model()
    real = model.transform
    calls = {"n": 0}

    def failing(batch):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise exc("launch failed" if exc is not ValueError else "bad column")
        return real(batch)

    model.transform = failing
    dlq = DeadLetterQueue() if exc is not ValueError else None
    REGISTRY.reset()
    seen = []
    with pytest.raises(exc):
        run_stream(model, memory_source(rows, 2), seen.append, dlq=dlq,
                   retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0),
                   checkpoint_path=str(tmp_path / "ck.json"))
    assert calls["n"] == 2 and len(seen) == 1
    assert dlq is None or len(dlq) == 0
    counters = REGISTRY.snapshot()["counters"]
    assert "stream/retries" not in counters and "resilience/quarantined_batches" not in counters
    from spark_languagedetector_tpu_torch.persist.checkpoint import load_checkpoint

    assert load_checkpoint(tmp_path / "ck.json")["committed"] == 1


def test_stream_checkpoint_kill_and_resume(tmp_path):
    """A sink that dies at batch 3, then a rerun on the same checkpoint:
    the rerun resumes after the two committed batches, and the two runs'
    sunk rows together are the stream, each row once. The same holds for
    a first run cut by ``max_batches=1``."""
    rows = [{"fulltext": "ab" * (i + 1)} for i in range(12)]
    for cut in ("sink_dies", "max_batches"):
        ck = str(tmp_path / f"{cut}.json")
        sunk = []

        def dying(t):
            if len(sunk) == 4:
                raise OSError("sink lost its connection")
            sunk.extend(t.column("fulltext").tolist())

        if cut == "sink_dies":
            with pytest.raises(OSError):
                run_stream(_model(), memory_source(rows, 2), dying, checkpoint_path=ck)
            committed = 2
        else:
            run_stream(_model(), memory_source(rows, 2), dying, checkpoint_path=ck,
                       max_batches=1, prefetch=2, workers=2)
            committed = 1
        assert len(sunk) == 2 * committed
        first = list(sunk)
        sunk.clear()
        query = run_stream(_model(), memory_source(rows, 2),
                           lambda t: sunk.extend(t.column("fulltext").tolist()),
                           checkpoint_path=ck, prefetch=2, workers=2)
        assert query.resumed_from == committed
        assert first + sunk == [r["fulltext"] for r in rows]


# ------------------------------------------------- shared-runner hazard -----
def test_four_concurrent_transforms_equal_one():
    """Four stream workers transform through one model's runner at once (its
    staging, plan and dedup state, its launches) and give exactly the labels
    of one worker; four threads calling ``runner.score`` on different
    inputs give the serial scores bit for bit. A short switch interval
    makes the threads interleave often."""
    port, _, docs = _fitted()
    rows = [{"fulltext": d * (1 + i % 4)} for i, d in enumerate(docs * 4)]
    ref, _ = _labels_of(run_stream, port, memory_source(rows, 12), prefetch=0, workers=1)
    runner = port.runner
    runner.batch_size = 8  # several batches per call
    inputs = [[r["fulltext"].encode() for r in rows[i::4]] for i in range(4)]
    serial = [runner.score(x) for x in inputs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, _ = _labels_of(run_stream, port, memory_source(rows, 12), prefetch=6, workers=4)
        results = [None] * 4

        def work(i):
            results[i] = runner.score(inputs[i])

        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert got == ref
    for a, b in zip(results, serial):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------- kafka source (stubbed) --
def test_kafka_source_gated_on_missing_dependency(monkeypatch):
    monkeypatch.setitem(sys.modules, "kafka", None)
    with pytest.raises(RuntimeError, match="kafka-python"):
        next(kafka_source("topic", 10))


class _FakeRecord:
    def __init__(self, value):
        self.value = value


class _FakeConsumer:
    """Scripted kafka.KafkaConsumer stand-in: each poll() returns the next
    scripted {partition: [records]} dict ({} once the script runs out)."""

    instances: list = []
    script: list = []

    def __init__(self, topic, **kwargs):
        self.topic = topic
        self.kwargs = kwargs
        self.polls = list(self.script)
        _FakeConsumer.instances.append(self)

    def poll(self, timeout_ms):
        self.poll_timeout_ms = timeout_ms
        return self.polls.pop(0) if self.polls else {}


@pytest.fixture
def fake_kafka(monkeypatch):
    mod = types.ModuleType("kafka")
    mod.KafkaConsumer = _FakeConsumer
    _FakeConsumer.instances = []
    monkeypatch.setitem(sys.modules, "kafka", mod)
    return mod


def test_kafka_source_batches_decodes_and_flushes(fake_kafka):
    _FakeConsumer.script = [
        {
            "tp0": [_FakeRecord(b"hello"), _FakeRecord(b"welt"), _FakeRecord("already-a-str")],
            "tp1": [_FakeRecord(b"\xff\xferaw")],
        },
        {},
        {"tp0": [_FakeRecord(12345)]},
    ]
    tables = list(islice(kafka_source("mytopic", batch_rows=2, poll_timeout_s=0.5,
                                      group_id="g1"), 3))
    assert [t.column("fulltext").tolist() for t in tables] == [
        ["hello", "welt"],
        ["already-a-str", "��raw"],
        ["12345"],
    ]
    (consumer,) = _FakeConsumer.instances
    assert consumer.topic == "mytopic"
    assert consumer.kwargs == {"group_id": "g1"}
    assert consumer.poll_timeout_ms == 500


def test_kafka_source_drives_run_stream(fake_kafka):
    _FakeConsumer.script = [
        {"tp": [_FakeRecord(b"ababab"), _FakeRecord(b"xyxy")]},
        {"tp": [_FakeRecord(b"abab")]},
    ]
    out, query = _labels_of(run_stream, _model(), kafka_source("t", batch_rows=2),
                            max_batches=2)
    assert query.batches == 2
    assert out == ["a", "x", "a"]
