"""The port's serve score cache (``device="cpu"``), the cases of the JAX
package's ``tests/test_cache.py`` for ``serve/cache``.

* ``ScoreCache``: round trip, version/mode/encoding keying, copy-on-store,
  LRU eviction by rows and by bytes, the refused oversized entry, the
  occupancy gauges, ``get_many``/``put_many`` equal to per-document calls
  (counters included), the knobs, and the same hits, misses, evictions and
  fault schedule as the JAX package's cache on one operation sequence.
* Through the batcher: a repeat is answered without scoring, concurrent
  duplicates are scored once in one dispatch, a hot swap never serves a
  stale answer, a shared cache never answers one model (or one set of
  segment knobs) with another's results, and injected ``serve/cache``
  faults degrade to a miss and recompute, with the same bits, replayed
  deterministically.
"""

import contextlib
import functools
import threading

import numpy as np
import pytest

from spark_languagedetector_tpu.resilience import faults as jax_faults
from spark_languagedetector_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from spark_languagedetector_tpu.serve.cache import ScoreCache as JaxScoreCache
from spark_languagedetector_tpu_torch import LanguageDetectorModel
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.ops.encoding import texts_to_bytes
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, VocabSpec
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.segment import SegmentOptions, segment_documents
from spark_languagedetector_tpu_torch.serve import ContinuousBatcher, ModelRegistry
from spark_languagedetector_tpu_torch.serve.cache import ScoreCache
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

SPEC12 = VocabSpec(EXACT, (1, 2))
L = 5
LANGS = tuple(f"l{i}" for i in range(L))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@functools.lru_cache(maxsize=None)
def _runner(strategy="gather", seed=0):
    rng = np.random.default_rng(seed)
    weights = rng.normal(size=(SPEC12.id_space_size, L)).astype(np.float32)
    return BatchRunner(weights=weights, lut=None, spec=SPEC12, device="cpu",
                       strategy=strategy, batch_size=64)


def _model(seed):
    rng = np.random.default_rng(seed)
    gram_map = {bytes([a, b]): rng.normal(size=2).tolist()
                for a in range(97, 101) for b in range(97, 101)}
    gram_map.update({b"z": rng.normal(size=2).tolist(), b"zz": rng.normal(size=2).tolist()})
    return LanguageDetectorModel.from_gram_map(gram_map, (1, 2), ("x", "y"), device="cpu")


def _counter(name):
    return REGISTRY.snapshot()["counters"].get(name, 0)


def _reg(model):
    reg = ModelRegistry(device="cpu")
    reg.install(model)
    return reg


# ------------------------------------------------------------- the cache ----
def test_score_cache_roundtrip_and_version_keying():
    cache = ScoreCache(max_rows=64, max_bytes=1 << 20)
    row = np.arange(L, dtype=np.float32)
    cache.put("v1", "scores", "utf-8", b"doc", row)
    np.testing.assert_array_equal(cache.get("v1", "scores", "utf-8", b"doc"), row)
    row[0] = 99.0  # stored bits are decoupled from the caller's buffer
    got = cache.get("v1", "scores", "utf-8", b"doc")
    np.testing.assert_array_equal(got, np.arange(L, dtype=np.float32))
    with pytest.raises(ValueError):
        got[0] = 1.0  # read-only: a caller cannot corrupt later hits
    assert cache.get("v2", "scores", "utf-8", b"doc") is None
    assert cache.get("v1", "labels", "utf-8", b"doc") is None
    assert cache.get("v1", "scores", "low_byte", b"doc") is None
    stats = cache.stats()
    assert stats["hits"] == 2 and stats["misses"] == 3
    assert stats["rows"] == 1 and stats["bytes"] > 0 and stats["hit_rate"] == 0.4


def test_score_cache_lru_eviction_by_rows_and_bytes():
    cache = ScoreCache(max_rows=8, max_bytes=1 << 20, shards=1)
    for i in range(12):
        cache.put("v1", "labels", "utf-8", b"d%d" % i, np.int32(i))
    assert cache.rows == 8
    assert cache.get("v1", "labels", "utf-8", b"d0") is None
    assert int(cache.get("v1", "labels", "utf-8", b"d11")) == 11
    assert cache.stats()["evictions"] == 4
    small = ScoreCache(max_rows=1000, max_bytes=4096, shards=1)
    for i in range(8):
        small.put("v1", "scores", "utf-8", b"k%d" % i, np.zeros(128, np.float32))
    assert small.bytes <= 4096 and small.rows < 8
    small.put("v1", "scores", "utf-8", b"huge", np.zeros(4096, np.float32))
    assert small.get("v1", "scores", "utf-8", b"huge") is None


def test_score_cache_gauges_track_occupancy():
    cache = ScoreCache(max_rows=16, max_bytes=1 << 20)
    cache.put("v1", "labels", "utf-8", b"g", np.int32(1))
    gauges = REGISTRY.snapshot()["gauges"]
    assert gauges["langdetect_cache_rows"][""] == cache.rows == 1
    assert gauges["langdetect_cache_bytes"][""] == cache.bytes > 0


def test_get_many_put_many_match_per_doc_calls():
    c = ScoreCache(max_rows=64, max_bytes=1 << 20)
    docs = [b"a", b"b", b"a", b"c"]
    before = {k: _counter(f"cache/{k}") for k in ("lookups", "hits", "misses")}
    assert c.get_many("v1", "labels", "utf-8", docs) == [None] * 4
    c.put_many("v1", "labels", "utf-8", docs, [np.int32(i) for i in range(4)])
    got = c.get_many("v1", "labels", "utf-8", docs)
    assert [int(g) for g in got] == [2, 1, 2, 3]  # last write wins
    assert _counter("cache/lookups") - before["lookups"] == 8
    assert _counter("cache/misses") - before["misses"] == 4
    assert _counter("cache/hits") - before["hits"] == 4
    assert c.stats()["hits"] == 4 and c.stats()["misses"] == 4


def test_cache_knob_resolution(monkeypatch):
    monkeypatch.setenv("LANGDETECT_CACHE_ROWS", "128")
    monkeypatch.setenv("LANGDETECT_CACHE_BYTES", str(1 << 16))
    cache = ScoreCache()
    assert cache.max_rows == 128 and cache.max_bytes == 1 << 16
    monkeypatch.setenv("LANGDETECT_CACHE_ROWS", "-1")
    with pytest.raises(ValueError):
        ScoreCache()


def test_cache_disabled_by_knob(monkeypatch):
    monkeypatch.setenv("LANGDETECT_CACHE_ENABLE", "0")
    runner = _runner("gather")
    with ContinuousBatcher(runner, max_wait_ms=2) as b:
        assert b.cache is None
        docs = texts_to_bytes(["abab"])
        np.testing.assert_array_equal(b.submit(docs).result(timeout=30).values,
                                      runner.score(docs))


@pytest.mark.parametrize("plan", ["", "seed=11;serve/cache:error%0.4"])
def test_cache_matches_the_jax_cache_op_for_op(plan):
    """The same operation sequence (bounded rows, repeats, evictions, and
    the same fault plan) gives the JAX cache's answers, stats and fault
    schedule."""
    ops = [(i % 3, b"k%d" % (i % 11)) for i in range(60)]

    def run(cache_cls, fault_mod, plan_cls):
        cache = cache_cls(max_rows=8, max_bytes=1 << 20, shards=2)
        trace = []
        with fault_mod.plan_scope(plan_cls.parse(plan)) if plan else contextlib.nullcontext():
            for kind, key in ops:
                if kind == 0:
                    cache.put("v1", "labels", "utf-8", key, np.int32(len(key)))
                else:
                    got = cache.get("v1", "labels", "utf-8", key)
                    trace.append(None if got is None else int(got))
        return trace, cache.stats()

    assert run(ScoreCache, faults, FaultPlan) == run(JaxScoreCache, jax_faults, JaxFaultPlan)


# ----------------------------------------------------- batcher + the cache --
def test_batcher_cache_answers_repeat_without_rescoring():
    runner = _runner("gather")
    with ContinuousBatcher(runner, max_wait_ms=2, max_rows=64) as b:
        docs = texts_to_bytes(["abab", "zz", "abczz"])
        first = b.submit(docs).result(timeout=30)
        scored = runner.metrics.snapshot().get("docs_scored", 0)
        second = b.submit(docs).result(timeout=30)
        assert runner.metrics.snapshot().get("docs_scored", 0) == scored  # pure hits
        np.testing.assert_array_equal(first.values, second.values)
        np.testing.assert_array_equal(first.values, runner.score(docs))
        ids = b.submit(docs, want_labels=True).result(timeout=30)  # another mode: a miss
        np.testing.assert_array_equal(ids.values, runner.predict_ids(docs))
        assert b.cache.stats()["hits"] >= len(docs)


@pytest.mark.parametrize("strategy", ["fused", "gather"])
def test_batcher_concurrent_duplicates_dedup_in_one_dispatch(strategy):
    """Two concurrent requests with the same documents coalesce into one
    dispatch whose runner call scores each distinct row once, and both
    callers get the same bits."""
    runner = _runner(strategy)
    docs = texts_to_bytes(["abab", "zzzz"])
    before_in, before_uniq = _counter("dedup/rows_in"), _counter("dedup/rows_unique")
    before_dispatch = _counter("serve/dispatches")
    with ContinuousBatcher(runner, max_wait_ms=1000, max_rows=4, cache_enable=False,
                           clock=FakeClock()) as b:
        f1, f2 = b.submit(docs), b.submit(docs)  # the second fills max_rows
        r1, r2 = f1.result(timeout=30), f2.result(timeout=30)
    np.testing.assert_array_equal(r1.values, r2.values)
    np.testing.assert_array_equal(r1.values, runner.score(docs))
    assert _counter("dedup/rows_in") - before_in == 4 + 2
    assert _counter("dedup/rows_unique") - before_uniq == 2 + 2
    assert _counter("serve/dispatches") - before_dispatch == 1


def test_swap_under_cached_traffic_never_serves_stale():
    m1, m2 = _model(1), _model(2)
    want1, want2 = _model(1).runner, _model(2).runner
    registry = ModelRegistry(device="cpu")
    registry.install(m1, version="v1")
    docs = texts_to_bytes(["abab", "abczz", "zz"])
    with ContinuousBatcher(registry, max_wait_ms=2, max_rows=64) as b:
        r1 = b.submit(docs).result(timeout=30)
        r1b = b.submit(docs).result(timeout=30)  # warm: from the cache
        assert r1b.version == "v1"
        hits = b.cache.stats()["hits"]
        registry.install(m2, version="v2")
        r2 = b.submit(docs).result(timeout=30)
        assert b.cache.stats()["hits"] == hits  # nothing of v1 answered v2
    assert r1.version == "v1" and r2.version == "v2"
    np.testing.assert_array_equal(r1.values, want1.score(docs))
    np.testing.assert_array_equal(r1b.values, r1.values)
    np.testing.assert_array_equal(r2.values, want2.score(docs))
    assert not np.array_equal(r2.values, r1.values)


def test_shared_cache_does_not_leak_across_models():
    """Version names collide across sources (every static source pins "v0",
    every registry auto-names "v1"); the model uid or static token in the
    key keeps two models' entries apart."""
    r1, r2 = _runner("gather", 1), _runner("gather", 2)
    docs = texts_to_bytes(["abab", "zz"])
    shared = ScoreCache(max_rows=64, max_bytes=1 << 20)
    with ContinuousBatcher(r1, max_wait_ms=2, cache=shared) as b1, ContinuousBatcher(
        r2, max_wait_ms=2, cache=shared
    ) as b2:
        a1 = b1.submit(docs).result(timeout=30)
        a2 = b2.submit(docs).result(timeout=30)
        a1b = b1.submit(docs).result(timeout=30)
    np.testing.assert_array_equal(a1.values, r1.score(docs))
    np.testing.assert_array_equal(a2.values, r2.score(docs))
    np.testing.assert_array_equal(a1b.values, a1.values)
    assert not np.array_equal(a1.values, a2.values)
    m1, m2 = _model(1), _model(2)
    want1, want2 = m1.runner.score(docs), m2.runner.score(docs)
    reg1, reg2 = ModelRegistry(device="cpu"), ModelRegistry(device="cpu")
    assert reg1.install(m1) == reg2.install(m2) == "v1"
    shared2 = ScoreCache(max_rows=64, max_bytes=1 << 20)
    with ContinuousBatcher(reg1, max_wait_ms=2, cache=shared2) as b1, ContinuousBatcher(
        reg2, max_wait_ms=2, cache=shared2
    ) as b2:
        np.testing.assert_array_equal(b1.submit(docs).result(timeout=30).values, want1)
        np.testing.assert_array_equal(b2.submit(docs).result(timeout=30).values, want2)


def test_segment_cache_does_not_leak_across_knobs_or_models():
    m1, m2 = _model(1), _model(2)
    langs = list(m1.profile.languages)
    docs = texts_to_bytes(["abab " * 30, "zz", "abczz " * 50 + "zzzz " * 50])

    def direct(m, opts):
        return segment_documents(m.runner, docs, langs, options=opts, calibration=m.calibration)

    opts = SegmentOptions()
    opts_rej = SegmentOptions(top_k=1, reject_threshold=0.9)
    want = {(i, o.key()): direct(m, o) for i, m in ((1, m1), (2, m2)) for o in (opts, opts_rej)}
    shared = ScoreCache(max_rows=256, max_bytes=1 << 20)
    with ContinuousBatcher(_reg(m1), max_wait_ms=2, cache=shared) as b1, ContinuousBatcher(
        _reg(m2), max_wait_ms=2, cache=shared
    ) as b2:
        a1 = b1.segment(docs, opts)
        a2 = b2.segment(docs, opts)  # same version name, other model
        assert a1 == want[1, opts.key()] and a2 == want[2, opts.key()]
        r1 = b1.segment(docs, opts_rej)
        assert r1 == want[1, opts_rej.key()]
        assert r1 != a1  # the knobs change the answer, so a leak would show
        assert b1.segment(docs, opts) == a1
        assert b2.segment(docs, opts) == a2
    assert shared.stats()["hits"] >= 2 * len(docs)


# ---------------------------------------------------- chaos: serve/cache ----
def test_injected_cache_faults_degrade_to_miss_and_recompute():
    runner = _runner("gather")
    docs = texts_to_bytes(["abab", "zz"])
    direct = runner.score(docs)
    before = _counter("cache/faults")
    with ContinuousBatcher(runner, max_wait_ms=2, max_rows=64) as b:
        with faults.plan_scope(FaultPlan.parse("seed=7;serve/cache:error%0.5")):
            for _ in range(6):
                np.testing.assert_array_equal(b.submit(docs).result(timeout=30).values, direct)
    assert _counter("cache/faults") - before > 0


def test_cache_fault_replay_is_deterministic():
    plan_text = "seed=11;serve/cache:error%0.4"

    def run_once():
        fired = []
        cache = ScoreCache(max_rows=32, max_bytes=1 << 20)
        with faults.plan_scope(FaultPlan.parse(plan_text)):
            for i in range(20):
                before = _counter("cache/faults")
                if i % 2:
                    cache.put("v1", "labels", "utf-8", b"k%d" % i, np.int32(i))
                else:
                    cache.get("v1", "labels", "utf-8", b"k%d" % i)
                fired.append(_counter("cache/faults") - before)
        return fired

    first = run_once()
    assert first == run_once() and any(first)


def test_cache_is_safe_under_concurrent_front_end_threads():
    """Eight threads hammering one small cache: every hit is the value
    stored for its key, and the bounds hold."""
    cache = ScoreCache(max_rows=16, max_bytes=1 << 20, shards=4)
    errors = []

    def work(t):
        for i in range(300):
            key = b"k%d" % ((t * 7 + i) % 40)
            got = cache.get("v1", "labels", "utf-8", key)
            if got is not None and int(got) != len(key) * 1000 + key[-1]:
                errors.append((key, int(got)))
            cache.put("v1", "labels", "utf-8", key, np.int32(len(key) * 1000 + key[-1]))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and cache.rows <= 16
