"""The port's serving stack (``device="cpu"``) against its runner and the JAX
package's serve stack.

* ``ContinuousBatcher``: results bit for bit the direct ``runner.score`` /
  ``predict_ids`` (the fused strategy's plain version and ``gather``),
  coalescing, lane order, the max-rows flush, deadlines, queue-full, SLO,
  breaker-open and ``serve/admit`` sheds, drain on close, a dispatch error
  to every request of its batch, a cancelled future, the empty request.
  The flush window runs on an injected clock, moved by the test, so no
  assertion rests on a wall-clock margin.
* ``ModelRegistry``: a swap under concurrent traffic drops nothing and
  answers every request from exactly one version; rollback, a rollback
  racing an install, lease pinning, explicit names, load from either
  package's saved directory; a retired version's runner is released (and
  rebuilt for a rollback); prewarm loads the library of every kernel the
  runner's strategy can launch.
* ``ServingServer`` / ``ServeClient`` over a socket: score, detect,
  segment, the probes, ``/varz``, ``/telemetryz``, 503 with Retry-After,
  504 on a deadline, 400s, 500 on a dispatch error, swap and rollback,
  low-byte encoding, a burst of 32 connections answered or shed (never
  reset), the client's retry policy (a shed retried, a 400 not, a retry
  past the request's deadline given up).
* Across the packages: one JAX-fitted model, loaded by both, served by the
  JAX batcher and the port's to the same concurrent requests (labels
  identical, scores within ``atol=1e-4, rtol=1e-5``, segment results under
  the segment class of ``tests/test_torch_segment.py``); a JAX client
  against the port's server and a port client against the JAX server
  answer as the server's runner does, bit for bit.
* ``LanguageDetectorModel.runner`` is built once under concurrent reads.
"""

import functools
import gc
import tempfile
import threading
import weakref

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu_torch import LanguageDetectorModel
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.exec.core import AdmissionQueue
from spark_languagedetector_tpu_torch.models.profile import GramProfile
from spark_languagedetector_tpu_torch.ops import _kernels
from spark_languagedetector_tpu_torch.ops.encoding import LOW_BYTE, texts_to_bytes
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.resilience.policy import CircuitBreaker
from spark_languagedetector_tpu_torch.segment import SegmentOptions, segment_documents
from spark_languagedetector_tpu_torch.serve import (
    BULK,
    ContinuousBatcher,
    ModelRegistry,
    ServeClient,
    ServeClosed,
    ServeDeadlineExceeded,
    ServeError,
    ServeHTTPError,
    ServeOverloaded,
    ServingServer,
)
from spark_languagedetector_tpu_torch.telemetry import REGISTRY
from spark_languagedetector_tpu_torch.telemetry.aggregate import install_process_identity

ATOL, RTOL = 1e-4, 1e-5
LANGS = ("x", "y")
GRAM_MAP = {b"ab": [1.0, 0.0], b"bc": [0.5, 0.5], b"zz": [0.0, 2.0], b"abc": [3.0, 0.0]}


class FakeClock:
    """The batcher's clock: frozen until the test moves it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _advance(batcher, clock, seconds=3600.0):
    clock.t += seconds
    batcher.wake()


def _runner(strategy="gather", **kw):
    profile = GramProfile.from_gram_map(GRAM_MAP, LANGS, (2, 3))
    w, lut = profile.host_membership()
    kw.setdefault("batch_size", 4)
    kw.setdefault("length_buckets", (128, 256))
    return BatchRunner(weights=w, lut=lut, spec=profile.spec, device="cpu",
                       strategy=strategy, **kw)


def _docs(rng, n, max_len=90):
    return [bytes(rng.integers(97, 123, rng.integers(0, max_len)).tolist()) for _ in range(n)]


def _model(seed=0):
    rng = np.random.default_rng(seed)
    return LanguageDetectorModel.from_gram_map(
        {g: rng.normal(size=2).tolist() for g in GRAM_MAP}, (2, 3), LANGS, device="cpu"
    )


class SpyRunner:
    """Delegating runner that records each coalesced dispatch's docs."""

    def __init__(self, runner):
        self.runner = runner
        self.calls: list[list[bytes]] = []

    @property
    def breaker(self):
        return self.runner.breaker

    def score(self, docs):
        self.calls.append(list(docs))
        return self.runner.score(docs)

    def predict_ids(self, docs):
        self.calls.append(list(docs))
        return self.runner.predict_ids(docs)


# --------------------------------------------------------------- runner lock -
def test_model_runner_is_built_once_under_concurrent_reads(monkeypatch):
    from spark_languagedetector_tpu_torch.models import estimator

    built = []
    real = estimator.BatchRunner

    def counting(*a, **kw):
        built.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(estimator, "BatchRunner", counting)
    model = _model(seed=40)
    barrier = threading.Barrier(8)
    got = [None] * 8

    def read(i):
        barrier.wait(timeout=30)
        got[i] = model.runner

    threads = [threading.Thread(target=read, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(built) == 1
    assert all(r is got[0] for r in got)
    # Copies drop the runner and the lock and make their own.
    twin = model.copy()
    assert twin._runner is None and twin._runner_lock is not model._runner_lock
    assert twin.runner is not got[0] and len(built) == 2
    model.release_runner()
    assert model._runner is None


# ------------------------------------------------------------------ batcher -
@pytest.mark.parametrize("strategy", ["fused", "gather"])
def test_batcher_bit_identical_to_direct_runner(strategy):
    """Mixed-bucket documents (empty, short, chunked long) through the
    batcher equal the direct runner's scores and ids bit for bit."""
    runner = _runner(strategy)
    assert runner.strategy == strategy
    rng = np.random.default_rng(7)
    docs = _docs(rng, 9) + [b"", b"ab" * 160]  # chunked at 320 > 256
    with ContinuousBatcher(runner, max_wait_ms=2, max_rows=64, cache_enable=False) as b:
        got = b.submit(docs).result(timeout=30)
        np.testing.assert_array_equal(got.values, runner.score(docs))
        assert got.version == "v0"
        ids = b.submit(docs, want_labels=True).result(timeout=30)
        np.testing.assert_array_equal(ids.values, runner.predict_ids(docs))


@pytest.mark.parametrize("strategy", ["fused", "gather"])
def test_batcher_concurrent_callers_coalesce_into_one_dispatch(strategy):
    """Twelve concurrent submitters on a frozen clock: the flush fires when
    the twelfth request fills ``max_rows``, so one dispatch serves all, and
    every response equals its direct scores bit for bit."""
    runner = _runner(strategy, batch_size=64)
    rng = np.random.default_rng(11)
    doc_sets = [_docs(rng, 4) for _ in range(12)]
    want = [runner.score(ds) for ds in doc_sets]
    spy = SpyRunner(runner)
    REGISTRY.reset()
    clock = FakeClock()
    with ContinuousBatcher(spy, max_wait_ms=1000, max_rows=48, clock=clock,
                           cache_enable=False) as b:
        barrier = threading.Barrier(len(doc_sets))
        got: list = [None] * len(doc_sets)

        def work(i):
            barrier.wait(timeout=30)
            got[i] = b.submit(doc_sets[i]).result(timeout=30)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(doc_sets))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for i in range(len(doc_sets)):
        np.testing.assert_array_equal(got[i].values, want[i])
        assert got[i].rows_coalesced == 48
    assert len(spy.calls) == 1
    snap = REGISTRY.snapshot()
    assert snap["histograms"]["serve/rows_per_dispatch"]["mean"] == 48
    assert snap["counters"]["serve/coalesced_rows"] == 48
    for name in ("serve/queue_wait_s", "serve/dispatch_s", "serve/total_s"):
        assert snap["histograms"][name]["count"] > 0


def test_batcher_priority_lane_order_and_flush_window():
    """Interactive rows ride ahead of earlier bulk rows; below ``max_rows``
    nothing flushes until the oldest request has waited ``max_wait``."""
    spy = SpyRunner(_runner())
    clock = FakeClock()
    bulk_docs, inter_docs = [b"zzzz", b"zz"], [b"abab"]
    with ContinuousBatcher(spy, max_wait_ms=300, max_rows=999, clock=clock) as b:
        f_bulk = b.submit(bulk_docs, priority=BULK)
        f_inter = b.submit(inter_docs)
        assert not f_bulk.done() and not f_inter.done() and spy.calls == []
        _advance(b, clock, 0.301)
        f_bulk.result(timeout=30)
        f_inter.result(timeout=30)
    assert spy.calls == [inter_docs + bulk_docs]


def test_admission_queue_gathers_the_lead_key_across_lanes():
    """The first item taken sets the batch's key; its items come from every
    lane up to ``max_rows``, and items of other keys keep their order for
    later batches."""
    q = AdmissionQueue(max_rows=8, max_wait_s=0.0, max_queue_rows=100)
    for name, k, rows, lane in [("a", "A", 4, "interactive"), ("b", "B", 4, "interactive"),
                                ("c", "A", 4, "interactive"), ("d", "A", 4, "interactive"),
                                ("e", "A", 2, "bulk"), ("f", "B", 2, "bulk")]:
        assert q.admit((name, k), rows, lane) == (None, 0.0)
    batches = []
    for _ in range(3):
        batches.append([name for name, _ in q.next_batch(key=lambda item: item[1])])
        q.done()
    assert batches == [["a", "c"], ["b", "f"], ["d", "e"]]
    assert q.queued_rows == 0 and q.stats()["queue_depth"] == 0


def test_batcher_interleaved_kinds_coalesce_per_kind():
    """Score and label requests queued alternately (as clients in lockstep
    send them) leave in two dispatches, one per kind, each request's
    answer its direct runner's."""
    runner = _runner()
    spy = SpyRunner(runner)
    clock = FakeClock()
    rng = np.random.default_rng(5)
    doc_sets = [_docs(rng, 2) for _ in range(5)]
    REGISTRY.reset()
    with ContinuousBatcher(spy, max_wait_ms=300, max_rows=999, clock=clock,
                           cache_enable=False) as b:
        futs = [b.submit(ds, want_labels=bool(i % 2)) for i, ds in enumerate(doc_sets)]
        assert spy.calls == []
        _advance(b, clock)
        got = [f.result(timeout=30).values for f in futs]
    assert spy.calls == [doc_sets[0] + doc_sets[2] + doc_sets[4], doc_sets[1] + doc_sets[3]]
    for i, ds in enumerate(doc_sets):
        want = runner.predict_ids(ds) if i % 2 else runner.score(ds)
        np.testing.assert_array_equal(got[i], want)
    assert REGISTRY.snapshot()["histograms"]["serve/requests_per_dispatch"]["mean"] == 2.5


def test_batcher_flushes_on_max_rows_without_waiting():
    """A full queue flushes at once: the clock never moves here, so only
    the row bound can release the request."""
    runner = _runner()
    with ContinuousBatcher(runner, max_wait_ms=10_000, max_rows=4, clock=FakeClock()) as b:
        out = b.submit([b"ab", b"bc", b"zz", b"abc"]).result(timeout=30)
    assert out.values.shape == (4, 2)


def test_batcher_deadline_rejected_explicitly():
    runner = _runner()
    clock = FakeClock()
    with ContinuousBatcher(runner, max_wait_ms=50, max_rows=8, clock=clock) as b:
        doomed = b.submit([b"zz"], deadline_ms=10.0)
        alive = b.submit([b"ab"], deadline_ms=10_000.0)
        _advance(b, clock, 1.0)
        with pytest.raises(ServeDeadlineExceeded):
            doomed.result(timeout=30)
        np.testing.assert_array_equal(alive.result(timeout=30).values, runner.score([b"ab"]))


def test_batcher_shed_queue_full():
    """Reject-newest: admissions past the queue bound shed explicitly;
    queued work is answered."""
    runner = _runner()
    REGISTRY.reset()
    clock = FakeClock()
    with ContinuousBatcher(runner, max_wait_ms=50, max_rows=999, max_queue_rows=8,
                           clock=clock) as b:
        queued = b.submit([b"bc"] * 8)
        with pytest.raises(ServeOverloaded) as exc:
            b.submit([b"zz"])
        assert exc.value.reason == "queue_full"
        assert exc.value.retry_after_s > 0
        assert b.stats()["shed_reasons"] == {"queue_full": 1}
        _advance(b, clock)
        queued.result(timeout=30)
    counters = REGISTRY.snapshot()["counters"]
    assert counters["serve/shed_queue_full"] == 1 and counters["serve/shed_rows"] == 1


def test_batcher_shed_slo_estimated_wait():
    clock = FakeClock()
    with ContinuousBatcher(_runner(), max_wait_ms=500, max_rows=999, slo_ms=100,
                           clock=clock) as b:
        b._ema_rows_per_s = 10.0  # 10 rows/s measured
        b.submit([b"ab"] * 8)  # 8 rows queued => est wait 0.8 s > 0.1 s
        with pytest.raises(ServeOverloaded) as exc:
            b.submit([b"zz"])
        assert exc.value.reason == "slo"
        _advance(b, clock)


def test_batcher_breaker_open_sheds_bulk_serves_interactive():
    """An open breaker sheds the bulk lane; interactive requests are still
    answered exactly (a gather runner off the card takes the ladder)."""
    runner = _runner()
    runner.breaker = CircuitBreaker(failure_threshold=1, cooldown_s=60.0, name="test")
    docs = [b"abab", b"zz"]
    want = _runner().score(docs)
    runner.breaker.record_failure()
    assert runner.breaker.state == "open"
    with ContinuousBatcher(runner, max_wait_ms=2, max_rows=8) as b:
        with pytest.raises(ServeOverloaded) as exc:
            b.submit(docs, priority=BULK)
        assert exc.value.reason == "degraded"
        np.testing.assert_array_equal(b.submit(docs).result(timeout=30).values, want)


def test_chaos_serve_admit_site_forces_shed():
    runner = _runner()
    REGISTRY.reset()
    with ContinuousBatcher(runner, max_wait_ms=2, max_rows=8) as b:
        with faults.plan_scope(FaultPlan.parse("seed=3;serve/admit:error@1")):
            with pytest.raises(ServeOverloaded) as exc:
                b.submit([b"ab"])
            assert exc.value.reason == "injected"
            out = b.submit([b"ab"]).result(timeout=30)
            np.testing.assert_array_equal(out.values, runner.score([b"ab"]))
    counters = REGISTRY.snapshot()["counters"]
    assert counters["serve/shed_injected"] == 1
    assert counters["resilience/faults_injected"] == 1


def test_batcher_close_drains_then_rejects():
    """close() answers everything already admitted (the frozen clock never
    flushes them), then new submissions fail fast."""
    b = ContinuousBatcher(_runner(), max_wait_ms=50, max_rows=999, clock=FakeClock())
    futures = [b.submit([b"ab", b"bc"]) for _ in range(3)]
    b.close()
    for f in futures:
        assert f.result(timeout=30).values.shape == (2, 2)
    with pytest.raises(ServeClosed):
        b.submit([b"zz"])
    with pytest.raises(ServeClosed):
        b.submit([])


def test_batcher_close_without_drain_fails_queued():
    b = ContinuousBatcher(_runner(), max_wait_ms=50, max_rows=999, clock=FakeClock())
    queued = b.submit([b"ab"])
    b.close(drain=False)
    with pytest.raises(ServeClosed):
        queued.result(timeout=30)


def test_batcher_dispatch_error_propagates_to_all_requests():
    """A dispatch that fails after the runner's own recovery fails every
    request of the batch with that error: never a hang, never a fallback."""

    class ExplodingRunner:
        breaker = None

        def score(self, docs):
            raise ValueError("deterministic scorer bug")

    REGISTRY.reset()
    with ContinuousBatcher(ExplodingRunner(), max_wait_ms=1000, max_rows=2,
                           clock=FakeClock()) as b:
        f1 = b.submit([b"ab"])
        f2 = b.submit([b"bc"])  # fills max_rows: one batch of both
        for f in (f1, f2):
            with pytest.raises(ValueError, match="deterministic scorer bug"):
                f.result(timeout=30)
    assert REGISTRY.snapshot()["counters"]["serve/dispatch_errors"] == 1


def test_batcher_survives_cancelled_future():
    runner = _runner()
    clock = FakeClock()
    REGISTRY.reset()
    with ContinuousBatcher(runner, max_wait_ms=30, max_rows=16, clock=clock) as b:
        doomed = b.submit([b"zz"])
        neighbor = b.submit([b"bc"])
        assert doomed.cancel()  # still queued: cancel succeeds
        _advance(b, clock)
        np.testing.assert_array_equal(neighbor.result(timeout=30).values, runner.score([b"bc"]))
        after = b.submit([b"abc"])
        _advance(b, clock)
        np.testing.assert_array_equal(after.result(timeout=30).values, runner.score([b"abc"]))
    assert REGISTRY.snapshot()["counters"]["serve/cancelled_requests"] == 1


def test_batcher_empty_request_answers_immediately():
    runner = _runner()
    with ContinuousBatcher(runner, max_wait_ms=5, max_rows=8) as b:
        res = b.submit([]).result(timeout=10)
        np.testing.assert_array_equal(res.values, runner.score([]))
        assert res.values.shape == (0, 2)
        assert b.submit([], want_labels=True).result(timeout=10).values.shape == (0,)
        assert b.submit([], segment_options=SegmentOptions()).result(timeout=10).values == []
        out = b.submit([b"ab"]).result(timeout=30)
        np.testing.assert_array_equal(out.values, runner.score([b"ab"]))
    with pytest.raises(ValueError, match="mutually exclusive"):
        b.submit([b"ab"], want_labels=True, segment_options=SegmentOptions())


# ----------------------------------------------------------------- registry -
def test_registry_swap_exactly_one_version_zero_drops():
    """Concurrent requests across a hot swap: each answered once, bit for
    bit by the runner of the version that served it; none dropped."""
    model_a, model_b = _model(seed=1), _model(seed=2)
    runner_a, runner_b = model_a.runner, model_b.runner
    registry = ModelRegistry(device="cpu", drain_timeout_s=5.0)
    v_a = registry.install(model_a)
    rng = np.random.default_rng(23)
    doc_sets = [_docs(rng, 3, max_len=40) for _ in range(40)]
    results: list = [None] * len(doc_sets)
    with ContinuousBatcher(registry, max_wait_ms=2, max_rows=16) as b:
        def work(i):
            results[i] = b.submit(doc_sets[i]).result(timeout=30)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(doc_sets))]
        for t in threads[:20]:
            t.start()
        v_b = registry.install(model_b)
        for t in threads[20:]:
            t.start()
        for t in threads:
            t.join()
    served = set()
    for i, res in enumerate(results):
        assert res is not None, f"request {i} dropped"
        served.add(res.version)
        runner = runner_a if res.version == v_a else runner_b
        np.testing.assert_array_equal(res.values, runner.score(doc_sets[i]))
    assert v_b in served
    versions = registry.versions()
    assert [v["version"] for v in versions] == [v_a, v_b]
    assert versions[1]["active"] and not versions[0]["active"]
    assert versions[0]["retired"] and versions[0]["strategy"] is None
    assert versions[1]["device"] == "cpu"


def test_registry_rollback_rebuilds_released_runner_and_frees_it():
    """A retired version's runner is released once no lease holds it (its
    tables can be freed); a rollback builds and prewarms it again."""
    model_a, model_b = _model(seed=3), _model(seed=4)
    docs = [b"abab", b"zz"]
    want_a = model_a.runner.score(docs)
    model_a.release_runner()
    registry = ModelRegistry(device="cpu", drain_timeout_s=1.0)
    v_a = registry.install(model_a)
    gone = weakref.ref(registry.peek().runner)
    v_b = registry.install(model_b)
    gc.collect()
    assert gone() is None, "the retired runner is still referenced"
    assert registry.current_version() == v_b
    assert registry.rollback() == v_a
    assert registry.current_version() == v_a
    assert registry.peek().runner is not None
    with pytest.raises(ServeError, match="no previous version"):
        registry.rollback()
    with ContinuousBatcher(registry, max_wait_ms=2) as b:
        got = b.submit(docs).result(timeout=30)
    assert got.version == v_a
    np.testing.assert_array_equal(got.values, want_a)
    assert registry.activate(v_b) == v_b and registry.activate(v_b) == v_b
    with pytest.raises(ServeError, match="not in history"):
        registry.activate("v9")


def test_registry_is_busy_while_it_swaps_and_refuses_a_swap_once_closed():
    """An install or rollback counts as busy from its runner build to its
    flip (a zoo never pages a tenant out under one). After close(), a swap
    raises ServeClosed and keeps no runner: none is built into a registry
    that no longer serves, so none outlives it."""
    model_a, model_b, model_c = _model(seed=3), _model(seed=4), _model(seed=5)
    registry = ModelRegistry(device="cpu", drain_timeout_s=1.0)
    v_a = registry.install(model_a)
    assert not registry.busy()
    seen = []
    real_warm = registry._warm_runner

    def warm(model, prewarm=True):
        seen.append(registry.busy())
        return real_warm(model, prewarm)

    registry._warm_runner = warm
    v_b = registry.install(model_b)
    model_a.release_runner()  # no caller but the registry holds a's runner
    assert registry.rollback() == v_a  # a's runner was released: rebuilt
    assert seen == [True, True] and not registry.busy()
    registry._warm_runner = real_warm
    registry.close()
    for swap in (lambda: registry.install(model_c), lambda: registry.activate(v_b)):
        with pytest.raises(ServeClosed, match="registry is closed"):
            swap()
        assert not registry.busy()
    for model in (model_a, model_b, model_c):
        assert model._runner is None and model._runner_holds == 0


def test_registry_explicit_version_never_collides_with_auto():
    registry = ModelRegistry(device="cpu", drain_timeout_s=0.5)
    registry.install(_model(seed=11), version="v2")
    assert registry.install(_model(seed=12)) == "v1"
    assert registry.install(_model(seed=13)) == "v3"  # skips the taken v2
    assert registry.current_version() == "v3"
    with pytest.raises(ServeError, match="already registered"):
        registry.install(_model(seed=14), version="v1")


def test_registry_rollback_racing_concurrent_install():
    """Rollback racing an install under traffic: every lease answers with
    its own version's scores; the history stays consistent."""
    models = {"v1": _model(seed=31), "v2": _model(seed=32), "v3": _model(seed=33)}
    docs = [b"abab", b"zz"]
    want = {v: m.runner.score(docs) for v, m in models.items()}
    registry = ModelRegistry(device="cpu", drain_timeout_s=0.2)
    registry.install(models["v1"])
    registry.install(models["v2"])
    stop = threading.Event()
    failures: list[str] = []

    def traffic():
        while not stop.is_set():
            with registry.lease() as entry:
                if not np.array_equal(entry.runner.score(docs), want[entry.version]):
                    failures.append(f"version {entry.version} answered foreign scores")

    def roller():
        try:
            registry.rollback()
        except ServeError:
            pass  # racing a flip may leave nothing to roll back to

    workers = [threading.Thread(target=traffic) for _ in range(3)]
    for t in workers:
        t.start()
    racers = [threading.Thread(target=lambda: registry.install(models["v3"])),
              threading.Thread(target=roller)]
    for t in racers:
        t.start()
    for t in racers:
        t.join(timeout=60)
    stop.set()
    for t in workers:
        t.join(timeout=60)
    assert not failures, failures[:3]
    versions = registry.versions()
    names = [v["version"] for v in versions]
    assert len(names) == len(set(names))
    assert sum(v["active"] for v in versions) == 1
    with registry.lease() as entry:
        assert entry.version == next(v for v in versions if v["active"])["version"]
        np.testing.assert_array_equal(entry.runner.score(docs), want[entry.version])


def test_registry_lease_pins_version_during_swap():
    registry = ModelRegistry(device="cpu", drain_timeout_s=0.2)
    v_a = registry.install(_model(seed=6))
    with registry.lease() as entry:
        v_b = registry.install(_model(seed=7))  # drain times out, swap proceeds
        assert entry.version == v_a and entry.runner is not None
        assert registry.busy()
    assert entry.runner is None  # released when the lease ended
    with registry.lease() as entry:
        assert entry.version == v_b
    assert not registry.busy()


def test_registry_load_from_disk_either_package(tmp_path):
    """load() goes through the port's LanguageDetectorModel.load, so a
    model saved by either package serves; a baked artifact named by
    ``artifact=`` is mapped instead (``artifacts/baked_loads``) and serves
    the same scores."""
    from spark_languagedetector_tpu import LanguageDetectorModel as JaxModel
    from spark_languagedetector_tpu_torch.artifacts import bake_model

    model = _model(seed=5)
    model.save(str(tmp_path / "m"))
    rng = np.random.default_rng(5)
    JaxModel.from_gram_map({g: rng.normal(size=2).tolist() for g in GRAM_MAP}, (2, 3),
                           LANGS).save(str(tmp_path / "j"))
    registry = ModelRegistry(device="cpu")
    v1 = registry.load(str(tmp_path / "m"))
    assert registry.peek().source == str(tmp_path / "m")
    assert registry.peek().languages == LANGS
    with pytest.raises(ServeError, match="already registered"):
        registry.load(str(tmp_path / "m"), version=v1)
    bake_model(model, tmp_path / "m.baked")
    baked0 = REGISTRY.snapshot()["counters"].get("artifacts/baked_loads", 0)
    v_baked = registry.load(str(tmp_path / "m"), artifact=str(tmp_path / "m.baked"))
    assert REGISTRY.snapshot()["counters"]["artifacts/baked_loads"] == baked0 + 1
    assert hasattr(registry.peek().model, "_prebuilt_membership")
    np.testing.assert_array_equal(registry.peek().runner.score([b"abab", b"zzab"]),
                                  model.runner.score([b"abab", b"zzab"]))
    assert registry.rollback() == v1 and v_baked != v1
    docs = [b"abab", b"zzab"]
    with ContinuousBatcher(registry, max_wait_ms=2) as b:
        np.testing.assert_array_equal(b.submit(docs).result(timeout=30).values,
                                      model.runner.score(docs))
        registry.load(str(tmp_path / "j"))
        np.testing.assert_array_equal(b.submit(docs).result(timeout=30).values,
                                      _model(seed=5).runner.score(docs))


def test_runner_kernels_and_prewarm_loads_their_libraries(monkeypatch):
    """Prewarm loads the library of every kernel the strategy can launch,
    so no request pays a build inside the dispatcher."""
    fused, gather = _runner("fused"), _runner("gather")
    assert fused.kernels() == gather.kernels() == ()  # none off the card
    monkeypatch.setattr(fused, "device", torch.device("cuda"))
    monkeypatch.setattr(gather, "device", torch.device("cuda"))
    assert fused.kernels() == (_kernels.FUSED_DETECT, _kernels.FUSED_SEGMENT)
    assert gather.kernels() == ()
    hybrid = LanguageDetectorModel.from_gram_map(
        {b"abcd": [0.0, 2.0], b"ab": [1.0, 0.0], b"q": [0.5, 0.0]}, [1, 2, 3, 4], LANGS,
        device="cpu",
    ).runner
    assert hybrid.strategy == "hybrid"
    monkeypatch.setattr(hybrid, "device", torch.device("cuda"))
    assert hybrid.kernels() == (_kernels.BIGRAM_SCORE, _kernels.ROW_HIST)

    loaded = []

    class FakeKernel:
        name = "fake"

        def library(self):
            loaded.append(self.name)

    model = _model(seed=8)
    monkeypatch.setattr(model.runner, "kernels", lambda: (FakeKernel(), FakeKernel()))
    ModelRegistry(device="cpu").prepare(model)
    assert loaded == ["fake", "fake"]


# --------------------------------------------------------------------- http -
@pytest.fixture()
def serving():
    model = _model(seed=8)
    registry = ModelRegistry(device="cpu")
    registry.install(model)
    server = ServingServer(registry, port=0, max_wait_ms=2, max_rows=64).start()
    try:
        yield model, registry, server, ServeClient(*server.address)
    finally:
        server.stop()


def test_http_score_detect_segment_bit_identical(serving):
    model, registry, server, client = serving
    runner = model.runner
    texts = ["abab", "zz", "", "abczz"]
    scores, meta = client.score(texts)
    np.testing.assert_array_equal(scores, runner.score(texts_to_bytes(texts)))
    assert scores.dtype == np.float32
    assert meta["version"] == "v1" and meta["trace_id"]
    assert meta["server_timing"]["rows_coalesced"] >= len(texts)
    labels, _ = client.detect(texts)
    assert labels == [LANGS[i] for i in runner.predict_ids(texts_to_bytes(texts))]
    seg_texts = ["abab zz " * 40, "zz"]
    results, meta = client.segment(seg_texts, top_k=1)
    assert meta["mode"] == "segment"
    assert results == segment_documents(runner, texts_to_bytes(seg_texts), LANGS,
                                        options=SegmentOptions(top_k=1))


def test_http_probes_varz_telemetryz(serving):
    model, registry, server, client = serving
    client.score(["abab"])
    health = client.healthz()
    assert health["ok"] and health["version"] == "v1" and health["ready"]
    assert health["breaker"] == "closed" and health["device"] == "cpu"
    assert "queued_rows" in health["batcher"]
    assert client.livez()["live"]
    assert client.readyz()["ready"]
    varz = client.varz()
    assert "serve/dispatch" in varz["stages"]
    assert "serve/rows_per_dispatch" in varz["histograms"]
    assert varz["versions"][0]["version"] == "v1"
    assert varz["config"]["knobs"]["serve_max_rows"]["value"] == 256
    snap = client.telemetryz()
    assert snap["counters"]["serve/requests"] >= 1 and "pid" in snap["identity"]
    saved = dict(REGISTRY.identity)
    try:
        install_process_identity(replica="r0", device=torch.device("cpu"))
        assert client.telemetryz()["identity"]["platform"] == "cpu"
        install_process_identity(replica="r0", device="cuda:0")
        _, meta = client.score(["abab"])
        assert meta["server"]["platform"] == "gpu" and meta["server"]["replica"] == "r0"
    finally:
        REGISTRY.identity.clear()
        REGISTRY.identity.update(saved)


def test_http_shed_is_503_with_retry_after(serving):
    model, registry, server, client = serving
    with faults.plan_scope(FaultPlan.parse("seed=1;serve/admit:error@1")):
        with pytest.raises(ServeHTTPError) as exc:
            client.score(["abab"])
    assert exc.value.status == 503 and exc.value.shed
    assert exc.value.retry_after_s > 0
    assert exc.value.payload["reason"] == "injected"


def test_http_bad_requests_are_400_and_dispatch_errors_500(serving, monkeypatch):
    model, registry, server, client = serving
    for path, payload in (("/score", {"texts": "not-a-list"}),
                          ("/score", {"texts": ["a"], "priority": "vip"}),
                          ("/detect?mode=words", {"texts": ["a"]}),
                          ("/detect?mode=segment", {"texts": ["a"], "top_k": "two"}),
                          ("/score", {"texts": ["a"], "tenant": "t1"}),
                          ("/admin/swap", {"path": ""})):
        with pytest.raises(ServeHTTPError) as exc:
            client._request("POST", path, payload)
        assert exc.value.status == 400, path
    with pytest.raises(ServeHTTPError) as exc:
        client._request("POST", "/nope", {})
    assert exc.value.status == 404
    with pytest.raises(ServeHTTPError) as exc:
        client._request("GET", "/nope")
    assert exc.value.status == 404

    def broken(docs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(registry.peek().runner, "score", broken)
    with pytest.raises(ServeHTTPError) as exc:
        client.score(["abab"])
    assert exc.value.status == 500 and "kernel launch failed" in exc.value.payload["error"]


def test_http_swap_and_rollback(serving, tmp_path):
    model, registry, server, client = serving
    model_b = _model(seed=9)
    model_b.save(str(tmp_path / "m2"))
    runner_b = _model(seed=9).runner
    assert client.swap(str(tmp_path / "m2")) == "v2"
    texts = ["abab", "zz"]
    scores, meta = client.score(texts)
    assert meta["version"] == "v2"
    np.testing.assert_array_equal(scores, runner_b.score(texts_to_bytes(texts)))
    assert client.rollback() == "v1"
    scores, meta = client.score(texts)
    assert meta["version"] == "v1"
    np.testing.assert_array_equal(scores, model.runner.score(texts_to_bytes(texts)))
    with pytest.raises(ServeHTTPError) as exc:
        client.rollback()
    assert exc.value.status == 500 and "no previous version" in exc.value.payload["error"]


def test_http_burst_is_answered_or_shed_never_reset(serving):
    """32 clients connect at once against a 16-row queue: each gets its
    answer or an explicit 503 shed; no connection is reset."""
    model, registry, server, client = serving
    server.batcher.max_queue_rows = 16
    barrier = threading.Barrier(32)
    outcomes = []

    def work(i):
        barrier.wait(timeout=30)
        try:
            labels, _ = ServeClient(*server.address).detect(["abab zz"] * 8, priority="bulk")
            outcomes.append("ok" if len(labels) == 8 else "short")
        except ServeHTTPError as e:
            outcomes.append("shed" if e.status == 503 and e.shed and e.retry_after_s > 0
                            else repr(e))
        except Exception as e:
            outcomes.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(outcomes) == 32 and set(outcomes) <= {"ok", "shed"}, outcomes
    assert "ok" in outcomes


def test_http_deadline_is_504():
    """A request whose deadline passes in the queue answers 504 (the
    server's batcher runs on a frozen clock that the test moves)."""
    clock = FakeClock()
    with ServingServer(_model(seed=12), port=0, max_wait_ms=50, max_rows=999,
                       clock=clock) as server:
        client = ServeClient(*server.address)
        out = {}

        def call():
            try:
                client.score(["abab"], deadline_ms=10.0)
            except ServeHTTPError as e:
                out["error"] = e

        t = threading.Thread(target=call)
        t.start()
        for _ in range(3000):  # wait (at most 30 s) for the request to queue
            if server.batcher.stats()["queued_rows"]:
                break
            t.join(timeout=0.01)
        else:
            pytest.fail("the request never reached the queue")
        _advance(server.batcher, clock, 1.0)
        t.join(timeout=30)
        assert not t.is_alive()
    assert out["error"].status == 504 and out["error"].payload["deadline"]


def test_client_retry_policy_honors_sheds_not_bad_requests(serving):
    """With a retry policy the client retries a 503 shed and gets its
    answer; a 400 is never retried; a retry that would sleep past the
    request's deadline gives up with the last error."""
    from spark_languagedetector_tpu_torch.resilience.policy import RetryPolicy

    model, registry, server, _ = serving
    client = ServeClient(*server.address,
                         retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    before = REGISTRY.snapshot()["counters"].get("serve/client_retries", 0)
    with faults.plan_scope(FaultPlan.parse("seed=1;serve/admit:error@1")):
        scores, _ = client.score(["abab"])
    np.testing.assert_array_equal(scores, model.runner.score([b"abab"]))
    assert REGISTRY.snapshot()["counters"]["serve/client_retries"] == before + 1
    with pytest.raises(ServeHTTPError) as exc:
        client._request("POST", "/score", {"texts": "x"}, idempotent=True)
    assert exc.value.status == 400
    assert REGISTRY.snapshot()["counters"]["serve/client_retries"] == before + 1
    server.batcher.max_queue_rows = 0  # every admission sheds
    try:
        with pytest.raises(ServeHTTPError) as exc:
            client.score(["abab"], deadline_ms=0.001)
    finally:
        server.batcher.max_queue_rows = 4096
    assert exc.value.status == 503
    assert REGISTRY.snapshot()["counters"]["serve/client_deadline_gaveups"] >= 1


def test_http_low_byte_encoding_respected():
    model = _model(seed=10)
    model.set_predict_encoding(LOW_BYTE)
    runner = model.runner
    with ServingServer(model, port=0, max_wait_ms=2) as server:
        scores, _ = ServeClient(*server.address).score(["abézz", "abab"])
    np.testing.assert_array_equal(scores, runner.score(texts_to_bytes(["abézz", "abab"], LOW_BYTE)))


# ------------------------------------------------------ across the packages -
TEXTS = ["the cat sat on the mat", "der hund lief über die straße", "le chat dort",
         "the dog and der hund", "", "straße", "chat"]


@functools.lru_cache(maxsize=None)
def _saved_jax_model() -> str:
    """A JAX-fitted model (exact n = 1..3, three languages), saved."""
    from spark_languagedetector_tpu import LanguageDetector as JaxDetector
    from spark_languagedetector_tpu import Table as JaxTable

    rng = np.random.default_rng(0)
    words = {"en": "the cat dog and with sat on mat".split(),
             "de": "der hund und katze mit die straße über".split(),
             "fr": "le chat chien et avec dort sur la".split()}
    texts, labels = [], []
    for i in range(60):
        lang = ("en", "de", "fr")[i % 3]
        texts.append(" ".join(rng.choice(words[lang], int(rng.integers(3, 30)))))
        labels.append(lang)
    model = JaxDetector(["en", "de", "fr"], [1, 2, 3], 60).fit(
        JaxTable({"lang": labels, "fulltext": texts}))
    path = tempfile.mkdtemp(prefix="serve_jax_model_") + "/m"
    model.save(path)
    return path


def _assert_segment_class(got, ref):
    """tests/test_torch_segment.py's class: every key exact but the
    six-decimal probabilities, within 1e-4."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g["label"], g["rejected"], g["calibrated"]) == (
            r["label"], r["rejected"], r["calibrated"])
        assert [(s["start"], s["end"], s["lang"]) for s in g["spans"]] == [
            (s["start"], s["end"], s["lang"]) for s in r["spans"]]
        assert [e["lang"] for e in g["topk"]] == [e["lang"] for e in r["topk"]]
        np.testing.assert_allclose([s["confidence"] for s in g["spans"]],
                                   [s["confidence"] for s in r["spans"]], atol=1e-4)
        np.testing.assert_allclose([e["prob"] for e in g["topk"]],
                                   [e["prob"] for e in r["topk"]], atol=1e-4)


def test_port_and_jax_batchers_serve_the_same_model_alike():
    """One JAX-fitted model, loaded by both packages, served by both
    batchers to the same concurrent requests."""
    from spark_languagedetector_tpu import LanguageDetectorModel as JaxModel
    from spark_languagedetector_tpu.segment import SegmentOptions as JaxSegmentOptions
    from spark_languagedetector_tpu.serve import ContinuousBatcher as JaxBatcher
    from spark_languagedetector_tpu.serve import ModelRegistry as JaxRegistry

    path = _saved_jax_model()
    jreg, reg = JaxRegistry(), ModelRegistry(device="cpu")
    jreg.install(JaxModel.load(path))
    reg.install(LanguageDetectorModel.load(path, device="cpu"))
    docs = texts_to_bytes(TEXTS)
    seg_docs = texts_to_bytes([" ".join(TEXTS[:4]) * 8, TEXTS[1]])
    kinds = ("score", "labels", "segment") * 3
    out = {}
    with JaxBatcher(jreg, max_wait_ms=20, max_rows=64) as jb, ContinuousBatcher(
        reg, max_wait_ms=20, max_rows=64
    ) as b:
        for name, batcher, opts in (("jax", jb, JaxSegmentOptions(top_k=2)),
                                    ("port", b, SegmentOptions(top_k=2))):
            got = [None] * len(kinds)

            def work(i, batcher=batcher, opts=opts, got=got):
                kind = kinds[i]
                if kind == "segment":
                    got[i] = batcher.submit(seg_docs, segment_options=opts).result(timeout=60)
                else:
                    got[i] = batcher.submit(docs, want_labels=kind == "labels").result(timeout=60)

            threads = [threading.Thread(target=work, args=(i,)) for i in range(len(kinds))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out[name] = got
    for kind, j, p in zip(kinds, out["jax"], out["port"]):
        if kind == "score":
            np.testing.assert_allclose(p.values, j.values, atol=ATOL, rtol=RTOL)
            assert (p.values.argmax(1) == j.values.argmax(1)).all()
        elif kind == "labels":
            assert p.labels == j.labels
        else:
            _assert_segment_class(p.values, j.values)


def test_clients_and_servers_of_both_packages_interoperate():
    """A JAX client against the port's server and a port client against
    the JAX server get exactly what the server's runner gives."""
    from spark_languagedetector_tpu import LanguageDetectorModel as JaxModel
    from spark_languagedetector_tpu.serve.client import ServeClient as JaxClient
    from spark_languagedetector_tpu.serve.server import ServingServer as JaxServer

    path = _saved_jax_model()
    jmodel = JaxModel.load(path)
    model = LanguageDetectorModel.load(path, device="cpu")
    docs = texts_to_bytes(TEXTS)
    seg_texts = [" ".join(TEXTS[:4]) * 8]
    with ServingServer(model, port=0, max_wait_ms=2) as server, JaxServer(
        jmodel, port=0, max_wait_ms=2
    ) as jserver:
        for client, m, runner in (
            (JaxClient(*server.address), model, model.runner),
            (ServeClient(*jserver.address), jmodel, jmodel._get_runner()),
        ):
            scores, meta = client.score(TEXTS)
            np.testing.assert_array_equal(scores, runner.score(docs))
            labels, _ = client.detect(TEXTS)
            assert labels == [m.profile.languages[i] for i in runner.predict_ids(docs)]
            results, meta = client.segment(seg_texts, top_k=2)
            assert meta["mode"] == "segment" and len(results) == 1
            assert client.healthz()["version"] == "v1"
        # The segment answers of the two servers agree in the segment class.
        _assert_segment_class(ServeClient(*server.address).segment(seg_texts, top_k=2)[0],
                              ServeClient(*jserver.address).segment(seg_texts, top_k=2)[0])
