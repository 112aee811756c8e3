"""The port's replicated serving fleet (``device="cpu"``) against its runner
and the JAX package's fleet.

* The contracts of ``tests/test_fleet.py`` in the port's form: the split
  liveness/readiness probes, a draining stop answering every accepted
  request, the client's bounded 503 retries (never a 400 or a 504), the
  registry's two-phase prepare/commit, least-outstanding routing with the
  index tie-break, failover off a killed replica bit for bit, ejection and
  half-open re-admission on an injected breaker clock, the fleet-wide shed,
  the explicit no-ready-replica 503, the two-phase swap (atomic under
  concurrent traffic, one coordinator, a phase-1 abort everywhere, a
  phase-2 crash rolled back and replayed), swap/rollback/healthz over HTTP,
  seeded ``fleet/probe`` and ``fleet/dispatch`` chaos replayed, and
  membership changes (add, remove mid-flight, a fresh breaker for a
  re-added address, membership composed with swaps, the last replica
  kept).
* The port's own: a swap builds one runner per distinct model and frees the
  old one once every replica retired it, a rollback rebuilds it once, an
  aborted swap reuses the runner still served; a kill with a request queued
  fails it with 503 and the router fails it over; a replica whose kernel
  fails answers 500 naming the ``KernelLaunchError`` and the router counts
  it and fails over; the collector's merge and retention.
* Across the packages: one JAX-fitted model saved once, loaded by both
  fleets (``ServeFleet.from_path``), driven by the same sequential script
  (probes, kills, fake-clock cooldowns, swap, rollback, chaos plans): the
  same replica, version and probe events per step, the same fleet counters,
  labels identical and scores in the reduction-order class
  (``atol=1e-4, rtol=1e-5``); ``merge_snapshots`` and ``FleetCollector``
  give the JAX results on the same snapshots; a JAX client against the
  port's router front and a port client against the JAX one.

Fleets start with ``start(probe=False)`` and tests drive ``probe_once()``;
breakers run on a fake clock moved by the test; waits are on conditions.
"""

import functools
import socket
import gc
import tempfile
import threading
import time
import weakref
from types import SimpleNamespace

import numpy as np
import pytest

from spark_languagedetector_tpu_torch import LanguageDetectorModel
from spark_languagedetector_tpu_torch.models import estimator
from spark_languagedetector_tpu_torch.ops._kernels import KernelLaunchError
from spark_languagedetector_tpu_torch.ops.encoding import texts_to_bytes
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.resilience.policy import CircuitBreaker, RetryPolicy
from spark_languagedetector_tpu_torch.serve import (
    ContinuousBatcher,
    FleetSaturated,
    FleetSwapError,
    ModelRegistry,
    NoReadyReplica,
    QuarantineTable,
    RouterServer,
    ServeClient,
    ServeFleet,
    ServeHTTPError,
    ServeOverloaded,
    ServingServer,
)
from spark_languagedetector_tpu_torch.telemetry import REGISTRY
from spark_languagedetector_tpu_torch.telemetry.aggregate import (
    FleetCollector,
    merge_snapshots,
)

ATOL, RTOL = 1e-4, 1e-5
LANGS = ("x", "y", "z")
GRAM_KEYS = (b"ab", b"bc", b"zz", b"abc", b"zza")
TEXTS = ["abab", "zz", "abczz"]


class FakeClock:
    """The breakers' clock: frozen until the test moves it."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@functools.lru_cache(maxsize=None)
def _model(seed=0):
    # Shared per seed: replicas share one model, as ServeFleet.from_path.
    rng = np.random.default_rng(seed)
    gram_map = {g: rng.normal(size=len(LANGS)).tolist() for g in GRAM_KEYS}
    return LanguageDetectorModel.from_gram_map(gram_map, (2, 3), LANGS, device="cpu")


def _models(seed, n=3):
    return [_model(seed)] * n


def _want(model, texts=TEXTS):
    return model.runner.score(texts_to_bytes(texts))


def _labels(model, texts=TEXTS):
    return [LANGS[int(i)] for i in model.runner.predict_ids(texts_to_bytes(texts))]


ROUTER_KW = dict(
    probe_interval_ms=30.0, probe_timeout_s=2.0, dispatch_attempts=3,
    breaker_threshold=2, breaker_cooldown_s=0.15, drain_timeout_s=5.0,
    # These drills kill replicas under the same three TEXTS again and
    # again; a live quarantine table would rightly call them queries of
    # death. tests/test_torch_storm.py drives quarantine itself.
    quarantine=QuarantineTable(0, name="fleet-test-off"),
)


def _fleet(seed=1, *, clock=None, router_kw=None, **batcher_kw):
    batcher_kw.setdefault("max_wait_ms", 2)
    batcher_kw.setdefault("max_rows", 64)
    kw = {**ROUTER_KW, **(router_kw or {})}
    if clock is not None:
        kw["clock"] = clock
    return ServeFleet(_models(seed), device="cpu", router_kw=kw, **batcher_kw)


@pytest.fixture()
def clock():
    return FakeClock()


@pytest.fixture()
def fleet(clock):
    fl = _fleet(clock=clock)
    fl.start(probe=False)  # tests drive probe_once()
    try:
        yield fl
    finally:
        fl.close()
        _release_ports()


def _counter(name, registry=REGISTRY):
    return int(registry.snapshot()["counters"].get(name, 0))


_HELD_PORTS: dict[int, socket.socket] = {}


def _kill(rep):
    """Kill a replica and keep its port bound, not listening, until
    :func:`_revive`: connections are refused, as a dead process's are, and
    no other process on the machine can bind the port meanwhile (a server
    there would answer in the dead replica's place)."""
    rep.kill()
    hold = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    hold.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    hold.bind(rep.address)
    _HELD_PORTS[id(rep)] = hold


def _revive(rep):
    _HELD_PORTS.pop(id(rep)).close()
    rep.revive()


def _release_ports():
    while _HELD_PORTS:
        _HELD_PORTS.popitem()[1].close()


def _wait_for(cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.002)


# ----------------------------------------------------- liveness/readiness ---
def test_healthz_split_liveness_vs_readiness():
    registry = ModelRegistry(device="cpu")
    registry.install(_model(5))
    runner = registry.peek().runner
    with ServingServer(registry, port=0, max_wait_ms=2) as server:
        client = ServeClient(*server.address)
        assert client.livez()["live"]
        ready = client.readyz()
        assert ready["ready"] and ready["reasons"] == [] and ready["version"] == "v1"
        old_breaker = runner.breaker
        runner.breaker = CircuitBreaker(failure_threshold=1, cooldown_s=60.0, name="t")
        runner.breaker.record_failure()
        try:
            ready = client.readyz()
            assert not ready["ready"] and "breaker_open" in ready["reasons"]
            with pytest.raises(ServeHTTPError) as exc:
                client._request_once("GET", "/healthz/ready")
            assert exc.value.status == 503
            assert client.livez()["live"]
        finally:
            runner.breaker = old_breaker
        runner._degraded_mode = True
        try:
            assert "degraded" in client.readyz()["reasons"]
        finally:
            runner._degraded_mode = False
        server._draining = True
        ready = client.readyz()
        assert not ready["ready"] and "draining" in ready["reasons"]
        health = client.healthz()
        assert health["ok"] and not health["ready"] and health["draining"]
        server._draining = False
        assert client.readyz()["ready"]


class _GatedRunner:
    """Delegating runner whose dispatches wait on ``gate`` (set by the
    test), counting calls."""

    def __init__(self, runner):
        self.runner = runner
        self.calls = 0
        self.breaker = None
        self.gate = threading.Event()

    def score(self, docs):
        self.calls += 1
        self.gate.wait(30)
        return self.runner.score(docs)

    def predict_ids(self, docs):
        self.calls += 1
        self.gate.wait(30)
        return self.runner.predict_ids(docs)


def test_server_stop_drains_inflight_zero_loss():
    """A stop issued while every request is accepted and the first
    dispatch is held answers them all."""
    registry = ModelRegistry(device="cpu")
    registry.install(_model(6))
    runner = registry.peek().runner
    gated = _GatedRunner(runner)
    batcher = ContinuousBatcher(gated, max_wait_ms=1, max_rows=4, cache_enable=False)
    server = ServingServer(registry, port=0, batcher=batcher).start()
    client = ServeClient(*server.address)
    texts = ["abab", "zz"]
    want = runner.score(texts_to_bytes(texts))
    n = 8
    results: list = [None] * n
    errors: list = []

    def work(i):
        try:
            results[i] = client.score(texts)[0]
        except Exception as e:  # noqa: BLE001 - the test asserts none
            errors.append(f"request {i}: {e!r}")

    REGISTRY.reset()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    _wait_for(lambda: _counter("serve/admitted_requests") >= n and gated.calls >= 1)
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    _wait_for(lambda: server.draining)
    gated.gate.set()
    stopper.join(timeout=30)
    for t in threads:
        t.join(timeout=30)
    batcher.close()
    assert not errors, errors[:3]
    for i, scores in enumerate(results):
        assert scores is not None, f"request {i} dropped"
        np.testing.assert_array_equal(scores, want)


# ------------------------------------------------------- client retries -----
def test_client_retries_503_with_retry_after_bounded():
    registry = ModelRegistry(device="cpu")
    registry.install(_model(7))
    runner = registry.peek().runner
    with ServingServer(registry, port=0, max_wait_ms=2) as server:
        client = ServeClient(*server.address, retry_policy=RetryPolicy(
            max_attempts=3, base_delay_s=0.01, seed=7))
        REGISTRY.reset()
        with faults.plan_scope(FaultPlan.parse("seed=3;serve/admit:error@1")):
            scores, _ = client.score(TEXTS)
        np.testing.assert_array_equal(scores, runner.score(texts_to_bytes(TEXTS)))
        assert _counter("serve/client_retries") == 1
        REGISTRY.reset()
        with faults.plan_scope(FaultPlan.parse("seed=3;serve/admit:error@1-999")):
            with pytest.raises(ServeHTTPError) as exc:
                client.score(TEXTS)
        assert exc.value.status == 503 and exc.value.shed
        assert _counter("serve/client_retries") == 2
        REGISTRY.reset()
        with pytest.raises(ServeHTTPError) as exc:
            client._request("POST", "/score", {"texts": "not-a-list"}, idempotent=True)
        assert exc.value.status == 400
        assert _counter("serve/client_retries") == 0


def test_client_never_retries_504_deadline():
    registry = ModelRegistry(device="cpu")
    registry.install(_model(8))
    gated = _GatedRunner(registry.peek().runner)
    batcher = ContinuousBatcher(gated, max_wait_ms=1, max_rows=8, cache_enable=False)
    server = ServingServer(registry, port=0, batcher=batcher).start()
    try:
        host, port = server.address
        client = ServeClient(host, port, retry_policy=RetryPolicy(
            max_attempts=4, base_delay_s=0.01, seed=1))
        blocker = threading.Thread(target=lambda: ServeClient(host, port).score(["abab"] * 4))
        REGISTRY.reset()
        blocker.start()
        _wait_for(lambda: gated.calls >= 1)  # the dispatcher is held
        with pytest.raises(ServeHTTPError) as exc:
            # Admitted behind the held dispatch: its 1 ms deadline passes
            # in the queue, whatever the host's speed.
            threading.Timer(0.05, gated.gate.set).start()
            client.score(["zz"], deadline_ms=1.0)
        blocker.join(timeout=30)
        assert exc.value.status == 504
        assert _counter("serve/client_retries") == 0
    finally:
        gated.gate.set()
        server.stop()
        batcher.close()


def test_registry_prepare_commit_two_phase():
    registry = ModelRegistry(device="cpu")
    v1 = registry.install(_model(1))
    prep = registry.prepare(_model(2))
    assert registry.current_version() == v1
    v2 = registry.commit(prep)
    assert registry.current_version() == v2 == "v2"
    dup = registry.prepare(_model(3), version="v2")
    with pytest.raises(Exception, match="already registered"):
        registry.commit(dup)
    assert registry.current_version() == v2


# ------------------------------------------------------------- routing -----
def test_router_least_outstanding_with_deterministic_tie_break(fleet):
    router = fleet.router
    assert router.eligible() == ["r0", "r1", "r2"]
    h0 = router._pick(4, set())
    h1 = router._pick(4, set())
    h2 = router._pick(2, set())
    h3 = router._pick(1, set())
    assert [h.name for h in (h0, h1, h2, h3)] == ["r0", "r1", "r2", "r2"]
    for h, rows in ((h0, 4), (h1, 4), (h2, 2), (h3, 1)):
        router._release(h, rows)
    assert router.outstanding("r2") == 0
    h = router._pick(1, {"r0"})
    assert h.name == "r1"
    router._release(h, 1)


def test_router_http_parity_and_failover_on_killed_replica(fleet):
    with RouterServer(fleet.router, fleet=fleet, port=0) as front:
        client = ServeClient(*front.address)
        want = _want(_model(1))
        scores, meta = client.score(TEXTS)
        np.testing.assert_array_equal(scores, want)
        assert meta["version"] == "v1" and meta["replica"] == "r0"
        REGISTRY.reset()
        with pytest.raises(ServeHTTPError) as exc:
            client._request("POST", "/score", {"texts": ["a"], "priority": "vip"})
        assert exc.value.status == 400
        assert _counter("fleet/failovers") == 0
        _kill(fleet.replica("r0"))
        scores, meta = client.score(TEXTS)  # r0 first, dead: failover
        np.testing.assert_array_equal(scores, want)
        assert meta["replica"] != "r0"
        assert _counter("fleet/failovers") >= 1
        labels, _ = client.detect(TEXTS)
        assert labels == _labels(_model(1))


def test_router_ejection_then_half_open_readmission(fleet, clock):
    REGISTRY.reset()
    _kill(fleet.replica("r0"))
    assert "r0:unreachable" in fleet.router.probe_once()
    assert "r0:unreachable:ejected" in fleet.router.probe_once()  # threshold 2
    assert "r0" not in fleet.router.eligible()
    assert _counter("fleet/ejections") == 1
    # Cooling down: not probed, stays ejected.
    assert not any(e.startswith("r0") for e in fleet.router.probe_once())
    clock.t += 0.2
    assert "r0:unreachable" in fleet.router.probe_once()  # half-open probe fails
    assert _counter("fleet/ejections") == 1  # the same outage
    _revive(fleet.replica("r0"))
    clock.t += 0.2
    assert "r0:readmitted" in fleet.router.probe_once()
    assert fleet.router.eligible() == ["r0", "r1", "r2"]
    assert _counter("fleet/readmissions") == 1


def test_router_sheds_fleet_wide_only_when_every_replica_saturated(fleet):
    REGISTRY.reset()
    with faults.plan_scope(FaultPlan.parse("seed=2;serve/admit:error@1")):
        _, meta = fleet.router.score(TEXTS)
    assert meta["replica"] == "r1"
    assert _counter("fleet/replica_saturated") == 1
    assert _counter("fleet/shed_requests") == 0
    with faults.plan_scope(FaultPlan.parse("seed=2;serve/admit:error@1-999")):
        with pytest.raises(FleetSaturated) as exc:
            fleet.router.score(TEXTS)
    assert exc.value.reason == "fleet_saturated" and exc.value.retry_after_s > 0
    assert _counter("fleet/shed_requests") == 1


def test_router_no_ready_replica_is_explicit(fleet):
    for rep in fleet.replicas:
        _kill(rep)
    for _ in range(2):
        fleet.router.probe_once()
    assert fleet.router.eligible() == []
    with pytest.raises(NoReadyReplica) as exc:
        fleet.router.score(TEXTS)
    assert exc.value.reason == "no_ready_replica" and exc.value.retry_after_s > 0


# ------------------------------------------------------ two-phase swap ------
def test_fleet_swap_atomic_under_concurrent_traffic(fleet):
    fleet.router.start()  # the background prober, for this live test
    want = {"v1": _want(_model(1)), "v2": _want(_model(2))}
    n_threads = 4
    streams: list[list] = [[] for _ in range(n_threads)]
    errors: list[str] = []
    stop = threading.Event()

    def work(i):
        while not stop.is_set():
            try:
                scores, meta = fleet.router.score(TEXTS)
            except ServeOverloaded:
                continue
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
                return
            streams[i].append((meta["version"], scores))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    _wait_for(lambda: all(len(s) >= 2 for s in streams) or errors)
    v2 = fleet.swap(models=_models(2))
    _wait_for(lambda: all(sum(v == "v2" for v, _ in s) >= 2 for s in streams) or errors)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:3]
    assert v2 == "v2"
    assert fleet.versions() == {"r0": "v2", "r1": "v2", "r2": "v2"}
    for i, stream in enumerate(streams):
        seen_new = False
        for version, scores in stream:
            np.testing.assert_array_equal(scores, want[version])
            seen_new = seen_new or version == "v2"
            assert version == "v2" or not seen_new, f"stream {i} interleaved v1 after v2"


def test_fleet_swap_refuses_concurrent_coordinator(fleet):
    assert fleet._swap_lock.acquire(blocking=False)
    try:
        with pytest.raises(FleetSwapError, match="in progress"):
            fleet.swap(models=_models(2))
        with pytest.raises(FleetSwapError, match="in progress"):
            fleet.rollback()
    finally:
        fleet._swap_lock.release()
    assert fleet.versions() == {"r0": "v1", "r1": "v1", "r2": "v1"}


def test_fleet_swap_phase1_failure_aborts_everywhere(fleet):
    REGISTRY.reset()
    with faults.plan_scope(FaultPlan.parse("seed=1;fleet/swap:error@2")):
        with pytest.raises(FleetSwapError, match="phase 1"):
            fleet.swap(models=_models(2))
    assert fleet.versions() == {"r0": "v1", "r1": "v1", "r2": "v1"}
    assert fleet.router.pinned_version == "v1"
    assert _counter("fleet/swap_aborts") == 1
    scores, meta = fleet.router.score(TEXTS)
    assert meta["version"] == "v1"
    np.testing.assert_array_equal(scores, _want(_model(1)))


def _crash_phase2(fl):
    """Calls 1-3 prepare, call 4 commits r0, call 5 (r1's commit) crashes."""
    with faults.plan_scope(FaultPlan.parse("seed=1;fleet/swap:error@5")):
        with pytest.raises(FleetSwapError, match="phase 2") as exc:
            fl.swap(models=_models(2))
    return str(exc.value), fl.versions(), fl.router.pinned_version


def test_fleet_swap_phase2_crash_rolls_back_and_replays(fleet):
    REGISTRY.reset()
    msg_a, versions_a, pin_a = _crash_phase2(fleet)
    assert versions_a == {"r0": "v1", "r1": "v1", "r2": "v1"} and pin_a == "v1"
    assert "rolled back" in msg_a
    assert [v["version"] for v in fleet.replicas[0].registry.versions()] == ["v1", "v2"]
    _, meta = fleet.router.score(TEXTS)
    assert meta["version"] == "v1"
    assert _crash_phase2(fleet) == (msg_a, versions_a, pin_a)
    assert _counter("fleet/swap_aborts") == 2
    v_next = fleet.swap(models=_models(3))
    assert set(fleet.versions().values()) == {v_next}
    assert fleet.router.pinned_version == v_next


def test_fleet_http_swap_rollback_and_healthz(fleet, tmp_path):
    with RouterServer(fleet.router, fleet=fleet, port=0) as front:
        client = ServeClient(*front.address)
        model_b = _model(9)
        model_b.save(str(tmp_path / "m2"))
        assert client.swap(str(tmp_path / "m2")) == "v2"
        scores, meta = client.score(TEXTS)
        assert meta["version"] == "v2"
        np.testing.assert_array_equal(scores, _want(model_b))
        health = client.healthz()
        assert health["pinned_version"] == "v2"
        assert [r["replica"] for r in health["replicas"]] == ["r0", "r1", "r2"]
        assert all(r["version"] == "v2" for r in health["replicas"])
        assert client.readyz()["ready"]
        assert client.rollback() == "v1"
        assert client.score(TEXTS)[1]["version"] == "v1"


# -------------------------------------------------- deterministic chaos -----
def _probe_sequence():
    fl = _fleet(clock=FakeClock(), router_kw=dict(breaker_cooldown_s=30.0))
    try:
        with faults.plan_scope(FaultPlan.parse("seed=7;fleet/probe:error%0.4")):
            return [tuple(fl.router.probe_once()) for _ in range(6)]
    finally:
        fl.close()


def test_chaos_fleet_probe_replays_deterministically():
    a = _probe_sequence()
    assert a == _probe_sequence()
    flat = [e for s in a for e in s]
    assert any("unreachable" in e for e in flat) and any("ejected" in e for e in flat)


def _dispatch_sequence(fl, counter):
    fl.start(probe=False)
    try:
        served = []
        with fl_faults(fl).plan_scope(fl_faults(fl).FaultPlan.parse(
                "seed=7;fleet/dispatch:error@1,4")):
            for _ in range(4):
                _, meta = fl.router.score(TEXTS)
                served.append((meta["replica"], counter("fleet/failovers")))
        return served
    finally:
        fl.close()


def fl_faults(fl):
    """The faults module of the package a fleet comes from."""
    if type(fl).__module__.startswith("spark_languagedetector_tpu_torch"):
        return faults
    from spark_languagedetector_tpu.resilience import faults as jfaults

    return jfaults


def test_chaos_fleet_dispatch_replays_deterministically():
    def run():
        REGISTRY.reset()
        fl = _fleet(router_kw=dict(breaker_threshold=5, breaker_cooldown_s=30.0))
        return _dispatch_sequence(fl, _counter)

    a = run()
    assert a == run()
    assert a[0] == ("r1", 1) and a[1][0] == "r0" and a[2] == ("r1", 2) and a[3][1] == 2


# ------------------------------------------------- dynamic membership -------
def test_router_dynamic_membership_add_remove(fleet):
    router = fleet.router
    assert router.remove_replica("r2", drain=True)
    assert router.eligible() == ["r0", "r1"]
    assert router.detect(TEXTS)[1]["replica"] in ("r0", "r1")
    with pytest.raises(ValueError):
        router.remove_replica("r2")
    rep = fleet.add_replica(model=_model(1))
    assert rep.name == "r3" and rep.registry.current_version() == "v1"
    assert sorted(router.eligible()) == ["r0", "r1", "r3"]
    for _ in range(4):
        assert router.detect(TEXTS)[0] == _labels(_model(1))
    with pytest.raises(ValueError):
        router.add_replica(rep, name="r3")


def test_remove_replica_midflight_strands_nothing(fleet):
    router = fleet.router
    h = router._pick(5, {"r1", "r2"})
    assert h.name == "r0" and router.outstanding("r0") == 5
    assert router.remove_replica("r0", drain=True, timeout_s=0.05) is False
    assert "r0" not in router.eligible()
    gauges = REGISTRY.snapshot()["gauges"]
    assert gauges["langdetect_fleet_outstanding_rows"]["replica=r0"] == 0.0
    router._release(h, 5)
    assert h.outstanding_rows == 0
    gauges = REGISTRY.snapshot()["gauges"]
    assert gauges["langdetect_fleet_outstanding_rows"]["replica=r0"] == 0.0
    router.add_replica(fleet.replica("r0"), name="r0")
    assert router.outstanding("r0") == 0 and "r0" in router.eligible()


def test_readd_same_address_gets_fresh_breaker(fleet):
    router = fleet.router
    _kill(fleet.replica("r0"))
    router.probe_once()
    router.probe_once()
    assert router._handle("r0").breaker.state == "open"
    router.remove_replica("r0", drain=False)
    _revive(fleet.replica("r0"))
    router.add_replica(fleet.replica("r0"), name="r0")
    # No clock moved: an inherited open breaker would owe its cooldown.
    assert router._handle("r0").breaker.state == "closed"
    assert "r0" in router.eligible()
    assert router.detect(TEXTS)[1]["replica"] in router.eligible()


def test_fleet_membership_composes_with_swap(fleet):
    fleet.add_replica(model=_model(1))
    assert len(fleet.replicas) == 4
    assert fleet.swap(models=_models(2, 4)) == "v2"
    assert set(fleet.versions().values()) == {"v2"} and fleet.versions()["r3"] == "v2"
    rep = fleet.add_replica(model=_model(2))
    assert rep.registry.current_version() == "v2"
    fleet.remove_replica(rep.name)
    assert rep.name not in fleet.router.eligible()
    fleet.remove_replica("r3", drain=False)
    assert len(fleet.replicas) == 3
    assert fleet.rollback() == "v1"
    assert set(fleet.versions().values()) == {"v1"}


def test_remove_last_replica_refused():
    fl = _fleet(seed=3)
    fl.start(probe=False)
    try:
        for name in ("r1", "r2"):
            fl.remove_replica(name, drain=False)
        with pytest.raises(ValueError):
            fl.remove_replica("r0")
        assert fl.router.eligible() == ["r0"]
    finally:
        fl.close()


# ------------------------------------------- runners of a shared model ------
def _fresh_model(seed):
    rng = np.random.default_rng(seed)
    gram_map = {g: rng.normal(size=len(LANGS)).tolist() for g in GRAM_KEYS}
    return LanguageDetectorModel.from_gram_map(gram_map, (2, 3), LANGS, device="cpu")


def test_swap_builds_one_runner_per_model_and_frees_the_old(monkeypatch):
    """Three replicas share model A: one runner. A swap to a shared model B
    builds one runner, and A's is freed once every replica retired it; a
    rollback rebuilds A's runner once and frees B's."""
    built: list[int] = []
    real = estimator.BatchRunner

    def counting(*a, **kw):
        built.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(estimator, "BatchRunner", counting)
    model_a, model_b = _fresh_model(21), _fresh_model(22)
    fl = ServeFleet([model_a] * 3, device="cpu", router_kw=ROUTER_KW, max_wait_ms=2)
    fl.start(probe=False)
    try:
        assert len(built) == 1
        runner_a = weakref.ref(model_a.runner)
        assert {id(r.registry.peek().runner) for r in fl.replicas} == {id(runner_a())}
        assert fl.swap(models=[model_b] * 3) == "v2"
        gc.collect()
        assert len(built) == 2, "the swap built more than one runner for one model"
        assert runner_a() is None, "the retired runner is still referenced"
        assert model_a._runner is None
        assert {id(r.registry.peek().runner) for r in fl.replicas} == {id(model_b.runner)}
        runner_b = weakref.ref(model_b.runner)
        np.testing.assert_array_equal(fl.router.score(TEXTS)[0], _want(model_b))
        assert fl.rollback() == "v1"
        gc.collect()
        assert len(built) == 3, "the rollback rebuilt the old runner more than once"
        assert runner_b() is None
        assert len({id(r.registry.peek().runner) for r in fl.replicas}) == 1
        np.testing.assert_array_equal(fl.router.score(TEXTS)[0], _want(model_a))
    finally:
        fl.close()


def test_aborted_swap_reuses_the_runner_still_served(monkeypatch):
    """A phase-2 crash re-activates the old version on the flipped replica
    with the runner the others still serve from: no second runner."""
    built: list[int] = []
    real = estimator.BatchRunner
    monkeypatch.setattr(estimator, "BatchRunner",
                        lambda *a, **kw: built.append(1) or real(*a, **kw))
    model_a, model_b = _fresh_model(23), _fresh_model(24)
    fl = ServeFleet([model_a] * 3, device="cpu", router_kw=ROUTER_KW, max_wait_ms=2)
    fl.start(probe=False)
    try:
        with faults.plan_scope(FaultPlan.parse("seed=1;fleet/swap:error@5")):
            with pytest.raises(FleetSwapError, match="phase 2"):
                fl.swap(models=[model_b] * 3)
        assert fl.versions() == {"r0": "v1", "r1": "v1", "r2": "v1"}
        assert len(built) == 2  # A, then B's prepare; no rebuild of A
        assert len({id(r.registry.peek().runner) for r in fl.replicas}) == 1
    finally:
        fl.close()


def test_kill_with_a_queued_request_fails_it_over(fleet):
    """``kill()`` while r0's dispatcher holds one batch and a second request
    waits in its queue: the queued one fails with 503 (its batcher closed)
    and the router replays it on r1; the held one is answered by r0."""
    router = fleet.router
    rep = fleet.replica("r0")
    entry = rep.registry.peek()
    real = entry.runner
    gated = _GatedRunner(real)
    entry.runner = gated
    out: dict = {}

    def ask(key, texts):
        out[key] = router.score(texts)

    for name in ("r1", "r2"):
        router.set_draining(name, True)  # both requests go to r0
    REGISTRY.reset()
    try:
        held = threading.Thread(target=ask, args=("held", ["abab"]))
        held.start()
        _wait_for(lambda: gated.calls >= 1)
        queued = threading.Thread(target=ask, args=("queued", ["zz"]))
        queued.start()
        _wait_for(lambda: rep.server.batcher.stats()["queued_rows"] >= 1)
        for name in ("r1", "r2"):
            router.set_draining(name, False)
        killer = threading.Thread(target=rep.kill)
        killer.start()
        queued.join(timeout=30)
        assert "queued" in out, "the queued request waited for the held dispatch"
        gated.gate.set()
        killer.join(timeout=30)
        held.join(timeout=30)
    finally:
        gated.gate.set()
        entry.runner = real
    assert out["held"][1]["replica"] == "r0" and out["queued"][1]["replica"] == "r1"
    np.testing.assert_array_equal(out["held"][0], _want(_model(1), ["abab"]))
    np.testing.assert_array_equal(out["queued"][0], _want(_model(1), ["zz"]))
    assert _counter("fleet/failovers") == 1


def test_replica_kernel_error_is_named_counted_and_failed_over():
    """A replica whose kernel launch fails answers 500 naming the
    ``KernelLaunchError``; the router counts it and replays on another
    replica's runner, never a plain version."""
    bad, good = _fresh_model(31), _fresh_model(31)

    def broken(docs):
        raise KernelLaunchError("fused_detect: launch failed (simulated)")

    fl = ServeFleet([bad, good, good], device="cpu", router_kw=ROUTER_KW, max_wait_ms=2)
    fl.start(probe=False)
    bad.runner.score = broken
    try:
        REGISTRY.reset()
        with RouterServer(fl.router, fleet=fl, port=0) as front:
            scores, meta = ServeClient(*front.address).score(TEXTS)
        assert meta["replica"] == "r1"
        np.testing.assert_array_equal(scores, _want(good))
        assert _counter("fleet/failovers") == 1
        assert _counter("fleet/replica_kernel_errors") == 1
        assert _counter("serve/dispatch_errors") == 1
        with pytest.raises(ServeHTTPError) as exc:
            ServeClient(*fl.replica("r0").address).score(TEXTS)
        assert exc.value.status == 500 and "KernelLaunchError" in exc.value.payload["error"]
    finally:
        fl.close()


# --------------------------------------------------------- the collector ----
def _snap(replica, pid, counters, hist_values, gauge):
    from spark_languagedetector_tpu_torch.telemetry import Histogram

    h = Histogram()
    for v in hist_values:
        h.record(v)
    return {
        "schema": 1, "ts": 1.0, "identity": {"replica": replica, "pid": pid},
        "counters": counters, "histograms": {"serve/total_s": h.state()},
        "gauges": {"langdetect_serve_queue_rows": [[{}, gauge]]},
    }


def test_merge_snapshots_and_collector_match_jax():
    from spark_languagedetector_tpu.telemetry.aggregate import FleetCollector as JaxCollector
    from spark_languagedetector_tpu.telemetry.aggregate import merge_snapshots as jax_merge
    from spark_languagedetector_tpu.telemetry.registry import Registry as JaxRegistry
    from spark_languagedetector_tpu_torch.telemetry.registry import Registry

    snaps = [
        ("r0", _snap("r0", 10, {"serve/requests": 3, "fleet/x": 1}, [0.1, 0.2], 4.0)),
        ("r1", _snap("r1", 11, {"serve/requests": 5}, [0.3], 2.0)),
    ]
    got, ref = merge_snapshots(snaps), jax_merge(snaps)
    assert got["counters"] == ref["counters"] == {"serve/requests": 8, "fleet/x": 1}
    assert got["gauges"] == ref["gauges"]
    for name in ref["histograms"]:
        assert got["histograms"][name].snapshot() == ref["histograms"][name].snapshot()

    def drive(collector):
        collector.record("r0", snaps[0][1])
        collector.record("r1", snaps[1][1])
        # r0 restarts (new pid): its first generation folds into the base.
        collector.record("r0", _snap("r0", 12, {"serve/requests": 2}, [0.4], 1.0))
        collector.retire("r1")
        assert not collector.scrape("r2", lambda: {"schema": 99})
        agg = collector.aggregate()
        return (collector.counter("serve/requests", include_local=False), agg["counters"],
                agg["histograms"]["serve/total_s"]["count"],
                {k: (v["state"], v["generations"]) for k, v in collector.members().items()},
                {k: v["counters"] for k, v in collector.per_replica().items()},
                collector.scrapes, collector.scrape_failures)

    mine = drive(FleetCollector(registry=Registry()))
    theirs = drive(JaxCollector(registry=JaxRegistry()))
    assert mine == theirs
    assert mine[0] == 3 + 5 + 2


def test_collector_scrape_fault_site_counts_a_failure():
    from spark_languagedetector_tpu_torch.telemetry.registry import Registry

    reg = Registry()
    collector = FleetCollector(registry=reg)
    snap = _snap("r0", 1, {"serve/requests": 1}, [0.1], 1.0)
    with faults.plan_scope(FaultPlan.parse("fleet/scrape:error@1")):
        assert not collector.scrape("r0", lambda: snap)
        assert collector.scrape("r0", lambda: snap)
    assert (collector.scrapes, collector.scrape_failures) == (1, 1)
    assert reg.counters["fleet/agg_scrape_failures"] == 1
    assert collector.freshness_s() >= 0.0


def test_router_front_serves_the_collector_view(fleet):
    collector = FleetCollector()
    REGISTRY.reset()
    with RouterServer(fleet.router, fleet=fleet, port=0, collector=collector) as front:
        client = ServeClient(*front.address)
        for _ in range(3):
            client.detect(TEXTS)
        for rep in fleet.replicas:
            assert collector.scrape(rep.name, ServeClient(*rep.address).telemetryz)
        varz = client.varz()
        assert set(varz["fleet_telemetry"]["replicas"]) == {"r0", "r1", "r2"}
        assert client.healthz()["telemetry"]["scrapes"] == 3
        assert varz["slo"] is None
    with pytest.raises(ValueError, match="slo"):
        RouterServer(fleet.router, port=0, slo=object())


# -------------------------------------------------- across the packages -----
@functools.lru_cache(maxsize=None)
def _saved_jax_models() -> tuple[str, str]:
    """Two JAX-fitted models (exact n = 1..3, three languages, profile 60
    and 40), saved."""
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
    root = tempfile.mkdtemp(prefix="fleet_jax_models_")
    paths = []
    for k, size in (("a", 60), ("b", 40)):
        model = JaxDetector(["en", "de", "fr"], [1, 2, 3], size).fit(
            JaxTable({"lang": labels, "fulltext": texts}))
        model.save(f"{root}/{k}")
        paths.append(f"{root}/{k}")
    return tuple(paths)


XTEXTS = ["the cat sat on the mat", "der hund lief über die straße", "le chat dort", "chat"]


def _packages():
    from spark_languagedetector_tpu.resilience import faults as jfaults
    from spark_languagedetector_tpu.serve.client import ServeClient as JaxClient
    from spark_languagedetector_tpu.serve.fleet import ServeFleet as JaxFleet
    from spark_languagedetector_tpu.serve.quarantine import QuarantineTable as JaxQuarantine
    from spark_languagedetector_tpu.serve.router import RouterServer as JaxFront
    from spark_languagedetector_tpu.telemetry import REGISTRY as JAX_REGISTRY

    return {
        "jax": SimpleNamespace(
            fleet=lambda path, **kw: JaxFleet.from_path(path, **kw), Front=JaxFront,
            Client=JaxClient, Quarantine=JaxQuarantine, faults=jfaults, REGISTRY=JAX_REGISTRY),
        "torch": SimpleNamespace(
            fleet=lambda path, **kw: ServeFleet.from_path(path, device="cpu", **kw),
            Front=RouterServer, Client=ServeClient, Quarantine=QuarantineTable, faults=faults,
            REGISTRY=REGISTRY),
    }


FLEET_COUNTERS = ("fleet/failovers", "fleet/ejections", "fleet/readmissions", "fleet/requests",
                  "fleet/swaps", "fleet/rollbacks", "fleet/dispatches")


def _fleet_script(P, path_a, path_b) -> list:
    """One sequential drill through a router front: every request's
    (kind, replica, version, answer), every probe round's events, and the
    fleet counters at the end."""
    P.REGISTRY.reset()
    clock = FakeClock()
    kw = {**ROUTER_KW, "quarantine": P.Quarantine(0, name="off")}
    fl = P.fleet(path_a, replicas=3, router_kw=kw, max_wait_ms=2, max_rows=64)
    for h in fl.router._handles:
        h.breaker._clock = clock
    fl.start(probe=False)
    rec: list = []
    try:
        with P.Front(fl.router, fleet=fl, port=0) as front:
            client = P.Client(*front.address)

            def ask(kind):
                call = {"score": client.score, "detect": client.detect,
                        "segment": lambda t: client.segment(t, top_k=2)}[kind]
                out, meta = call(XTEXTS)
                rec.append((kind, meta["replica"], meta["version"], out))

            def probe():
                rec.append(("probe", tuple(fl.router.probe_once())))

            probe()
            for kind in ("score", "detect", "segment"):
                ask(kind)
            _kill(fl.replica("r0"))
            ask("detect")  # r0 is first, refused: failover
            probe()  # second failure: ejected
            ask("score")
            clock.t += 0.2
            probe()  # half-open probe of a dead replica
            _revive(fl.replica("r0"))
            clock.t += 0.2
            probe()  # re-admitted
            rec.append(("swap", client.swap(path_b)))
            for kind in ("score", "detect"):
                ask(kind)
            with P.faults.plan_scope(P.faults.FaultPlan.parse("seed=7;fleet/dispatch:error@1")):
                ask("score")
            rec.append(("rollback", client.rollback()))
            ask("detect")
            rec.append(("versions", fl.versions(), fl.router.pinned_version))
    finally:
        fl.close()
        _release_ports()
    snap = P.REGISTRY.snapshot()["counters"]
    rec.append(("counters", {k: int(snap.get(k, 0)) for k in FLEET_COUNTERS}))
    return rec


def _assert_same_answer(kind, got, ref):
    if kind == "score":
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL, rtol=RTOL)
        assert (np.asarray(got).argmax(1) == np.asarray(ref).argmax(1)).all()
    elif kind == "detect":
        assert got == ref
    else:
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert (g["label"], g["rejected"]) == (r["label"], r["rejected"])
            assert [(s["start"], s["end"], s["lang"]) for s in g["spans"]] == [
                (s["start"], s["end"], s["lang"]) for s in r["spans"]]


def test_fleet_script_matches_jax():
    path_a, path_b = _saved_jax_models()
    pk = _packages()
    mine = _fleet_script(pk["torch"], path_a, path_b)
    theirs = _fleet_script(pk["jax"], path_a, path_b)
    assert len(mine) == len(theirs)
    for m, t in zip(mine, theirs):
        if m[0] in ("score", "detect", "segment"):
            assert m[:3] == t[:3], (m[:3], t[:3])
            _assert_same_answer(m[0], m[3], t[3])
        else:
            assert m == t
    counters = mine[-1][1]
    assert counters["fleet/failovers"] >= 2 and counters["fleet/ejections"] == 1
    assert counters["fleet/readmissions"] == 1 and counters["fleet/swaps"] == 1


def test_dispatch_and_probe_chaos_match_jax():
    path_a, _ = _saved_jax_models()
    out = {}
    for name, P in _packages().items():
        P.REGISTRY.reset()
        kw = {**ROUTER_KW, "quarantine": P.Quarantine(0, name="off"),
              "breaker_threshold": 5, "breaker_cooldown_s": 30.0}
        fl = P.fleet(path_a, replicas=3, router_kw=kw, max_wait_ms=2)
        served = _dispatch_sequence(fl, lambda n, r=P.REGISTRY: _counter(n, r))
        fl = P.fleet(path_a, replicas=3, router_kw={**kw, "breaker_threshold": 2}, max_wait_ms=2)
        try:
            with P.faults.plan_scope(P.faults.FaultPlan.parse("seed=7;fleet/probe:error%0.4")):
                probes = [tuple(fl.router.probe_once()) for _ in range(6)]
        finally:
            fl.close()
        out[name] = (served, probes)
    assert out["torch"] == out["jax"]


def test_clients_and_router_fronts_of_both_packages_interoperate():
    """A JAX client against the port's router front and a port client
    against the JAX one answer as the serving runner does."""
    from spark_languagedetector_tpu import LanguageDetectorModel as JaxModel

    path_a, _ = _saved_jax_models()
    pk = _packages()
    jmodel = JaxModel.load(path_a)
    model = LanguageDetectorModel.load(path_a, device="cpu")
    docs = texts_to_bytes(XTEXTS)
    fleets = {}
    for name, P in pk.items():
        fl = P.fleet(path_a, replicas=2, router_kw={**ROUTER_KW,
                     "quarantine": P.Quarantine(0, name="off")}, max_wait_ms=2)
        fleets[name] = fl.start(probe=False)
    try:
        with pk["torch"].Front(fleets["torch"].router, port=0) as front, \
                pk["jax"].Front(fleets["jax"].router, port=0) as jfront:
            for client, m, runner in (
                (pk["jax"].Client(*front.address), model, model.runner),
                (ServeClient(*jfront.address), jmodel, jmodel._get_runner()),
            ):
                scores, meta = client.score(XTEXTS)
                np.testing.assert_array_equal(scores, runner.score(docs))
                assert meta["replica"] == "r0"
                labels, _ = client.detect(XTEXTS)
                assert labels == [m.profile.languages[i] for i in runner.predict_ids(docs)]
                assert client.healthz()["pinned_version"] == "v1"
                with pytest.raises(Exception) as exc:
                    client.detect(XTEXTS, tenant="acme")  # a single-model replica: 400
                assert exc.value.status == 400
    finally:
        for fl in fleets.values():
            fl.close()
