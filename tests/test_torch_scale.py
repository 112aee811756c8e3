"""The port's elastic fleet against the JAX package's.

A ``--device cpu`` replica child reaches READY with the JAX package's keys,
answers bit for bit as the direct runner (labels as the JAX model's), is
restarted on its pinned port after a SIGKILL and re-admitted by the
router's breaker without a membership change; spawn exhaustion is bounded
and loud; a stranded child is reaped by the next supervisor, while stale,
foreign and JAX-worker pidfiles are left alone; a ``--device cuda`` child
with no card fails before READY. The ``admitted_rows`` odometer and the
``Autoscaler``'s decisions equal the JAX classes' on the same operations
and scripted signals (hysteresis, clamps, deferral mid-outage, the
min-floor repair, the ``scale/decision`` fault and ``%prob`` replay). An
``ElasticFleet`` scales up on real shed pressure and down on idleness while
traffic flows, and drops no response.

Children spawn without the lattice prewarm and with a fast retry policy,
and every wait is on a condition.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from spark_languagedetector_tpu import LanguageDetectorModel as JaxModel
from spark_languagedetector_tpu.exec.core import AdmissionQueue as JaxQueue
from spark_languagedetector_tpu.exec import config as jconfig
from spark_languagedetector_tpu.resilience import faults as jfaults
from spark_languagedetector_tpu.scale import autoscaler as jautoscaler
from spark_languagedetector_tpu.telemetry import REGISTRY as JAX_REGISTRY
from spark_languagedetector_tpu_torch import LanguageDetectorModel
from spark_languagedetector_tpu_torch.exec import config as exec_config
from spark_languagedetector_tpu_torch.exec.core import AdmissionQueue
from spark_languagedetector_tpu_torch.ops import _kernels
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.resilience.policy import RetryPolicy
from spark_languagedetector_tpu_torch.scale import (
    Autoscaler,
    ElasticFleet,
    ProcessReplica,
    ReplicaSupervisor,
    ScaleSignals,
    SpawnError,
)
from spark_languagedetector_tpu_torch.scale.replica import pinnable_port
from spark_languagedetector_tpu_torch.serve.client import ServeClient, ServeHTTPError
from spark_languagedetector_tpu_torch.serve.router import FleetRouter, RouterServer
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

LANGS = ("x", "y")
GRAM_KEYS = (b"ab", b"bc", b"zz", b"abc")
TEXTS = ["abab", "zz", "abczz", "bcbc"]
READY_KEYS = {"name", "host", "port", "pid", "version", "platform", "ts", "warmup_s",
              "prewarm_mode"}
NEW_KNOBS = ("scale_min", "scale_max", "scale_interval_ms", "scale_up_ticks",
             "scale_down_ticks", "scale_pressure_wait_ms", "scale_idle_rows_per_s",
             "scale_spawn_timeout_s", "scale_max_restarts", "scale_pidfile_dir",
             "compile_cache_dir", "artifact_dir", "bake_on_save")

FAST_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.02, seed=7)
SUP_KW = dict(device="cpu", retry_policy=FAST_RETRY, prewarm=False)


@functools.lru_cache(maxsize=None)
def _model(seed=0):
    rng = np.random.default_rng(seed)
    gram_map = {g: rng.normal(size=2).tolist() for g in GRAM_KEYS}
    return LanguageDetectorModel.from_gram_map(gram_map, (2, 3), LANGS, device="cpu")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("scale_model") / "m"
    _model(0).save(str(path))
    return str(path)


def _counter(name):
    return int(REGISTRY.snapshot()["counters"].get(name, 0))


def _wait(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_scale_and_cold_start_knobs_are_the_jax_knobs():
    for name in NEW_KNOBS:
        mine, ref = exec_config.KNOBS[name], jconfig.KNOBS[name]
        assert (mine.env, mine.kind, mine.default, mine.positive) == (
            ref.env, ref.kind, ref.default, ref.positive), name


# ------------------------------------------------- subprocess lifecycle -----
def test_process_replica_full_lifecycle(model_dir, tmp_path):
    """Spawn through an injected first-attempt failure → READY → answers bit
    for bit the direct runner's → SIGKILL → restart on the pinned port →
    ejection and half-open re-admission with no membership change →
    graceful close with no pidfile left; the capture ends with one terminal
    snapshot (the SIGKILLed process wrote none) holding each kernel's
    launches, none off the card."""
    runner = _model(0).runner
    docs = [t.encode() for t in TEXTS]
    want_scores = runner.score(docs)
    want = [LANGS[int(i)] for i in runner.predict_ids(docs)]
    jax_ids = np.argmax(np.asarray(JaxModel.load(model_dir)._get_runner().score(docs)), axis=1)
    assert want == [LANGS[int(i)] for i in jax_ids]

    sup = ReplicaSupervisor(model_dir, pidfile_dir=str(tmp_path / "pids"),
                            fleet_name=f"t_lifecycle_{os.getpid()}",
                            metrics_dir=str(tmp_path / "metrics"), **SUP_KW)
    try:
        fails0 = _counter("scale/spawn_failures")
        with faults.plan_scope(FaultPlan.parse("scale/spawn:error@1")):
            rep = sup.spawn("r0")
        assert _counter("scale/spawn_failures") - fails0 == 1
        assert rep.alive and rep.address[1] > 0
        # Pinned below the ephemeral range, where no outgoing connection's
        # local end can take it between a death and the restart.
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            assert rep.address[1] < int(f.read().split()[0])
        assert set(rep.last_ready) == READY_KEYS
        assert rep.last_ready["platform"] == "cpu" and rep.last_ready["prewarm_mode"] is None
        assert rep.last_ready["pid"] == rep.pid and rep.last_warmup_s > 0
        assert os.path.exists(str(tmp_path / "pids" / "r0.pid"))

        client = ServeClient(*rep.address)
        assert client.readyz()["ready"]
        got, meta = client.detect(TEXTS)
        assert got == want and meta["version"] == "v1"
        scores, _ = client.score(TEXTS)
        np.testing.assert_array_equal(scores, want_scores)
        assert client.healthz()["batcher"]["admitted_rows"] == 2 * len(TEXTS)

        router = FleetRouter([rep], probe_interval_ms=30.0, breaker_threshold=2,
                             breaker_cooldown_s=0.2, probe_timeout_s=5.0)
        router.probe_once()
        assert router.eligible() == ["r0"]

        port, pid = rep.address[1], rep.pid
        rep.proc.kill()
        assert _wait(lambda: not rep.alive, 15.0)
        assert _wait(rep._eof.is_set, 15.0)
        router.probe_once()
        router.probe_once()
        assert router.eligible() == []

        restarts0 = _counter("scale/restarts")
        assert sup.poll_once() == ["r0:restarted"]
        assert _counter("scale/restarts") - restarts0 == 1
        assert rep.alive and rep.pid != pid
        assert rep.address[1] == port

        time.sleep(0.25)  # the breaker's cooldown
        assert _wait(lambda: "r0:readmitted" in router.probe_once(), 10.0)
        assert router.eligible() == ["r0"]
        assert client.detect(TEXTS)[0] == want

        assert sup.poll_once() == []
        assert sup._restart_streak["r0"] == 0
    finally:
        sup.close()
    assert not rep.alive
    assert os.listdir(str(tmp_path / "pids")) == []
    events = [json.loads(line) for line in
              (tmp_path / "metrics" / "replica-r0.jsonl").read_text().splitlines()]
    terminal = [e for e in events if e["event"] == "telemetry.snapshot"]
    assert len(terminal) == 1 and terminal[0]["counters"]["serve/dispatches"] >= 1
    assert terminal[0]["gauges"]["langdetect_kernel_launches"] == {
        f"kernel={k.name},stage={stage}": 0.0
        for k in _kernels.KERNELS for stage in ("prewarm", "serve")}


def test_a_restart_cannot_bind_its_port_under_an_outgoing_connection(model_dir, tmp_path):
    """Why a replica's port is pinned below the ephemeral range. While a
    replica is dead, an outgoing connection can take its port as its local
    end when the port lies in the ephemeral range (binding port 0 gives
    such a port, as in the JAX package); the restart then cannot bind it
    and the supervisor gives up, the child's bind error in its tail.
    ``pinnable_port`` picks below the range, where the kernel places no
    connection's local end."""
    with socket.socket() as probe:  # a port the kernel hands out as ephemeral
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    listener = socket.create_server(("127.0.0.1", 0))
    sup = ReplicaSupervisor(model_dir, pidfile_dir=str(tmp_path / "pids"),
                            fleet_name=f"t_port_{os.getpid()}", device="cpu", prewarm=False,
                            retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.01,
                                                     max_delay_s=0.02))
    try:
        rep = sup.spawn("r0", port=port)
        assert rep.address[1] == port
        rep.proc.kill()
        assert _wait(lambda: not rep.alive and rep._eof.is_set(), 15.0)
        with socket.socket() as outgoing:
            outgoing.bind(("127.0.0.1", port))
            outgoing.connect(listener.getsockname())
            assert sup.poll_once() == ["r0:gave_up"]
        assert any("Address already in use" in line for line in rep.output_tail())
        assert not rep.alive
    finally:
        sup.close()
        listener.close()
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    assert all(0 < pinnable_port("127.0.0.1") < low for _ in range(16))


def test_cuda_child_without_a_card_fails_before_ready(model_dir):
    rep = ProcessReplica("rc", model_dir, device="cuda", prewarm=False,
                         env={"CUDA_VISIBLE_DEVICES": ""}, spawn_timeout_s=60.0)
    with pytest.raises(SpawnError, match="before READY") as err:
        rep.spawn()
    assert "no CUDA device" in str(err.value)
    assert rep.last_ready is None and not rep.alive


def test_spawn_exhaustion_is_bounded_and_loud(model_dir, tmp_path):
    sup = ReplicaSupervisor(model_dir, pidfile_dir=str(tmp_path / "pids"),
                            fleet_name=f"t_exhaust_{os.getpid()}", **SUP_KW)
    try:
        fails0 = _counter("scale/spawn_failures")
        with faults.plan_scope(FaultPlan.parse("scale/spawn:error@1-9")):
            with pytest.raises(faults.InjectedFault):
                sup.spawn("r0")
        assert _counter("scale/spawn_failures") - fails0 == 3
        assert sup.members == {}
    finally:
        sup.close()


def test_coordinator_sigkill_orphan_reap(model_dir, tmp_path):
    pids = str(tmp_path / "pids")
    sup = ReplicaSupervisor(model_dir, pidfile_dir=pids,
                            fleet_name=f"t_orphan_{os.getpid()}", **SUP_KW)
    rep = sup.spawn("r0")
    assert rep.alive
    sup.abandon()  # the children are not killed; the pidfiles stay
    assert rep.alive and os.listdir(pids) == ["r0.pid"]

    reaped0 = _counter("scale/orphans_reaped")
    sup2 = ReplicaSupervisor(model_dir, pidfile_dir=pids,
                             fleet_name=f"t_orphan_{os.getpid()}", **SUP_KW)
    try:
        assert _counter("scale/orphans_reaped") - reaped0 == 1
        assert _wait(lambda: not rep.alive, 15.0)
        assert os.listdir(pids) == []
    finally:
        sup2.close()


def test_orphan_reap_ignores_stale_foreign_and_jax_pidfiles(tmp_path):
    """A dead pid, a live process that is no replica worker, and a live
    process whose command line names the JAX package's worker module are
    all left alone; only their pidfiles go."""
    pids = tmp_path / "pids"
    pids.mkdir()
    (pids / "dead.pid").write_text('{"pid": 999999999, "name": "dead"}')
    (pids / "self.pid").write_text('{"pid": %d, "name": "self"}' % os.getpid())
    (pids / "garbage.pid").write_text("not json")
    jax_like = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)",
         "spark_languagedetector_tpu.scale.replica"])
    try:
        (pids / "jax.pid").write_text('{"pid": %d, "name": "jax"}' % jax_like.pid)
        reaped0 = _counter("scale/orphans_reaped")
        sup = ReplicaSupervisor("/nonexistent/model", pidfile_dir=str(pids),
                                fleet_name=f"t_stale_{os.getpid()}", **SUP_KW)
        try:
            assert _counter("scale/orphans_reaped") - reaped0 == 0
            assert sorted(os.listdir(str(pids))) == []
            assert jax_like.poll() is None
        finally:
            sup.close()
    finally:
        jax_like.kill()
        jax_like.wait()


# ------------------------------------------------------- admission odometer --
def test_admitted_rows_odometer_equals_jax():
    """The same admissions, dispatches and sheds move the odometer as in
    the JAX queue: up on every admission, never down."""
    seen = []
    for Queue in (JaxQueue, AdmissionQueue):
        q = Queue(max_rows=8, max_wait_s=0.0, max_queue_rows=100)
        trail = [q.stats()["admitted_rows"]]
        for item, rows in (("a", 3), ("b", 2)):
            q.admit(item, rows, "interactive")
            trail.append(q.stats()["admitted_rows"])
        q.next_batch()
        q.done()
        trail.append((q.stats()["queued_rows"], q.stats()["admitted_rows"]))
        q.admit("c", 4, "bulk")
        trail.append(q.stats()["admitted_rows"])
        reason, _ = q.admit("d", 1000, "interactive")  # a shed never arrived
        trail += [reason, q.stats()["admitted_rows"]]
        q.close(drain=False)
        assert q.admit("e", 1, "interactive")[0] == "closed"
        trail.append(q.stats()["admitted_rows"])
        seen.append(trail)
    assert seen[1] == seen[0] == [0, 3, 5, (0, 5), 9, "queue_full", 9, 9]


# ------------------------------------------------------------- autoscaler ----
PKGS = {
    "jax": SimpleNamespace(Autoscaler=jautoscaler.Autoscaler,
                           ScaleSignals=jautoscaler.ScaleSignals, faults=jfaults,
                           registry=JAX_REGISTRY),
    "port": SimpleNamespace(Autoscaler=Autoscaler, ScaleSignals=ScaleSignals, faults=faults,
                            registry=REGISTRY),
}


class FakeFleet:
    """The autoscaler's whole contract: ``check_members()``, ``signals()``,
    ``scale_to(n)`` and ``target``."""

    def __init__(self, pkg, live=1):
        self.target = live
        self.live = live
        self.sig = pkg.ScaleSignals(live=live, ready=live)
        self.scale_calls: list[int] = []

    def check_members(self):
        return []

    def signals(self):
        self.sig.live = self.live
        return self.sig

    def scale_to(self, n):
        self.scale_calls.append(n)
        self.target = n
        self.live = n
        return n


def _scaler(pkg, fleet, **kw):
    kw.setdefault("scale_min", 1)
    kw.setdefault("scale_max", 3)
    kw.setdefault("up_ticks", 2)
    kw.setdefault("down_ticks", 3)
    kw.setdefault("pressure_wait_ms", 50.0)
    kw.setdefault("idle_rows_per_s", 1.0)
    kw.setdefault("interval_ms", 10_000.0)  # ticks driven by hand
    return pkg.Autoscaler(fleet, **kw)


def _hysteresis(pkg):
    fl = FakeFleet(pkg, live=1)
    sc = _scaler(pkg, fl)
    out = []
    for field, value, ticks in (
        ("est_wait_ms", 100.0, 1), ("est_wait_ms", 0.0, 1), ("est_wait_ms", 100.0, 2),
        ("est_wait_ms", 0.0, 0), ("shed_delta", 4, 2), ("shed_delta", 0, 0),
        ("ema_rows_per_s", 0.1, 3), ("ema_rows_per_s", 50.0, 1),
        ("ema_rows_per_s", 0.1, 3), ("slo_burning", True, 3), ("slo_burning", False, 4),
    ):
        setattr(fl.sig, field, value)
        out += [(sc.tick(), fl.target) for _ in range(ticks)]
    return out, fl.scale_calls


def _clamps(pkg):
    fl = FakeFleet(pkg, live=3)
    sc = _scaler(pkg, fl, scale_min=2, scale_max=3)
    fl.sig.est_wait_ms = 1000.0
    out = [sc.tick() for _ in range(10)]
    fl.sig.est_wait_ms = 0.0
    fl.sig.ema_rows_per_s = 0.0
    out += [sc.tick() for _ in range(20)]
    return out, fl.scale_calls, fl.target


def _deferral(pkg):
    fl = FakeFleet(pkg, live=2)
    sc = _scaler(pkg, fl, scale_min=1)
    fl.sig.ema_rows_per_s = 0.0
    fl.sig.breaker_open = True
    out = [sc.tick() for _ in range(10)]
    fl.sig.breaker_open = False
    fl.live = 1
    out.append(sc.tick())
    fl.live = 2
    out += [sc.tick() for _ in range(3)]
    return out, fl.scale_calls


def _min_floor(pkg):
    fl = FakeFleet(pkg, live=2)
    sc = _scaler(pkg, fl, scale_min=2, scale_max=3)
    fl.target = 1  # a member past its restart budget was detached
    fl.live = 1
    return [sc.tick(), sc.tick()], fl.scale_calls, fl.target


def _decision_fault(pkg):
    fl = FakeFleet(pkg, live=1)
    sc = _scaler(pkg, fl, up_ticks=2)
    fl.sig.est_wait_ms = 1000.0
    skips0 = pkg.registry.snapshot()["counters"].get("scale/decision_skips", 0)
    with pkg.faults.plan_scope(pkg.faults.FaultPlan.parse("scale/decision:error@2")):
        out = [sc.tick() for _ in range(3)]
    skips = pkg.registry.snapshot()["counters"].get("scale/decision_skips", 0) - skips0
    return out, fl.scale_calls, skips


def _prob_replay(pkg):
    def run():
        fl = FakeFleet(pkg, live=1)
        sc = _scaler(pkg, fl)
        with pkg.faults.plan_scope(pkg.faults.FaultPlan.parse("seed=11;scale/decision:error%0.4")):
            return [sc.tick() == "skipped" for _ in range(24)]

    first, second = run(), run()
    assert first == second and any(first) and not all(first)
    return first


SCENARIOS = {"hysteresis": _hysteresis, "clamps": _clamps, "deferral": _deferral,
             "min_floor": _min_floor, "decision_fault": _decision_fault,
             "prob_replay": _prob_replay}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_autoscaler_decisions_equal_jax(scenario):
    ref = SCENARIOS[scenario](PKGS["jax"])
    got = SCENARIOS[scenario](PKGS["port"])
    assert got == ref
    flat = str(got)
    if scenario == "hysteresis":
        assert "up" in flat and "down" in flat and got[1] == [2, 3, 2, 1, 2, 1]
    elif scenario == "clamps":
        assert got[1:] == ([2], 2)
    elif scenario == "deferral":
        assert got[0][:11] == ["deferred"] * 11 and got[0][-1] == "down"
    elif scenario == "min_floor":
        assert got == (["up", "hold"], [2], 2)
    elif scenario == "decision_fault":
        assert got == (["hold", "skipped", "up"], [2], 1)


# --------------------------------------------------------- elastic fleet ----
def test_elastic_fleet_scales_up_and_down_without_dropping(model_dir, tmp_path):
    """Real shed pressure (a request past a child's admission bound) scales
    the fleet up; idleness scales it down, drained while traffic flows; a
    supervised restart keeps its router handle. Every request is answered
    with the direct runner's labels or shed explicitly."""
    want = {t: LANGS[int(i)] for t, i in zip(
        TEXTS, _model(0).runner.predict_ids([t.encode() for t in TEXTS]))}
    # The coordinator's registry is the fleet's local member, whose sheds
    # and latencies its SLO reads: start from none, not from whatever the
    # tests before this one left in this process.
    REGISTRY.reset()
    fleet = ElasticFleet(
        model_dir, replicas=1, device="cpu", fleet_name=f"t_elastic_{os.getpid()}",
        pidfile_dir=str(tmp_path / "pids"), prewarm=False,
        child_env={"LANGDETECT_SERVE_QUEUE_ROWS": "4"},
        router_kw=dict(probe_interval_ms=30.0, breaker_threshold=2, breaker_cooldown_s=0.2,
                       probe_timeout_s=10.0, dispatch_attempts=1),
    )
    fleet.supervisor.retry_policy = FAST_RETRY
    fleet.start(probe=False)
    sc = Autoscaler(fleet, scale_min=1, scale_max=2, up_ticks=1, down_ticks=1,
                    pressure_wait_ms=1e6, idle_rows_per_s=1e9, interval_ms=10_000.0)
    answered, errors, stop = [], [], threading.Event()
    try:
        with RouterServer(fleet.router, port=0) as front:
            client = ServeClient(*front.address)
            assert sc.tick() == "hold"  # no pressure; at the floor
            with pytest.raises(ServeHTTPError) as shed:
                client.detect(TEXTS * 2)  # 8 rows past the child's bound of 4
            assert shed.value.status == 503 and shed.value.shed
            assert sc.tick() == "up"  # the tick's scrape sees the shed
            assert fleet.target == 2 and fleet.live_count() == 2
            fleet.router.probe_once()
            assert sorted(fleet.router.eligible()) == ["r0", "r1"]

            def traffic():
                c = ServeClient(*front.address)
                k = 0
                while not stop.is_set():
                    sub = [TEXTS[k % 4], TEXTS[(k + 1) % 4]]
                    try:
                        labels, meta = c.detect(sub)
                        answered.append((sub, labels, meta["replica"]))
                    except Exception as e:  # a dropped response
                        errors.append(repr(e))
                    k += 1

            # Two clients of two rows each: never past a child's bound of 4,
            # and the least-outstanding pick spreads them over both replicas.
            workers = [threading.Thread(target=traffic) for _ in range(2)]
            for w in workers:
                w.start()
            assert _wait(lambda: {r for *_, r in answered} == {"r0", "r1"}, 30.0)
            assert fleet.signals().ema_rows_per_s > 0
            deadline = time.monotonic() + 30.0
            while fleet.target > 1 and time.monotonic() < deadline:
                sc.tick()  # idle at an instant with nothing queued
            assert fleet.target == 1 and fleet.live_count() == 1
            n = len(answered)
            assert _wait(lambda: len(answered) > n + 5, 30.0)
            stop.set()
            for w in workers:
                w.join(timeout=30.0)

            victim = fleet.supervisor.members["r0"]
            victim.proc.kill()
            assert _wait(lambda: not victim.alive, 15.0)
            assert fleet.check_members() == ["r0:restarted"]
            assert [h["replica"] for h in fleet.router.healthz()["replicas"]] == ["r0"]
            time.sleep(0.25)
            assert _wait(lambda: fleet.router.probe_once() is not None
                         and fleet.router.eligible() == ["r0"], 10.0)
            assert client.detect(TEXTS)[0] == [want[t] for t in TEXTS]
    finally:
        stop.set()
        fleet.close()
    assert not errors, errors[:3]
    assert all(labels == [want[t] for t in sub] for sub, labels, _ in answered)
    assert _counter("scale/ups") >= 1 and _counter("scale/downs") >= 1
    assert os.listdir(str(tmp_path / "pids")) == []
