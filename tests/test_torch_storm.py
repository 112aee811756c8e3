"""Storm defense in the port (``device="cpu"``) against the JAX package:
retry budget, deadline decay and floor, hedging, query-of-death quarantine.

* The contracts of ``tests/test_storm.py`` in the port's form: the
  ``RetryBudget`` token bucket (burst start, whole-token spends, capped
  deposits, ``fraction <= 0`` off, exhaustion counted), a router over
  in-memory replicas decaying the remaining deadline into each failover,
  refusing dispatch below the floor, drawing failovers from the budget and
  quarantining a query of death after K deaths; the ``QuarantineTable``'s
  threshold, DLQ rows, LRU bound, out-of-band death reports and off switch;
  ``signature_of``; the client's retry sleeps bounded by the request's
  deadline and drawn from a budget; seeded ``fleet/hedge`` and
  ``fleet/quarantine`` chaos replayed, the quarantine degrading open.
* The storm drill of the JAX bench (``bench.py`` ``smoke_storm``) at a small
  size on a three-replica fleet behind the router's HTTP front, in both
  packages on one JAX-fitted model: the poison batch quarantined after
  exactly two deaths and refused with 422 before any dispatch and into the
  DLQ, the control batch answered, a request under the deadline floor 504;
  an outage under ``RetryBudget(burst=1)``: one failover granted, the next
  denied, dispatches within ``offered·(1 + fraction) + burst``; hedging
  against a seeded straggler plan cuts the tail; under overload with a
  drained budget no hedge fires and each request is answered or shed with
  Retry-After. Both packages give the same outcomes, counters, quarantine
  and budget states, labels identical.
* Across the packages on the same inputs: ``signature_of`` hex, the
  budget's grant sequence and balance, the quarantine table's sequences
  under chaos plans, the in-memory router's attempts and deadlines.
"""

import functools
import socket
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest

from spark_languagedetector_tpu_torch import LanguageDetectorModel
from spark_languagedetector_tpu_torch.ops.encoding import texts_to_bytes
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.resilience.policy import RetryBudget, RetryPolicy
from spark_languagedetector_tpu_torch.serve import (
    FleetRouter,
    FleetSaturated,
    QuarantineTable,
    QueryQuarantined,
    RouterServer,
    ServeClient,
    ServeFleet,
    ServeHTTPError,
    signature_of,
)
from spark_languagedetector_tpu_torch.serve.batcher import ServeDeadlineExceeded
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

LANGS = ("x", "y", "z")
GRAM_KEYS = (b"ab", b"bc", b"zz", b"abc", b"zza")
TEXTS = ["abab", "zz", "abczz"]


@functools.lru_cache(maxsize=None)
def _model(seed=0):
    rng = np.random.default_rng(seed)
    gram_map = {g: rng.normal(size=len(LANGS)).tolist() for g in GRAM_KEYS}
    return LanguageDetectorModel.from_gram_map(gram_map, (2, 3), LANGS, device="cpu")


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


def _jax():
    from spark_languagedetector_tpu.resilience import faults as jfaults
    from spark_languagedetector_tpu.resilience.policy import RetryBudget as JaxBudget
    from spark_languagedetector_tpu.resilience.policy import RetryPolicy as JaxPolicy
    from spark_languagedetector_tpu.serve.batcher import ServeDeadlineExceeded as JaxDeadline
    from spark_languagedetector_tpu.serve.client import ServeClient as JaxClient
    from spark_languagedetector_tpu.serve.client import ServeHTTPError as JaxHTTPError
    from spark_languagedetector_tpu.serve.fleet import ServeFleet as JaxFleet
    from spark_languagedetector_tpu.serve.quarantine import QuarantineTable as JaxQuarantine
    from spark_languagedetector_tpu.serve.quarantine import QueryQuarantined as JaxQueryQ
    from spark_languagedetector_tpu.serve.quarantine import signature_of as jax_signature
    from spark_languagedetector_tpu.serve.router import FleetRouter as JaxRouter
    from spark_languagedetector_tpu.serve.router import FleetSaturated as JaxSaturated
    from spark_languagedetector_tpu.serve.router import RouterServer as JaxFront
    from spark_languagedetector_tpu.telemetry import REGISTRY as JAX_REGISTRY

    return SimpleNamespace(
        Budget=JaxBudget, Policy=JaxPolicy, Quarantine=JaxQuarantine, QueryQ=JaxQueryQ,
        signature_of=jax_signature, Router=JaxRouter, Saturated=JaxSaturated,
        Deadline=JaxDeadline, Client=JaxClient, HTTPError=JaxHTTPError, Front=JaxFront,
        fleet=lambda path, **kw: JaxFleet.from_path(path, **kw), faults=jfaults,
        REGISTRY=JAX_REGISTRY)


def _port():
    return SimpleNamespace(
        Budget=RetryBudget, Policy=RetryPolicy, Quarantine=QuarantineTable,
        QueryQ=QueryQuarantined, signature_of=signature_of, Router=FleetRouter,
        Saturated=FleetSaturated, Deadline=ServeDeadlineExceeded, Client=ServeClient,
        HTTPError=ServeHTTPError, Front=RouterServer,
        fleet=lambda path, **kw: ServeFleet.from_path(path, device="cpu", **kw),
        faults=faults, REGISTRY=REGISTRY)


# ------------------------------------------------------- retry budget -------
def _budget_script(Budget) -> list:
    b = Budget(0.5, 2.0, name="t")
    out = [b.enabled]
    for op in "ss" "s" "r" "s" "r" "s" "rrrrr" "ss":
        if op == "s":
            out.append(b.try_spend())
        else:
            b.record_success()
        out.append(b.tokens)
    out.append(b.describe())
    return out


def test_retry_budget_token_bucket_semantics():
    b = RetryBudget(0.5, 2.0, name="t")
    assert b.enabled
    assert b.try_spend() and b.try_spend()
    assert not b.try_spend()
    b.record_success()
    assert not b.try_spend()  # half a token: a retry costs a whole one
    b.record_success()
    assert b.try_spend()
    d = b.describe()
    assert d["successes"] == 2 and d["spent"] == 3 and d["denied"] == 2
    for _ in range(100):
        b.record_success()
    assert b.describe()["tokens"] == 2.0
    gauges = REGISTRY.snapshot()["gauges"]["langdetect_retry_budget_tokens"]
    assert gauges["budget=t"] == 2.0


def test_retry_budget_grant_sequence_matches_jax():
    assert _budget_script(RetryBudget) == _budget_script(_jax().Budget)


def test_retry_budget_fraction_zero_disables():
    b = RetryBudget(0.0, 5.0, name="off")
    assert not b.enabled
    assert all(b.try_spend() for _ in range(50))


def test_retry_budget_exhaustion_counts_and_recovers():
    REGISTRY.reset()
    b = RetryBudget(1.0, 1.0, name="tiny")
    assert b.try_spend()
    assert not b.try_spend()
    assert _counter("fleet/retry_budget_exhausted") == 1
    b.record_success()
    assert b.try_spend()


def test_retry_budget_knobs_resolve_from_the_environment(monkeypatch):
    monkeypatch.setenv("LANGDETECT_RETRY_BUDGET_FRACTION", "0.25")
    monkeypatch.setenv("LANGDETECT_RETRY_BUDGET_BURST", "3")
    b = RetryBudget()
    assert (b.fraction, b.burst, b.tokens) == (0.25, 3.0, 3.0)


# ------------------------------------------- router over fake replicas ------
class _FakeReplicaClient:
    """A handle's client in memory: records each dispatch's deadline and
    answers, or dies like a severed connection for its first calls."""

    def __init__(self, name, *, fail_first=0, sleep_s=0.0):
        self.name = name
        self.deadlines = []
        self.calls = 0
        self.fail_first = fail_first
        self.sleep_s = sleep_s

    def detect(self, texts, *, priority=None, deadline_ms=None, trace_id=None, tenant=None):
        self.calls += 1
        self.deadlines.append(deadline_ms)
        if self.sleep_s:
            time.sleep(self.sleep_s)
        if self.calls <= self.fail_first:
            raise ConnectionResetError(f"{self.name} died mid-flight")
        return ["x"] * len(texts), {"version": "v1"}

    score = segment = detect


def _fake_router(fakes, Router=FleetRouter, **router_kw):
    router_kw.setdefault("breaker_threshold", 99)
    router_kw.setdefault("dispatch_attempts", 3)
    router = Router([("127.0.0.1", 1 + i) for i in range(len(fakes))], **router_kw)
    for h, fake in zip(router._handles, fakes):
        h.client = fake
        h.ready = True
        h.reasons = []
    return router


def test_failover_decays_remaining_deadline_not_original():
    REGISTRY.reset()
    fakes = [_FakeReplicaClient("r0", fail_first=9, sleep_s=0.03),
             _FakeReplicaClient("r1", fail_first=9, sleep_s=0.03),
             _FakeReplicaClient("r2")]
    router = _fake_router(fakes, quarantine=QuarantineTable(0))
    labels, meta = router.detect(TEXTS, deadline_ms=500.0)
    assert labels == ["x"] * 3 and meta["replica"] == "r2"
    seen = [f.deadlines[0] for f in fakes]
    assert seen[0] < 500.0
    assert seen[1] <= seen[0] - 25.0 and seen[2] <= seen[1] - 25.0
    assert all(d > 0 for d in seen)


def test_dispatch_refused_below_deadline_floor():
    REGISTRY.reset()
    fakes = [_FakeReplicaClient("r0")]
    router = _fake_router(fakes, deadline_floor_ms=50.0, quarantine=QuarantineTable(0))
    with pytest.raises(ServeDeadlineExceeded):
        router.detect(TEXTS, deadline_ms=40.0)
    assert fakes[0].calls == 0
    assert _counter("fleet/deadline_rejects") == 1


def _budget_router_script(P):
    P.REGISTRY.reset()
    fakes = [_FakeReplicaClient(f"r{i}", fail_first=9) for i in range(3)]
    router = _fake_router(fakes, P.Router, retry_budget=P.Budget(0.1, 1.0, name="t"),
                          quarantine=P.Quarantine(0))
    with pytest.raises(P.Saturated) as exc:
        router.detect(TEXTS)
    return (exc.value.reason, [f.calls for f in fakes],
            _counter("fleet/retry_budget_exhausted", P.REGISTRY),
            _counter("fleet/shed_requests", P.REGISTRY), router.retry_budget.describe())


def test_router_failovers_draw_from_retry_budget():
    mine = _budget_router_script(_port())
    assert mine[0] == "retry_budget_exhausted"
    assert mine[1] == [1, 1, 0]  # r0 died free, r1 took the only token
    assert mine[2:4] == (1, 1)
    assert mine == _budget_router_script(_jax())


def _qod_router_script(P):
    P.REGISTRY.reset()
    table = P.Quarantine(2, name="t")
    fakes = [_FakeReplicaClient("r0", fail_first=2)] + [
        _FakeReplicaClient(f"r{i}") for i in (1, 2)]
    router = _fake_router(fakes, P.Router, quarantine=table)
    out = [router.detect(TEXTS)[0] for _ in range(2)]
    with pytest.raises(P.QueryQ) as exc:
        router.detect(TEXTS)
    out += [exc.value.signature, table.describe()["quarantined"], [f.calls for f in fakes],
            _counter("fleet/quarantine_rejects", P.REGISTRY),
            _counter("fleet/quarantined_signatures", P.REGISTRY), router.detect(["zz"])[0]]
    return out


def test_router_quarantines_query_of_death_after_k_deaths():
    mine = _qod_router_script(_port())
    assert mine[2] == signature_of(TEXTS) and mine[3] == [signature_of(TEXTS)]
    assert sum(mine[4]) == 4  # the 422 burned no replica
    assert mine[5:] == [1, 1, ["x"]]
    assert mine == _qod_router_script(_jax())


# ------------------------------------------------------- quarantine table ---
def test_quarantine_table_thresholds_dlq_and_lru(tmp_path):
    dlq_path = str(tmp_path / "dlq.jsonl")
    t = QuarantineTable(2, 2, dlq_path=dlq_path, name="t")
    sig = signature_of(["boom"])
    assert not t.record_death(sig, replica="r0", texts=["boom"])
    assert not t.check(sig)
    assert t.record_death(sig, replica="r1", texts=["boom"])
    assert t.check(sig)
    rows = t.dlq.records
    assert len(rows) == 1 and rows[0]["row"]["signature"] == sig
    assert rows[0]["row"]["replicas"] == ["router:r0", "router:r1"]
    assert rows[0]["error"] == "query_of_death"
    assert (tmp_path / "dlq.jsonl").read_text().count("\n") == 1
    for i in range(4):
        t.record_death(f"sig{i}")
    assert t.describe()["suspects"] == 2


def test_supervisor_death_report_charges_last_signature():
    t = QuarantineTable(2, name="t")
    sig = signature_of(["killer"])
    t.note_dispatch("r7", sig, ["killer"])
    assert not t.replica_died("r7")
    assert not t.replica_died("r7")  # the same death, reported again
    assert t.describe()["suspects"] == 1 and not t.check(sig)
    t.note_dispatch("r7", sig, ["killer"])
    assert t.replica_died("r7", source="supervisor")
    assert t.check(sig)
    assert not t.replica_died("r8")


def test_quarantine_deaths_zero_disables():
    t = QuarantineTable(0, name="off")
    assert not t.enabled
    sig = signature_of(["boom"])
    assert not any(t.record_death(sig, replica="r0") for _ in range(5))
    assert not t.check(sig) and t.describe()["suspects"] == 0


def test_signature_is_order_sensitive_stable_and_the_jax_hex():
    assert signature_of(["a", "b"]) != signature_of(["b", "a"])
    assert signature_of(["a", "b"]) == signature_of(["a", "b"])
    assert len(signature_of([])) == 16
    jax_sig = _jax().signature_of
    rng = np.random.default_rng(5)
    alphabet = list("abcxyz ßéñ☠日本") + ["\x00", "\U0001f600"]
    for n in range(12):
        texts = ["".join(rng.choice(alphabet, int(rng.integers(0, 40))))
                 for _ in range(int(rng.integers(0, 6)))]
        assert signature_of(texts) == jax_sig(texts)


def _quarantine_sequence(Quarantine, faults_mod, plan):
    t = Quarantine(3, name="t")
    out = []
    with faults_mod.plan_scope(faults_mod.FaultPlan.parse(plan)):
        for i in range(12):
            newly = t.record_death(f"sig{i % 4}")
            d = t.describe()
            out.append((newly, d["suspects"], len(d["quarantined"])))
    return out


def test_chaos_quarantine_prob_replays_and_matches_jax():
    plan = "seed=9;fleet/quarantine:error%0.4"
    a = _quarantine_sequence(QuarantineTable, faults, plan)
    assert a == _quarantine_sequence(QuarantineTable, faults, plan)
    clean = _quarantine_sequence(QuarantineTable, faults, "seed=9")
    assert a[-1][2] < clean[-1][2]  # observations dropped: degraded open
    J = _jax()
    assert a == _quarantine_sequence(J.Quarantine, J.faults, plan)
    assert clean == _quarantine_sequence(J.Quarantine, J.faults, "seed=9")


def test_chaos_quarantine_check_degrades_open():
    t = QuarantineTable(1, name="t")
    sig = signature_of(["boom"])
    t.record_death(sig)
    assert t.check(sig)
    with faults.plan_scope(FaultPlan.parse("seed=1;fleet/quarantine:error@1")):
        assert not t.check(sig)
        assert t.check(sig)


# ------------------------------------------------------- client deadline ----
class _Always503Client(ServeClient):
    def __init__(self, *, retry_after_s, **kw):
        super().__init__("127.0.0.1", 1, **kw)
        self.attempts = 0
        self._retry_after_s = retry_after_s

    def _request_once(self, method, path, payload=None):
        self.attempts += 1
        raise ServeHTTPError(503, {"error": "shed", "shed": True},
                             {"Retry-After": str(self._retry_after_s)})


def test_client_retry_sleep_never_outlives_deadline():
    REGISTRY.reset()
    client = _Always503Client(retry_after_s=30.0, retry_policy=RetryPolicy(
        max_attempts=6, base_delay_s=0.01, max_delay_s=0.05, seed=1))
    t0 = time.monotonic()
    with pytest.raises(ServeHTTPError):
        client.detect(["a"], deadline_ms=150.0)
    assert time.monotonic() - t0 < 2.0
    assert client.attempts == 1
    assert _counter("serve/client_deadline_gaveups") == 1


def test_client_without_deadline_still_retries():
    client = _Always503Client(retry_after_s=0.0, retry_policy=RetryPolicy(
        max_attempts=3, base_delay_s=0.001, max_delay_s=0.002, seed=1))
    with pytest.raises(ServeHTTPError):
        client.detect(["a"])
    assert client.attempts == 3


def test_client_retries_draw_from_budget():
    budget = RetryBudget(0.1, 1.0, name="t")
    assert budget.try_spend()
    client = _Always503Client(retry_after_s=0.0, retry_policy=RetryPolicy(
        max_attempts=5, base_delay_s=0.001, max_delay_s=0.002, seed=1), retry_budget=budget)
    with pytest.raises(ServeHTTPError):
        client.detect(["a"])
    assert client.attempts == 1


def test_client_never_retries_a_422():
    class _Always422(_Always503Client):
        def _request_once(self, method, path, payload=None):
            self.attempts += 1
            raise ServeHTTPError(422, {"error": "q", "quarantined": True}, {})

    client = _Always422(retry_after_s=0.0, retry_policy=RetryPolicy(
        max_attempts=5, base_delay_s=0.001, seed=1))
    with pytest.raises(ServeHTTPError) as exc:
        client.score(["a"])
    assert exc.value.status == 422 and client.attempts == 1


# ------------------------------------------------- chaos replay: hedge ------
HEDGE_KW = dict(
    probe_interval_ms=30.0, probe_timeout_s=2.0, dispatch_attempts=3, breaker_threshold=5,
    breaker_cooldown_s=30.0, drain_timeout_s=5.0, hedge_enable=True,
    # The injected delay (0.6 s) dwarfs an undelayed dispatch, and the
    # hedge delay floor (250 ms) sits between them, so the hedges fired
    # are the plan's, not the host's noise.
    hedge_min_ms=250.0, quarantine=QuarantineTable(0),
)


def _hedge_sequence(plan):
    REGISTRY.reset()
    fl = ServeFleet([_model(1)] * 3, device="cpu", router_kw={
        **HEDGE_KW, "retry_budget": RetryBudget(1.0, 10.0, name="hedge-test")},
        max_wait_ms=2, max_rows=64)
    fl.start(probe=False)
    try:
        want = [LANGS[int(i)] for i in _model(1).runner.predict_ids(texts_to_bytes(TEXTS))]
        out = []
        with faults.plan_scope(FaultPlan.parse(plan)):
            for _ in range(4):
                labels, _ = fl.router.detect(TEXTS)
                out.append((labels == want, _counter("fleet/hedges"),
                            _counter("fleet/hedge_wins"), _counter("fleet/failovers")))
        return out
    finally:
        fl.close()


def test_chaos_hedge_delay_replays_deterministically():
    plan = "seed=7;fleet/dispatch:delay=0.6@2"
    a = _hedge_sequence(plan)
    assert a == _hedge_sequence(plan)
    assert all(right for right, *_ in a)
    assert a[0][1:] == (0, 0, 0) and a[1][1:3] == (1, 1) and a[-1][1:3] == (1, 1)


def test_chaos_hedge_error_kills_hedge_not_answer():
    plan = "seed=3;fleet/dispatch:delay=0.6@1;fleet/hedge:error@1"
    a = _hedge_sequence(plan)
    assert a == _hedge_sequence(plan)
    assert all(right for right, *_ in a)
    assert a[0][1:] == (1, 0, 1)  # the hedge died (a failover); the primary answered
    assert a[-1][1] == 1


# ------------------------------------------------- the storm drill ----------
@functools.lru_cache(maxsize=None)
def _saved_jax_model() -> str:
    from spark_languagedetector_tpu import LanguageDetector as JaxDetector
    from spark_languagedetector_tpu import Table as JaxTable

    rng = np.random.default_rng(3)
    words = {"en": "the cat dog and with sat on mat".split(),
             "de": "der hund und katze mit die straße über".split(),
             "fr": "le chat chien et avec dort sur la".split()}
    texts, labels = [], []
    for i in range(45):
        lang = ("en", "de", "fr")[i % 3]
        texts.append(" ".join(rng.choice(words[lang], int(rng.integers(3, 20)))))
        labels.append(lang)
    model = JaxDetector(["en", "de", "fr"], [1, 2, 3], 60).fit(
        JaxTable({"lang": labels, "fulltext": texts}))
    path = tempfile.mkdtemp(prefix="storm_jax_model_") + "/m"
    model.save(path)
    return path


DOCS = ["the cat sat on the mat", "der hund lief über die straße", "le chat dort sur la",
        "the dog and the cat", "mit der katze", "avec le chien", "on the mat", "die straße"]
STRAGGLE_S = 0.6


def _storm(P, path, tmp) -> dict:
    """The four legs of the storm drill, sequential, manual probes."""
    P.REGISTRY.reset()
    fl = P.fleet(path, replicas=3, router_kw=dict(
        probe_interval_ms=40.0, breaker_threshold=2, breaker_cooldown_s=0.3,
        probe_timeout_s=2.0, drain_timeout_s=5.0, deadline_floor_ms=5.0,
        retry_budget=P.Budget(0.2, 10.0, name="storm"),
        quarantine=P.Quarantine(2, dlq_path=f"{tmp}/dlq.jsonl", name="storm"),
        hedge_enable=False, hedge_quantile=0.05, hedge_min_ms=250.0,
    ), max_wait_ms=4, max_rows=64, max_queue_rows=512)
    fl.start(probe=False)
    router = fl.router
    out: dict = {"answered": [], "gates": {}}
    c = lambda name: _counter(name, P.REGISTRY)  # noqa: E731

    def settle():
        deadline = time.monotonic() + 30
        while any(router.outstanding(h.name) for h in router._handles):
            assert time.monotonic() < deadline, "a dispatch never finished"
            time.sleep(0.005)

    def readmit():
        for h in router._handles:
            h.breaker._opened_at -= 10.0  # the cooldown, elapsed
        router.probe_once()
        return router.eligible()

    try:
        with P.Front(router, fleet=fl, port=0) as front:
            client = P.Client(*front.address)

            def ask(texts, **kw):
                try:
                    got, meta = client.detect(texts, **kw)
                except P.HTTPError as e:
                    return ("http", e.status, bool(e.payload.get("quarantined")),
                            e.retry_after_s > 0)
                out["answered"].append((texts, got))
                return ("ok", meta["replica"])

            # Leg 1: the query of death.
            poison = [f"query of death {i} ☠" for i in range(4)]
            _kill(fl.replica("r0"))
            out["leg1"] = [ask(poison), ask(poison)]
            q = router.quarantine.describe()
            out["leg1"] += [q["quarantined"] == [P.signature_of(poison)], q["dlq_rows"],
                            c("fleet/dispatches")]
            out["leg1"] += [ask(poison), c("fleet/dispatches"), ask(DOCS[:4]),
                            ask(DOCS[:4], deadline_ms=2.0), c("fleet/deadline_rejects")]
            _revive(fl.replica("r0"))
            out["leg1"].append(readmit())
            # Leg 2: an outage under a nearly empty budget.
            router.retry_budget = P.Budget(0.05, 1.0, name="storm-outage")
            base = c("fleet/dispatches")
            _kill(fl.replica("r0"))
            outcomes = [ask(DOCS[i % 6:i % 6 + 3]) for i in range(10)]
            out["leg2"] = (outcomes, c("fleet/dispatches") - base,
                           router.retry_budget.describe(), c("fleet/retry_budget_exhausted"))
            _revive(fl.replica("r0"))
            out["leg2_readmitted"] = readmit()
            # Leg 3: a straggler plan, hedging off then on.
            router.retry_budget = P.Budget(0.5, 10.0, name="storm-hedge")
            plan = f"seed=11;fleet/dispatch:delay={STRAGGLE_S}@2,5"

            def leg3():
                lats = []
                with P.faults.plan_scope(P.faults.FaultPlan.parse(plan)):
                    for i in range(6):
                        t0 = time.perf_counter()
                        ask(DOCS[i:i + 2])
                        lats.append(time.perf_counter() - t0)
                return lats

            lat_off = leg3()
            router.hedge_enable = True
            hedges0 = c("fleet/hedges")
            lat_on = leg3()
            out["leg3"] = (max(lat_off) >= STRAGGLE_S, max(lat_on) < STRAGGLE_S,
                           c("fleet/hedges") - hedges0, c("fleet/hedge_wins"))
            # The hedges' losers are still sleeping in their injected delay;
            # their admissions would count in the next leg's plan.
            settle()
            # Leg 4: overload with a drained budget: no hedge fires.
            drained = P.Budget(0.05, 1.0, name="storm-overload")
            drained.try_spend(reason="storm_drain")
            router.retry_budget = drained
            hedges0 = c("fleet/hedges")
            with P.faults.plan_scope(P.faults.FaultPlan.parse(
                    f"seed=13;fleet/dispatch:delay={STRAGGLE_S}@2;serve/admit:error@1,3,4")):
                outcomes = [ask(DOCS[i:i + 3]) for i in range(4)]
            out["leg4"] = (outcomes, c("fleet/hedges") - hedges0,
                           c("fleet/retry_budget_exhausted"))
    finally:
        fl.close()
        _release_ports()
    return out


def test_storm_drill_matches_jax(tmp_path):
    path = _saved_jax_model()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    mine = _storm(_port(), path, tmp_path / "port")
    theirs = _storm(_jax(), path, tmp_path / "jax")
    # Leg 1: two deaths quarantine the poison (answered by r1 each time);
    # the third send is a 422 that dispatches nothing; the control batch
    # is answered; under the floor, a 504.
    leg1 = mine["leg1"]
    assert leg1[:2] == [("ok", "r1"), ("ok", "r1")]
    assert leg1[2] is True and leg1[3] == 1
    assert leg1[5] == ("http", 422, True, False) and leg1[6] == leg1[4]
    assert leg1[7][0] == "ok" and leg1[8][:2] == ("http", 504) and leg1[9] == 1
    assert leg1[10] == ["r0", "r1", "r2"]
    assert (tmp_path / "port" / "dlq.jsonl").read_text().count("\n") == 1
    # Leg 2: one failover took the only token, the next was denied; the
    # dispatches stay within offered * (1 + fraction) + burst.
    outcomes, dispatches, budget, exhausted = mine["leg2"]
    assert sum(o[0] == "ok" for o in outcomes) >= len(outcomes) - 1
    assert ("http", 503, False, True) in outcomes
    assert dispatches <= len(outcomes) * 1.05 + 1.0
    assert budget["spent"] == 1 and budget["denied"] >= 1 and exhausted >= 1
    # Leg 3: the hedges rescued the stragglers' tail.
    assert mine["leg3"][:2] == (True, True) and mine["leg3"][2] >= 1
    # Leg 4: no hedge under overload; every request answered or shed.
    outcomes, hedges, _ = mine["leg4"]
    assert hedges == 0
    assert all(o[0] == "ok" or o[1:] == (503, False, True) for o in outcomes)
    # The JAX package ran the same drill to the same outcomes.
    for key in ("leg1", "leg2", "leg2_readmitted", "leg3", "leg4"):
        assert mine[key] == theirs[key], (key, mine[key], theirs[key])
    # Every answer is the runner's, in both packages.
    model = LanguageDetectorModel.load(path, device="cpu")
    langs = model.profile.languages
    for texts, got in mine["answered"] + theirs["answered"]:
        assert got == [langs[i] for i in model.runner.predict_ids(texts_to_bytes(texts))]
