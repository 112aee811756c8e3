"""The port's multi-tenant model zoo (``device="cpu"``) against its runner and
the JAX package's zoo.

* The contracts of ``tests/test_zoo.py`` in the port's form (all but the
  three ``telemetry/compare`` cases, which wait for that module): each
  tenant answered by its own model, the default tenant for no tenant,
  unknown and malformed names refused, a cross-tenant runtime refused and
  counted; LRU eviction under the model and byte budgets (a single tenant
  may exceed the byte budget), never of a leased tenant, cold reloads with
  the same answers, ``preload``; a ``zoo/load`` fault shedding only its
  tenant, replayed; a disk-backed tenant paged out fully; a noisy tenant
  shedding only its own quota lane; the queue-local shed tallies; a
  tenant-scoped refit moving only its tenant; rollback then eviction
  reloading the rolled-back model; an install on a paged-out tenant landing
  at its next cold load; the HTTP surface (tenant routing and stamp, the
  default tenant bit for bit a single-model server, a single-model server's
  400 to a tenant, per-tenant ``healthz``/``varz``, tenant-scoped admin
  swap and rollback, the router front passing the tenant through and
  refusing it on fleet admin, a request racing its tenant's eviction
  answered).
* The port's own: ``_table_bytes`` is the bytes of every device table
  tensor a runner holds (dense, LUT and cuckoo forms, the bigram and
  histogram operands, int8/int16 tables), counted once per storage; the
  ``zoo/resident_bytes`` gauge is the resident tenants' table bytes; an
  evicted tenant's runner and tables are freed; ``close()`` gives every
  runner back.
* Across the packages: the same tenants (JAX-fitted, saved once, loaded by
  both zoos from disk) under the same request script: the resident set and
  the evictions after each request, versions, labels identical and scores
  in the reduction-order class; ``ResidencyManager`` gives the JAX eviction
  order on the same admits; a JAX client against the port's zoo server and
  a port client against the JAX one.
"""

import dataclasses
import functools
import gc
import itertools
import tempfile
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu_torch import LanguageDetector, LanguageDetectorModel, Table
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.exec.core import AdmissionQueue
from spark_languagedetector_tpu_torch.models.profile import GramProfile
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch, texts_to_bytes
from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec, window_ids_numpy
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.serve import (
    BULK,
    FleetRouter,
    RouterServer,
    ServeClient,
    ServeHTTPError,
    ServeOverloaded,
    ServingServer,
)
from spark_languagedetector_tpu_torch.telemetry import REGISTRY
from spark_languagedetector_tpu_torch.zoo import (
    ModelZoo,
    ResidencyManager,
    TenantLoadShed,
    TenantQuota,
    UnknownTenant,
    ZooError,
)
from spark_languagedetector_tpu_torch.zoo.zoo import _table_bytes

ATOL, RTOL = 1e-4, 1e-5
LANGS = ("l0", "l1", "l2")
TEXTS = ["abab", "xyxy", "ddcc", "axdy"]


@functools.lru_cache(maxsize=None)
def _model(seed: int) -> LanguageDetectorModel:
    """A small tenant-distinct model: one spec, seeded weights."""
    rng = np.random.default_rng(seed)
    gram_map = {(a + b).encode(): rng.random(len(LANGS)).tolist()
                for a, b in itertools.product("abcdxyz", repeat=2)}
    return LanguageDetectorModel.from_gram_map(gram_map, [2], LANGS, device="cpu")


def _zoo(**kw) -> ModelZoo:
    kw.setdefault("max_wait_ms", 2)
    kw.setdefault("max_rows", 64)
    return ModelZoo(device="cpu", **kw)


def _labels(model, texts=TEXTS):
    return model.runner.predict_ids(texts_to_bytes(texts))


def _counter(name: str, registry=REGISTRY) -> int:
    return int(registry.snapshot()["counters"].get(name, 0))


def _ask(rt, texts=TEXTS):
    return rt.batcher.submit(texts_to_bytes(texts), want_labels=True).result(timeout=30)


# ------------------------------------------------------------- routing ------
def test_zoo_routes_each_tenant_to_its_own_model():
    zoo = _zoo()
    models = {f"t{i}": _model(i) for i in range(3)}
    for name, model in models.items():
        zoo.add_tenant(name, model)
    zoo.add_tenant("default", _model(9))
    try:
        for name, model in models.items():
            entry, rt = zoo.runtime(name)
            assert entry.name == name
            got = _ask(rt)
            np.testing.assert_array_equal(got.values, _labels(model))
            assert got.version == "v1"
        assert zoo.runtime(None)[0].name == "default"
    finally:
        zoo.close()


def test_zoo_unknown_tenant_and_name_validation():
    zoo = _zoo()
    zoo.add_tenant("default", _model(0))
    try:
        with pytest.raises(UnknownTenant):
            zoo.runtime("nope")
        assert issubclass(UnknownTenant, ValueError)
        for bad in ("Tenant", "a b", "", "x" * 65, 7):
            with pytest.raises((UnknownTenant, ValueError)):
                zoo.add_tenant(bad, _model(1))
        with pytest.raises(ValueError):
            zoo.add_tenant("default", _model(1))
        with pytest.raises(ValueError):
            zoo.add_tenant("both")
    finally:
        zoo.close()


def test_cross_tenant_mapping_corruption_is_rejected_and_counted():
    zoo = _zoo()
    zoo.add_tenant("a", _model(1))
    zoo.add_tenant("b", _model(2))
    try:
        _, rt_b = zoo.runtime("b")
        before = _counter("zoo/cross_tenant_rejects")
        zoo._entries["a"].runtime = rt_b  # a bookkeeping bug, simulated
        with pytest.raises(ZooError):
            zoo.runtime("a")
        assert _counter("zoo/cross_tenant_rejects") == before + 1
        zoo._entries["a"].runtime = None
    finally:
        zoo.close()


# ----------------------------------------------------------- residency ------
def test_residency_budget_evicts_lru_and_cold_reload_keeps_parity():
    REGISTRY.reset()
    zoo = _zoo(resident_models=2)
    models = {f"t{i}": _model(i) for i in range(4)}
    for name, model in models.items():
        zoo.add_tenant(name, model)
    try:
        for name in ("t0", "t1", "t2", "t3"):
            zoo.runtime(name)
        assert list(zoo.resident()) == ["t2", "t3"]
        assert _counter("zoo/evictions") == 2
        entry, rt = zoo.runtime("t0")
        assert entry.loads == 2 and entry.version == "v1"
        np.testing.assert_array_equal(_ask(rt).values, _labels(models["t0"]))
        assert _counter("zoo/cold_loads") == 5
        gauges = REGISTRY.snapshot()["gauges"]
        assert gauges["langdetect_zoo_resident_models"][""] == 2.0
        assert gauges["langdetect_zoo_resident_bytes"][""] == sum(zoo.resident().values()) > 0
    finally:
        zoo.close()


def test_byte_budget_evicts_and_single_tenant_may_exceed_it():
    zoo = _zoo()
    zoo.add_tenant("probe", _model(0))
    try:
        bytes_of_one = zoo.runtime("probe")[1].table_bytes
    finally:
        zoo.close()
    assert bytes_of_one > 0
    zoo = _zoo(resident_bytes=int(bytes_of_one * 1.5))
    zoo.add_tenant("a", _model(1))
    zoo.add_tenant("b", _model(2))
    try:
        zoo.runtime("a")
        zoo.runtime("b")
        assert list(zoo.resident()) == ["b"]
        zoo.runtime("a")
        assert list(zoo.resident()) == ["a"]
    finally:
        zoo.close()
    zoo = _zoo(resident_bytes=bytes_of_one // 2)
    zoo.add_tenant("big", _model(3))
    try:  # over the budget alone: admitted all the same
        np.testing.assert_array_equal(_ask(zoo.runtime("big")[1]).values, _labels(_model(3)))
        assert list(zoo.resident()) == ["big"]
    finally:
        zoo.close()


def test_eviction_never_touches_a_leased_version():
    zoo = _zoo(resident_models=1)
    zoo.add_tenant("leased", _model(1))
    zoo.add_tenant("other", _model(2))
    try:
        _, rt = zoo.runtime("leased")
        with rt.registry.lease():
            zoo.runtime("other")
            assert set(zoo.resident()) == {"leased", "other"}
            assert zoo._entries["leased"].runtime is rt
        zoo.add_tenant("third", _model(3))
        zoo.runtime("third")
        assert "leased" not in zoo.resident()
    finally:
        zoo.close()


def test_preload_warms_tenants_off_the_serving_path():
    zoo = _zoo()
    for i in range(3):
        zoo.add_tenant(f"t{i}", _model(i))
    try:
        assert zoo.resident() == {}
        assert zoo.preload() == ["t0", "t1", "t2"]
        assert set(zoo.resident()) == {"t0", "t1", "t2"}
        assert zoo.preload() == []
    finally:
        zoo.close()


# ------------------------------------------------------------ cold load -----
def test_zoo_load_fault_degrades_to_tenant_only_shed_and_replays():
    for _ in range(2):
        zoo = _zoo()
        zoo.add_tenant("cold", _model(1))
        zoo.add_tenant("warm", _model(2))
        try:
            with faults.plan_scope(FaultPlan.parse("zoo/load:error@1")):
                before = _counter("zoo/load_errors")
                with pytest.raises(TenantLoadShed) as exc:
                    zoo.runtime("cold")
                assert exc.value.retry_after_s > 0 and exc.value.tenant == "cold"
                assert exc.value.reason == "cold_load"
                assert _counter("zoo/load_errors") == before + 1
                assert zoo.runtime("warm")[0].name == "warm"
                _, rt = zoo.runtime("cold")
                np.testing.assert_array_equal(_ask(rt).values, _labels(_model(1)))
        finally:
            zoo.close()


def test_disk_backed_tenant_pages_fully_and_reloads(tmp_path):
    path = str(tmp_path / "m")
    _model(5).save(path)
    zoo = _zoo(resident_models=1)
    zoo.add_tenant("disk", path=path)
    zoo.add_tenant("mem", _model(6))
    try:
        entry, rt = zoo.runtime("disk")
        want = _ask(rt).values
        zoo.runtime("mem")
        assert entry.runtime is None and entry.model is None
        np.testing.assert_array_equal(_ask(zoo.runtime("disk")[1]).values, want)
        assert zoo.runtime("disk")[1].registry.peek().runner.device.type == "cpu"
    finally:
        zoo.close()


# ------------------------------------------------------- quota lanes --------
def test_noisy_tenant_sheds_itself_never_neighbors():
    zoo = _zoo(max_wait_ms=40, max_rows=8)
    zoo.add_tenant("noisy", _model(1), quota=TenantQuota(max_queue_rows=8))
    zoo.add_tenant("victim", _model(2))
    try:
        _, noisy = zoo.runtime("noisy")
        _, victim = zoo.runtime("victim")
        docs = texts_to_bytes(["abab"] * 4)
        sheds, futs = 0, []
        for _ in range(10):
            try:
                futs.append(noisy.batcher.submit(docs, priority=BULK))
            except ServeOverloaded as e:
                assert e.reason == "queue_full"
                sheds += 1
        assert sheds >= 1
        assert victim.batcher.submit(docs).result(timeout=30).values.shape == (4, len(LANGS))
        assert victim.batcher.stats()["shed_requests"] == 0
        stats = noisy.batcher.stats()
        assert stats["shed_requests"] == sheds and stats["shed_reasons"]["queue_full"] == sheds
        assert _counter("zoo/shed/noisy") >= sheds and _counter("zoo/shed/victim") == 0
        for f in futs:
            f.result(timeout=30)
    finally:
        zoo.close()


def test_admission_queue_local_shed_accounting():
    q = AdmissionQueue(max_rows=4, max_wait_s=0.01, max_queue_rows=4)
    assert q.admit("a", 4, "interactive") == (None, 0.0)
    assert q.admit("b", 4, "interactive")[0] == "queue_full"
    stats = q.stats()
    assert (stats["shed_requests"], stats["shed_rows"], stats["shed_reasons"]) == (
        1, 4, {"queue_full": 1})
    q.close(drain=False)
    assert q.admit("c", 1, "interactive")[0] == "closed"
    assert q.stats()["shed_requests"] == 1


# -------------------------------------------------------- tenant refit ------
def test_tenant_scoped_refit_swaps_exactly_one_tenant():
    zoo = _zoo()
    zoo.add_tenant("learn", _model(1))
    zoo.add_tenant("still", _model(2))
    try:
        zoo.preload()
        est = LanguageDetector(list(LANGS), [1, 2], 80, device="cpu")
        docs = ["aaa bab"] * 5 + ["xxy yxy"] * 5 + ["dcd cdd"] * 5
        labs = ["l0"] * 5 + ["l1"] * 5 + ["l2"] * 5
        ar = zoo.auto_refit("learn", est, refit_every_batches=1, final_refit=False)
        ar.run([Table({"lang": labs, "fulltext": docs})], max_batches=1)
        assert zoo.version("learn") == "v2" and zoo.version("still") == "v1"
        _, rt = zoo.runtime("learn")
        served = rt.registry.peek()
        assert served.version == "v2"
        meta = served.describe()["metadata"]
        assert meta["tenant"] == "learn" and meta["refit_token"] == 1
        np.testing.assert_array_equal(_ask(rt).values, _labels(ar.last_model))
        got2 = _ask(zoo.runtime("still")[1])
        assert got2.version == "v1"
        np.testing.assert_array_equal(got2.values, _labels(_model(2)))
    finally:
        zoo.close()


def test_rollback_then_eviction_reloads_the_rolled_back_model():
    m1, m2 = _model(1), _model(7)
    zoo = _zoo(resident_models=1)
    zoo.add_tenant("a", m1)
    zoo.add_tenant("b", _model(2))
    try:
        zoo.runtime("a")
        assert zoo.install("a", m2) == "v2"
        assert zoo.rollback("a") == "v1"
        zoo.runtime("b")
        assert zoo._entries["a"].runtime is None
        got = _ask(zoo.runtime("a")[1])
        assert got.version == "v1"
        np.testing.assert_array_equal(got.values, _labels(m1))
        assert zoo.install("a", _model(8)) == "v3"
    finally:
        zoo.close()


def test_install_on_paged_out_tenant_lands_on_next_cold_load():
    zoo = _zoo(resident_models=1)
    zoo.add_tenant("a", _model(1))
    zoo.add_tenant("b", _model(2))
    try:
        zoo.runtime("a")
        zoo.runtime("b")
        assert list(zoo.resident()) == ["b"]
        new_model = _model(7)
        assert zoo.install("a", new_model) == "v2" and zoo.version("a") == "v2"
        got = _ask(zoo.runtime("a")[1])
        assert got.version == "v2"
        np.testing.assert_array_equal(got.values, _labels(new_model))
    finally:
        zoo.close()


# ---------------------------------------------------------- HTTP surface ----
@pytest.fixture
def zoo_http():
    zoo = _zoo()
    zoo.add_tenant("default", _model(0))
    zoo.add_tenant("acme", _model(1))
    server = ServingServer(zoo, port=0).start()
    try:
        yield zoo, server, ServeClient(*server.address)
    finally:
        server.stop()


def test_http_tenant_routing_and_response_stamp(zoo_http):
    zoo, server, client = zoo_http
    labels, meta = client.detect(TEXTS, tenant="acme")
    assert meta["tenant"] == "acme" and meta["version"] == "v1"
    want = [LANGS[int(i)] for i in _labels(_model(1))]
    assert labels == want
    pinned = ServeClient(*server.address, tenant="acme")
    labels2, meta2 = pinned.detect(TEXTS)
    assert labels2 == want and meta2["tenant"] == "acme"
    scores, _ = pinned.score(TEXTS)
    np.testing.assert_array_equal(scores, _model(1).runner.score(texts_to_bytes(TEXTS)))
    with pytest.raises(ServeHTTPError) as exc:
        client.detect(TEXTS, tenant="nope")
    assert exc.value.status == 400


def test_http_no_tenant_resolves_default_bit_identically(zoo_http):
    zoo, server, client = zoo_http
    with ServingServer(_model(0), port=0) as single:
        sclient = ServeClient(*single.address)
        scores_zoo, meta_zoo = client.score(TEXTS)
        np.testing.assert_array_equal(scores_zoo, sclient.score(TEXTS)[0])
        assert meta_zoo["tenant"] == "default"
        assert client.detect(TEXTS)[0] == sclient.detect(TEXTS)[0]


def test_http_single_model_server_rejects_tenant_loudly():
    with ServingServer(_model(0), port=0) as server:
        client = ServeClient(*server.address)
        for call in (lambda: client.detect(TEXTS, tenant="acme"),
                     lambda: client.swap("/nowhere", tenant="acme"),
                     lambda: client.rollback(tenant="acme")):
            with pytest.raises(ServeHTTPError) as exc:
                call()
            assert exc.value.status == 400


def test_http_healthz_varz_carry_per_tenant_blocks(zoo_http):
    zoo, server, client = zoo_http
    client.detect(TEXTS, tenant="acme")
    h = client.healthz()
    assert set(h["zoo"]["tenants"]) == {"default", "acme"}
    acme = h["zoo"]["tenants"]["acme"]
    assert acme["resident"] is True and acme["version"] == "v1"
    assert "shed_requests" in acme["batcher"]
    assert h["zoo"]["residency"]["resident_models"] >= 1
    ready = client.readyz()
    assert ready["ready"] is True and ready["tenants"] == 2
    v = client.varz()
    assert v["zoo"]["tenants"]["acme"]["versions"][0]["version"] == "v1"
    assert "langdetect_zoo_resident_models" in v["gauges"]


def test_http_admin_swap_and_rollback_tenant_scoped(zoo_http, tmp_path):
    zoo, server, client = zoo_http
    m = _model(7)
    m.save(str(tmp_path / "m"))
    client.detect(TEXTS, tenant="acme")
    assert client.swap(str(tmp_path / "m"), tenant="acme") == "v2"
    assert zoo.version("acme") == "v2" and zoo.version("default") == "v1"
    labels, meta = client.detect(TEXTS, tenant="acme")
    assert meta["version"] == "v2" and labels == [LANGS[int(i)] for i in _labels(m)]
    assert client.rollback(tenant="acme") == "v1"
    assert zoo.version("acme") == "v1" and zoo.version("default") == "v1"


def test_router_front_forwards_tenant_to_replica(zoo_http):
    zoo, server, client = zoo_http
    router = FleetRouter([server.address], probe_interval_ms=50.0)
    router.start(probe=False)
    try:
        with RouterServer(router, port=0) as front:
            rclient = ServeClient(*front.address, tenant="acme")
            labels, meta = rclient.detect(TEXTS)
            assert meta["tenant"] == "acme"
            assert labels == [LANGS[int(i)] for i in _labels(_model(1))]
            labels0, meta0 = ServeClient(*front.address).detect(TEXTS)
            assert meta0["tenant"] == "default"
            assert labels0 == [LANGS[int(i)] for i in _labels(_model(0))]
            for call in (lambda: rclient.swap("/nowhere"), rclient.rollback):
                with pytest.raises(ServeHTTPError) as exc:
                    call()
                assert exc.value.status == 400
    finally:
        router.close()


def test_http_eviction_race_is_answered_not_dropped(zoo_http):
    zoo, server, client = zoo_http
    stop = threading.Event()
    evictions = []

    def churn():
        while not stop.is_set():
            with zoo._lock:
                if zoo._evictable_locked("acme"):
                    zoo._evict_locked("acme")
                    zoo._residency.drop("acme")
                    evictions.append(1)
            zoo._finish_evictions()
            time.sleep(0.001)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        want = [LANGS[int(i)] for i in _labels(_model(1))]
        got = [client.detect(TEXTS, tenant="acme")[0] for _ in range(20)]
        assert all(g == want for g in got)
    finally:
        stop.set()
        t.join(timeout=5)
    assert evictions


# ------------------------------------------------ table bytes on the card ---
def _docs(seed=0):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(97, 106, int(rng.integers(0, 80))).tolist()) for _ in range(20)]


def _profile(mode, glens, bits=20, seed=1, langs="abcd"):
    rng = np.random.default_rng(seed)
    spec = VocabSpec(mode, glens, bits)
    batch, _ = pad_batch(_docs(), 512)
    seen = np.unique(np.concatenate([window_ids_numpy(batch, n, spec).ravel() for n in glens]))
    ids = np.unique(np.concatenate([rng.choice(seen, len(seen) // 2, replace=False),
                                    rng.choice(spec.id_space_size, 100, replace=False)]))
    return GramProfile(spec=spec, languages=tuple(langs), ids=ids,
                       weights=rng.normal(size=(len(ids), len(langs))))


# The runner's host-side inputs and buffers: the profile's membership as
# given (host arrays or CPU tensors, kept for the ladder's host rung), the
# pinned staging and the host rung's operands. On the card none of them is
# device memory; on the CPU they would be counted with the tables.
_HOST_HELD = ("weights", "lut", "cuckoo", "_host_weights", "_host_lut", "_staging", "_host_ops")


def _held_table_bytes(runner) -> int:
    """Every tensor the runner built, found by walking its attributes (its
    host-side inputs and buffers aside), each storage once."""
    storages = {}

    def walk(v):
        if isinstance(v, torch.Tensor):
            st = v.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))

    for name, value in vars(runner).items():
        if name not in _HOST_HELD:
            walk(value)
    return sum(storages.values())


TABLE_FORMS = [
    (("exact", (1, 2)), "auto", None),
    (("exact", (1, 2, 3)), "auto", None),
    (("hashed", (1, 2, 3, 4, 5), 17), "auto", None),
    (("hashed", (1, 2, 3), 17), "auto", "int8"),
    (("exact", (1, 2, 3)), "auto", "int16"),
    (("exact", (1, 2)), "pallas", None),
    (("exact", (1, 2, 3, 4, 5)), "auto", None),
    (("exact", (3, 4, 5)), "auto", None),
    (("exact", (1, 2, 3, 4, 5)), "gather", None),
    (("hashed", (1, 2, 3), 17), "gather", None),
]


@pytest.mark.parametrize("args,strategy,quant", TABLE_FORMS)
def test_table_bytes_count_the_runners_device_tables(args, strategy, quant):
    profile = _profile(*args)
    w, lut, cuckoo = profile.device_membership(device="cpu")
    runner = BatchRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=profile.spec, device="cpu",
                         strategy=strategy, quantization=quant, length_buckets=(128, 256))
    docs = _docs(3)
    runner.score(docs)
    runner.segment_cells(docs, cell=128)  # builds the gather operands where needed
    got = _table_bytes(runner)
    assert got == _held_table_bytes(runner) > 0
    if runner.strategy == "fused":
        table = runner.table
        assert table.dtype == {None: torch.float32, "int8": torch.int8,
                               "int16": torch.int16}[quant]
        assert got >= table.numel() * table.element_size()


def test_resident_bytes_gauge_is_the_resident_tables_and_eviction_frees_them():
    REGISTRY.reset()
    zoo = _zoo(resident_models=2)
    models = {f"t{i}": LanguageDetectorModel.from_gram_map(
        {(a + b).encode(): np.random.default_rng(i).random(3).tolist()
         for a, b in itertools.product("abcd", repeat=2)}, [2], LANGS, device="cpu")
        for i in range(3)}
    for name, model in models.items():
        zoo.add_tenant(name, model)
    try:
        runner0 = weakref.ref(zoo.runtime("t0")[1].registry.peek().runner)
        zoo.runtime("t1")
        zoo.runtime("t2")  # pages t0 out
        gc.collect()
        assert runner0() is None, "an evicted tenant's runner is still referenced"
        assert models["t0"]._runner is None
        resident = zoo.resident()
        assert list(resident) == ["t1", "t2"]
        live = sum(_held_table_bytes(zoo._entries[n].runtime.registry.peek().runner)
                   for n in resident)
        gauge = REGISTRY.snapshot()["gauges"]["langdetect_zoo_resident_bytes"][""]
        assert gauge == sum(resident.values()) == live
    finally:
        zoo.close()
    assert all(m._runner is None for m in models.values())


# -------------------------------------------------- across the packages -----
def test_residency_manager_eviction_order_matches_jax():
    from spark_languagedetector_tpu.zoo.residency import ResidencyManager as JaxResidency

    def script(Manager):
        m = Manager(max_bytes=300, max_models=3)
        busy = {"t1"}
        out = []
        for name, nbytes in (("t0", 100), ("t1", 100), ("t2", 100), ("t3", 50), ("t0", 120),
                             ("t4", 400), ("t2", 10), ("t5", 10), ("t1", 10)):
            evicted = m.admit(name, nbytes, evictable=lambda n: n not in busy,
                              evict=lambda n: None)
            m.touch("t1")
            out.append((evicted, m.resident(), m.bytes, m.models))
        m.drop("t1")
        out.append(m.describe())
        return out

    assert script(ResidencyManager) == script(JaxResidency)


@functools.lru_cache(maxsize=None)
def _saved_jax_tenants() -> tuple[str, ...]:
    """Three JAX-fitted tenants (exact n = 1..3, three languages), each on
    its own seeded subsample and profile size, saved."""
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
    root = tempfile.mkdtemp(prefix="zoo_jax_tenants_")
    paths = []
    for t, size in enumerate((20, 35, 50)):
        keep = np.sort(np.random.default_rng(100 + t).choice(60, 36, replace=False))
        model = JaxDetector(["en", "de", "fr"], [1, 2, 3], size).fit(JaxTable({
            "lang": [labels[i] for i in keep], "fulltext": [texts[i] for i in keep]}))
        model.save(f"{root}/t{t}")
        paths.append(f"{root}/t{t}")
    return tuple(paths)


XTEXTS = ["the cat sat on the mat", "der hund lief über die straße", "le chat dort", "chat"]
ZOO_SCRIPT = ("t0", "t1", "t0", "t2", "t1", None)


def _zoo_script(Zoo, Client, Server, registry, paths, **zoo_kw) -> list:
    """Each request's (tenant, version, answer, resident set, evictions,
    cold loads) over the script, alternating /detect and /score."""
    registry.reset()
    zoo = Zoo(default_tenant="t0", resident_models=2, prewarm=False, max_wait_ms=2,
              max_rows=64, **zoo_kw)
    for t, path in enumerate(paths):
        zoo.add_tenant(f"t{t}", path=path)
    rec = []
    with Server(zoo, port=0) as server:
        client = Client(*server.address)
        for step, tenant in enumerate(ZOO_SCRIPT):
            call = client.score if step % 2 else client.detect
            out, meta = call(XTEXTS, tenant=tenant)
            counters = registry.snapshot()["counters"]
            rec.append((meta["tenant"], meta["version"], out, list(zoo.resident()),
                        counters.get("zoo/evictions", 0), counters.get("zoo/cold_loads", 0)))
        rec.append(("cross", registry.snapshot()["counters"].get("zoo/cross_tenant_rejects", 0)))
    return rec


def test_zoo_script_matches_jax():
    from spark_languagedetector_tpu.serve.client import ServeClient as JaxClient
    from spark_languagedetector_tpu.serve.server import ServingServer as JaxServer
    from spark_languagedetector_tpu.telemetry import REGISTRY as JAX_REGISTRY
    from spark_languagedetector_tpu.zoo import ModelZoo as JaxZoo

    paths = _saved_jax_tenants()
    # The tenants answer differently, so a cross-tenant answer would show.
    runners = [LanguageDetectorModel.load(p, device="cpu").runner for p in paths]
    scores = [r.score(texts_to_bytes(XTEXTS)) for r in runners]
    assert all(not np.array_equal(scores[a], scores[b]) for a, b in ((0, 1), (0, 2), (1, 2)))
    mine = _zoo_script(ModelZoo, ServeClient, ServingServer, REGISTRY, paths, device="cpu")
    theirs = _zoo_script(JaxZoo, JaxClient, JaxServer, JAX_REGISTRY, paths)
    assert mine[-1] == theirs[-1] == ("cross", 0)
    assert [m[3] for m in mine[:-1]] == [["t0"], ["t0", "t1"], ["t1", "t0"], ["t0", "t2"],
                                        ["t2", "t1"], ["t1", "t0"]]
    assert (mine[-2][4], mine[-2][5]) == (3, 5)
    for step, (m, t) in enumerate(zip(mine[:-1], theirs[:-1])):
        assert (m[0], m[1], m[3], m[4], m[5]) == (t[0], t[1], t[3], t[4], t[5]), step
        own = scores[int(m[0][1])]
        if step % 2:
            np.testing.assert_array_equal(m[2], own)
            np.testing.assert_allclose(m[2], t[2], atol=ATOL, rtol=RTOL)
            assert (np.asarray(m[2]).argmax(1) == np.asarray(t[2]).argmax(1)).all()
        else:
            assert m[2] == t[2] == [("en", "de", "fr")[i] for i in own.argmax(1)]


def test_clients_and_zoo_servers_of_both_packages_interoperate():
    """A JAX client against the port's zoo server answers as the tenant's
    port runner does, bit for bit; a port client against the JAX zoo server
    gets the same labels and scores in the reduction-order class."""
    from spark_languagedetector_tpu.serve.client import ServeClient as JaxClient
    from spark_languagedetector_tpu.serve.server import ServingServer as JaxServer
    from spark_languagedetector_tpu.zoo import ModelZoo as JaxZoo

    paths = _saved_jax_tenants()[:2]
    docs = texts_to_bytes(XTEXTS)
    runners = [LanguageDetectorModel.load(p, device="cpu").runner for p in paths]
    zoo, jzoo = _zoo(prewarm=False), JaxZoo(prewarm=False, max_wait_ms=2, max_rows=64)
    for z in (zoo, jzoo):
        z.add_tenant("default", path=paths[0])
        z.add_tenant("acme", path=paths[1])
    with ServingServer(zoo, port=0) as server, JaxServer(jzoo, port=0) as jserver:
        for client, exact in ((JaxClient(*server.address), True),
                              (ServeClient(*jserver.address), False)):
            for tenant, runner in ((None, runners[0]), ("acme", runners[1])):
                want = runner.score(docs)
                scores, meta = client.score(XTEXTS, tenant=tenant)
                if exact:
                    np.testing.assert_array_equal(scores, want)
                else:
                    np.testing.assert_allclose(scores, want, atol=ATOL, rtol=RTOL)
                assert meta["tenant"] == (tenant or "default")
                labels, _ = client.detect(XTEXTS, tenant=tenant)
                assert labels == [("en", "de", "fr")[i] for i in runner.predict_ids(docs)]
            with pytest.raises(Exception) as exc:
                client.detect(XTEXTS, tenant="nope")
            assert exc.value.status == 400


def test_zoo_close_gives_every_runner_back():
    zoo = _zoo()
    models = [_model(40 + i) for i in range(3)]
    for i, m in enumerate(models):
        zoo.add_tenant(f"t{i}", m)
    zoo.preload()
    refs = [weakref.ref(zoo._entries[f"t{i}"].runtime.registry.peek().runner) for i in range(3)]
    zoo.close()
    gc.collect()
    assert all(r() is None for r in refs)
    with pytest.raises(Exception, match="closed"):
        zoo.runtime("t0")
