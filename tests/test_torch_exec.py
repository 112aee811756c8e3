"""The port's execution core, knob table and tuning profile against the JAX
package's.

* ``dedup_counted``, ``run_ordered``, ``ordered_prefetch`` (order, errors,
  close) and ``guarded_dispatch`` in the shapes of the JAX package's
  ``tests/test_exec.py``, with the same results and counters;
* knob precedence (explicit > env > profile > default), malformed values
  raising, and ``effective_config()`` holding a subset of the JAX package's
  knobs, each with its spelling and default, every one read by a module of
  the port;
* a tuning profile written by either package loads in the other;
* the pinned staging ring hands a buffer out again only after its copy's
  event (CUDA pieces faked on the CPU; the card itself is exercised by
  ``chip_smoke.py``'s ``runner`` phase).
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu.exec import config as jconfig
from spark_languagedetector_tpu.exec import core as jcore
from spark_languagedetector_tpu.exec.profile import TuningProfile as JaxProfile
from spark_languagedetector_tpu.telemetry import REGISTRY as JREGISTRY
from spark_languagedetector_tpu_torch.exec import config as exec_config
from spark_languagedetector_tpu_torch.exec import core
from spark_languagedetector_tpu_torch.exec.profile import TuningProfile
from spark_languagedetector_tpu_torch.resilience.policy import CircuitBreaker, RetryPolicy
from spark_languagedetector_tpu_torch.telemetry import REGISTRY


# ------------------------------------------------------------- dedup --------
@pytest.mark.parametrize(
    "keys",
    [
        [b"a", b"b", b"c"],
        [b"a", b"b", b"a", b"", b"", b"a", b"c" * 100],
        [(b"x", 1), (b"x", 2), (b"x", 1)],
        [],
        [b"only"],
    ],
)
def test_dedup_counted_equals_jax(keys):
    REGISTRY.reset()
    JREGISTRY.reset()
    size_of = (lambda k: len(k[0])) if keys and isinstance(keys[0], tuple) else len
    got = core.dedup_counted(keys, size_of=size_of)
    ref = jcore.dedup_counted(keys, size_of=size_of)
    if ref is None:
        assert got is None
    else:
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        first, inverse, mult = got
        assert [keys[int(first[j])] for j in inverse] == list(keys)
        assert int(mult.sum()) == len(keys)
    assert REGISTRY.snapshot()["counters"] == JREGISTRY.snapshot()["counters"]
    assert (
        REGISTRY.snapshot()["histograms"]["dedup/unique_ratio"]
        == JREGISTRY.snapshot()["histograms"]["dedup/unique_ratio"]
    )


# ------------------------------------------------------------ run_ordered ---
@pytest.mark.parametrize("workers", [1, 2, 4, 50])
def test_run_ordered_keeps_plan_order(workers):
    plan = list(range(23))
    threads = set()

    def fn(i):
        threads.add(threading.get_ident())
        return i * 3

    assert core.run_ordered(plan, fn, workers) == [i * 3 for i in plan]
    assert core.run_ordered(plan, fn, workers) == jcore.run_ordered(plan, lambda i: i * 3, workers)
    if workers == 1:
        assert threads == {threading.get_ident()}
    assert core.run_ordered([], fn, workers) == []


def test_run_ordered_raises_the_failing_item():
    def fn(i):
        if i == 5:
            raise RuntimeError("boom5")
        return i

    for workers in (1, 3):
        with pytest.raises(RuntimeError, match="boom5"):
            core.run_ordered(range(10), fn, workers)


# ------------------------------------------------------- ordered prefetch ---
def test_ordered_prefetch_orders_results_and_bounds_pulls():
    for depth, workers in ((0, 1), (3, 1), (3, 4)):
        pulled = []

        def src():
            for i in range(20):
                pulled.append(i)
                yield i

        out = []
        gen = core.ordered_prefetch(src(), lambda i: i * i, depth=depth, workers=workers)
        for k, (item, thunk, prefetched, pending) in enumerate(gen):
            assert len(pulled) <= k + 1 + depth  # never more than depth + 1 ahead
            assert item == k and prefetched == (depth > 0)
            assert 1 <= pending <= depth + 1
            out.append(thunk())
        assert out == [i * i for i in range(20)]


def test_ordered_prefetch_surfaces_error_at_the_failing_item():
    def fn(i):
        if i == 3:
            raise RuntimeError("boom3")
        return i

    for depth, workers in ((0, 1), (2, 1), (2, 3)):
        seen = []
        with pytest.raises(RuntimeError, match="boom3"):
            for _, thunk, _, _ in core.ordered_prefetch(range(6), fn, depth=depth,
                                                        workers=workers):
                seen.append(thunk())
        assert seen == [0, 1, 2]


def test_ordered_prefetch_close_stops_worker_and_releases_buffers():
    """``abort_wait=False`` (the fit packer's choice) returns from close
    without joining a worker that is stuck; the default joins the pool."""
    started = []
    gate = threading.Event()

    def produce(i):
        started.append(i)
        if i > 0:
            gate.wait(5)
        return np.full(4096, i, dtype=np.uint8)

    gen = core.ordered_prefetch(range(100), produce, depth=2, abort_wait=False)
    item, thunk, prefetched, _ = next(gen)
    assert item == 0 and prefetched and thunk()[0] == 0
    t0 = time.perf_counter()
    gen.close()  # returns without joining the worker stuck on item 1
    assert time.perf_counter() - t0 < 2.5
    gate.set()
    assert len(started) <= 2

    running, release = threading.Event(), threading.Event()
    finished = []

    def held(i):
        if i == 1:
            running.set()
            release.wait(5)
        finished.append(i)
        return i

    gen = core.ordered_prefetch(range(100), held, depth=2)
    assert next(gen)[1]() == 0
    assert running.wait(5)
    release.set()
    gen.close()  # joins: item 1, running when close began, has finished
    assert 1 in finished


# ----------------------------------------------------- guarded dispatch -----
def test_guarded_dispatch_fast_path_and_recovered_hook():
    policy = RetryPolicy(max_attempts=2, base_delay_s=0.0)
    recovered = []
    out = core.guarded_dispatch(
        lambda: 41, policy=policy, site="score/dispatch",
        breaker=CircuitBreaker(name="t"),
        degraded=lambda cause: pytest.fail("degraded must not run"),
        on_recovered=lambda: recovered.append(1),
    )
    assert out == 41 and recovered == [1]


def test_guarded_dispatch_falls_to_ladder_with_cause_and_raises_deterministic():
    policy = RetryPolicy(max_attempts=1, base_delay_s=0.0)
    causes = []

    def fast():
        raise RuntimeError("transient")

    out = core.guarded_dispatch(
        fast, policy=policy, site="score/dispatch", breaker=CircuitBreaker(name="t2"),
        degraded=lambda cause: causes.append(cause) or "degraded",
    )
    assert out == "degraded" and isinstance(causes[0], RuntimeError)
    with pytest.raises(ValueError):
        core.guarded_dispatch(
            lambda: (_ for _ in ()).throw(ValueError("det")),
            policy=policy, site="score/dispatch", breaker=CircuitBreaker(name="t3"),
            degraded=lambda cause: pytest.fail("deterministic must raise"),
        )


def test_guarded_dispatch_retries_then_succeeds_and_without_ladder_raises():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("blip")
        return "ok"

    retries = []
    out = core.guarded_dispatch(
        flaky, policy=RetryPolicy(max_attempts=2, base_delay_s=0.0), site="s",
        breaker=CircuitBreaker(name="t5"), degraded=lambda c: "ladder",
        on_retry=lambda a, d, e: retries.append(a),
    )
    assert out == "ok" and retries == [1]
    with pytest.raises(RuntimeError, match="always"):
        core.guarded_dispatch(
            lambda: (_ for _ in ()).throw(RuntimeError("always")),
            policy=RetryPolicy(max_attempts=2, base_delay_s=0.0), site="s", degraded=None,
        )


def test_guarded_dispatch_open_breaker_short_circuits():
    clock = [0.0]
    breaker = CircuitBreaker(1, 1000.0, name="t4", clock=lambda: clock[0])
    breaker.record_failure()
    assert breaker.state == "open"
    before = REGISTRY.counters.get("resilience/breaker_short_circuit", 0)
    out = core.guarded_dispatch(
        lambda: pytest.fail("fast path must not run while open"),
        policy=RetryPolicy(max_attempts=1, base_delay_s=0.0), site="score/dispatch",
        breaker=breaker, degraded=lambda cause: "ladder",
    )
    assert out == "ladder"
    assert REGISTRY.counters["resilience/breaker_short_circuit"] == before + 1


def test_plan_and_byte_budget_equal_jax():
    rng = np.random.default_rng(0)
    sizes = rng.integers(0, 20000, 300).tolist()
    buckets = (128, 256, 512, 1024, 2048, 8192)
    for cap in (16, 256, 4096):
        rows_for = lambda p, cap=cap: core.rows_under_byte_budget(p, 1 << 20, cap)
        jrows_for = lambda p, cap=cap: jcore.rows_under_byte_budget(p, 1 << 20, cap)
        got = core.plan_micro_batches([min(s, 8192) for s in sizes], length_buckets=buckets,
                                      rows_for=rows_for)
        ref = jcore.plan_micro_batches([min(s, 8192) for s in sizes], length_buckets=buckets,
                                       rows_for=jrows_for)
        assert len(got) == len(ref)
        for (a, p), (b, q) in zip(got, ref):
            np.testing.assert_array_equal(a, b)
            assert p == q


# ---------------------------------------------------------------- config ----
def test_effective_config_has_the_jax_knob_keys():
    got = exec_config.effective_config(env={})
    ref = jconfig.effective_config(env={})
    # Every knob the port carries is the JAX package's; with the multi-process
    # knobs of parallel.distributed it carries all of them.
    assert set(got["knobs"]) == set(exec_config.KNOBS) <= set(ref["knobs"])
    assert {"tpu_coordinator", "tpu_num_processes", "tpu_process_id"} <= set(got["knobs"])
    for name, entry in got["knobs"].items():
        assert entry == ref["knobs"][name], name
    for env_name, field in got["deprecated_env"].items():
        assert ref["deprecated_env"][env_name] == field
    for name, mine in exec_config.KNOBS.items():
        knob = jconfig.KNOBS[name]
        assert (mine.env, mine.kind, mine.default, mine.tunable, mine.positive) == (
            knob.env, knob.kind, knob.default, knob.tunable, knob.positive
        ), name
    # The port ships only knobs that a module of it reads.
    pkg = Path(exec_config.__file__).parent.parent
    sources = "".join(
        f.read_text() for f in pkg.rglob("*.py") if f.name != "config.py"
    )
    unread = [n for n in exec_config.KNOBS
              if n != "tuning_profile" and f'"{n}"' not in sources]
    assert not unread


def test_knob_precedence_explicit_env_profile_default(tmp_path):
    exec_config.reload_profile()
    path = str(tmp_path / "p.json")
    TuningProfile(tuned={"batch_bytes": 4096, "length_buckets": [128, 512]}).save(path)
    env = {"LANGDETECT_TUNING_PROFILE": path}
    assert exec_config.resolve_with_source("batch_bytes", env=env) == (4096, "profile")
    assert exec_config.resolve_with_source("length_buckets", env=env) == ((128, 512), "profile")
    env["LANGDETECT_BATCH_BYTES"] = "2048"
    assert exec_config.resolve_with_source("batch_bytes", env=env) == (2048, "env")
    assert exec_config.resolve_with_source("batch_bytes", 99, env=env) == (99, "explicit")
    assert exec_config.resolve_with_source("batch_bytes", env={}) == (8 << 20, "default")
    # Non-tunable knobs never read the profile.
    assert exec_config.resolve_with_source("dedup", env=env) == (True, "default")
    for name, raw in (("batch_bytes", "lots"), ("dedup", "maybe"), ("batch_bytes", "-1"),
                      ("length_buckets", "128,100"), ("length_buckets", "256,128")):
        with pytest.raises(ValueError):
            exec_config.resolve(name, env={exec_config.KNOBS[name].env: raw})
    with pytest.raises(ValueError, match="unknown config knob"):
        exec_config.resolve("no_such_knob")
    bad = exec_config.effective_config(env={"LANGDETECT_DEDUP": "maybe"})
    assert "error" in bad["knobs"]["dedup"]
    for raw, want in (("off", False), ("0", False), ("yes", True), ("ON", True)):
        assert exec_config.resolve("dedup", env={"LANGDETECT_DEDUP": raw}) is want
    exec_config.reload_profile()


def test_tuning_profile_loads_across_packages(tmp_path):
    tuned = {"length_buckets": [128, 256, 1024], "batch_bytes": 1 << 22,
             "device_encode": True, "serve_max_wait_ms": 5}
    port_path = str(tmp_path / "port.json")
    jax_path = str(tmp_path / "jax.json")
    TuningProfile(tuned=tuned, created=12.5).save(port_path)
    JaxProfile(tuned=tuned, created=12.5).save(jax_path)
    a, b = JaxProfile.load(port_path), TuningProfile.load(jax_path)
    assert a.version == b.version and a.tuned == b.tuned and a.created == b.created
    assert open(port_path).read() == open(jax_path).read()
    env = {"LANGDETECT_TUNING_PROFILE": jax_path}
    exec_config.reload_profile()
    assert exec_config.resolve("device_encode", env=env) is True
    assert exec_config.resolve("length_buckets", env=env) == (128, 256, 1024)
    exec_config.reload_profile()
    with pytest.raises(ValueError, match="unknown tuned field"):
        TuningProfile(tuned={"batch_rows": 3})
    with pytest.raises(ValueError, match="multiples of 128"):
        TuningProfile(tuned={"length_buckets": [100]})


# --------------------------------------------------------------- staging ----
class _FakeEvent:
    """Stands in for a CUDA event: complete once ``done`` is set."""

    made = []

    def __init__(self):
        self.done = False
        self.waited = False
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        pass

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True
        self.done = True


def test_staging_ring_reuses_a_buffer_only_after_its_copy(monkeypatch):
    """The pinned ring's bookkeeping, with the CUDA pieces faked on the CPU:
    a buffer whose copy has not completed is never handed out again; past
    ``RING_DEPTH`` buffers a take waits on the oldest copy."""
    from spark_languagedetector_tpu_torch.exec import staging

    real_empty = torch.empty
    monkeypatch.setattr(staging.torch, "empty",
                        lambda *a, pin_memory=False, **k: real_empty(*a, **k))
    monkeypatch.setattr(staging.torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(staging.torch.cuda, "current_stream", lambda device=None: None)
    _FakeEvent.made.clear()
    ring = staging.HostStaging("cpu")
    ring.pinned = True  # the CUDA branch, on CPU tensors
    fields = [("batch", np.uint8, (4, 128)), ("lengths", np.int32, (4,))]
    bufs = []
    for i in range(staging.RING_DEPTH):
        st = ring.take(fields)
        st.views["batch"][:] = i
        st.views["lengths"][:] = np.arange(4) + i
        dev = st.to_device()
        assert dev["lengths"].dtype == torch.int32 and dev["batch"].shape == (4, 128)
        assert dev["lengths"].tolist() == [i, i + 1, i + 2, i + 3]
        bufs.append(st._buf)
    # Four copies in flight, all distinct buffers; the fifth take waits on
    # the oldest and reuses exactly that buffer.
    assert len({b.data_ptr() for b in bufs}) == staging.RING_DEPTH
    assert ring.waits == 0
    st = ring.take(fields)
    assert st._buf is bufs[0] and _FakeEvent.made[0].waited and ring.waits == 1
    st.to_device()
    # A completed copy's buffer is reused without waiting.
    _FakeEvent.made[2].done = True
    st = ring.take(fields)
    assert st._buf is bufs[2] and ring.waits == 1
    # A pack that completes keeps its buffer until its copy; a pack that
    # raises returns its buffer at once, and the next take gets it.
    with ring.take(fields) as packed:
        packed.views["batch"][:] = 7
    assert all(packed._buf is not b for b, _ in ring._free[1 << 16])
    with pytest.raises(RuntimeError):
        with ring.take(fields) as failed:
            raise RuntimeError("pack failed")
    assert ring.take(fields)._buf is failed._buf
    packed.to_device()
    assert ring.pinned_bytes >= staging.RING_DEPTH * (1 << 16)


def test_staging_on_the_cpu_hands_out_fresh_buffers():
    from spark_languagedetector_tpu_torch.exec import staging

    ring = staging.HostStaging("cpu")
    a = ring.take([("x", np.int32, (3,))])
    a.views["x"][:] = [1, 2, 3]
    dev = a.to_device()
    b = ring.take([("x", np.int32, (3,))])
    assert b._buf.data_ptr() != a._buf.data_ptr()
    assert dev["x"].tolist() == [1, 2, 3] and ring.pinned_bytes == 0
    host = staging.host_numpy(staging.copy_to_host_async(dev["x"]))
    assert host.tolist() == [1, 2, 3]
