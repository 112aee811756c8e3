"""The port runner's execution layer (``device="cpu"``) against the JAX runner.

* Labels identical to the JAX runner's on the same documents (duplicates,
  chunked long documents, empty and all-miss documents, ``max_score_bytes``)
  with the same ``batch_size``; scores within ``atol=1e-4, rtol=1e-5`` for
  ``gather``, ``fused`` and ``hybrid`` (plain versions). Across the two
  packages not even ``gather`` is bit-exact: XLA's and torch's CPU sums add
  a block's f32 terms in different orders (neither in sequence); within the
  port every bit-exactness claim below holds;
* the deterministic counters (``score/real_bytes``, ``score/capacity_bytes``,
  ``score/wire_bytes``, ``score/wire_docs``, ``score/encoded_batches``,
  ``score/fetch_bytes``, ``exec/len/*``, ``dedup/*``, ``score/retries``)
  equal the JAX runner's, in the padded/ragged and the wire forms;
* within the port, the padded, ragged, wire and ``DocBlock`` forms and two
  dispatch workers give bit-identical results, and dedup on equals dedup
  off (bit for bit on ``gather`` and ``fused``);
* the runner chaos tests of the JAX package's ``tests/test_chaos.py``, with
  the same outcomes;
* a ``KernelLaunchError`` (or ``KernelBuildError``, an OSError of the
  library loader included) in a kernel wrapper propagates with no retry and
  no degraded rung, and on a CUDA device no kernel path takes the ladder;
* ``segment_cells`` takes the same ladder and gives exact cells.
"""

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu.api.runner import BatchRunner as JaxRunner
from spark_languagedetector_tpu.models.profile import GramProfile as JaxProfile
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu.telemetry import REGISTRY as JREGISTRY
from spark_languagedetector_tpu_torch.api import runner as runner_mod
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.exec import pack as pack_mod
from spark_languagedetector_tpu_torch.models.profile import GramProfile
from spark_languagedetector_tpu_torch.ops import KernelBuildError, KernelLaunchError
from spark_languagedetector_tpu_torch.ops import _kernels, score_fused, score_hist
from spark_languagedetector_tpu_torch.ops.encode_device import DocBlock
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, VocabSpec, window_ids_numpy
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.resilience.policy import CircuitBreaker, RetryPolicy
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

ATOL, RTOL = 1e-4, 1e-5
BUCKETS = (128, 256, 2048)
COUNTER_PREFIXES = ("score/real_bytes", "score/capacity_bytes", "score/wire_bytes",
                    "score/wire_docs", "score/encoded_batches", "score/fetch_bytes",
                    "exec/len/", "dedup/", "score/retries")


def _docs(seed=0, n=40):
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(97, 106, int(rng.integers(0, 1500))).tolist()) for _ in range(n)]
    docs += [b"", b"\x00\xff\x00\xff", b"a", b"b" * 128, b"abcdefgh" * 500,
             "é€ab".encode() * 200, bytes(rng.integers(97, 106, 3000).tolist())]
    return docs + docs[:9] + [docs[-3]]  # duplicates, a chunked one included


def _profile(mode, glens, bits=20, seed=1, langs="abcde"):
    rng = np.random.default_rng(seed)
    spec = VocabSpec(mode, glens, bits)
    batch, _ = pad_batch(_docs()[:30], 2048)
    seen = np.unique(np.concatenate([window_ids_numpy(batch, n, spec).ravel() for n in glens]))
    ids = np.unique(np.concatenate([
        rng.choice(seen, len(seen) // 2, replace=False),
        rng.choice(spec.id_space_size, 100, replace=False),
    ]))
    return GramProfile(spec=spec, languages=tuple(langs), ids=ids,
                       weights=rng.normal(size=(len(ids), len(langs))))


PROFILES = {
    "hashed": lambda: _profile("hashed", (1, 2, 3, 4, 5), 17),
    "cuckoo": lambda: _profile("exact", (1, 2, 3, 4, 5)),
}
CASES = [("hashed", "gather"), ("hashed", "fused"), ("hashed", "hybrid"),
         ("cuckoo", "gather"), ("cuckoo", "hybrid")]


def _runner(profile, strategy="gather", **kw):
    w, lut, cuckoo = profile.device_membership(device="cpu")
    kw.setdefault("batch_size", 16)
    kw.setdefault("length_buckets", BUCKETS)
    return BatchRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=profile.spec, device="cpu",
                       strategy=strategy, **kw)


def _jax_runner(profile, **kw):
    jp = JaxProfile(
        spec=JaxVocabSpec(profile.spec.mode, profile.spec.gram_lengths, profile.spec.hash_bits),
        languages=profile.languages, ids=profile.ids, weights=profile.weights,
    )
    w, lut, cuckoo = jp.device_membership()
    kw.setdefault("batch_size", 16)
    kw.setdefault("length_buckets", BUCKETS)
    return JaxRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=jp.spec, strategy="gather", **kw)


def _counters(reg):
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith(COUNTER_PREFIXES)}


def _check(got, ref):
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def profiles():
    return {name: make() for name, make in PROFILES.items()}


@pytest.mark.parametrize("device_encode", [False, True], ids=["padded_ragged", "wire"])
@pytest.mark.parametrize("cap", [None, 300])
@pytest.mark.parametrize("pname,strategy", CASES)
def test_port_runner_equals_jax_runner_with_equal_counters(profiles, pname, strategy, cap,
                                                           device_encode):
    profile = profiles[pname]
    docs = _docs()
    runner = _runner(profile, strategy, max_score_bytes=cap, device_encode=device_encode)
    jrunner = _jax_runner(profile, max_score_bytes=cap, device_encode=device_encode)
    for want_labels in (False, True):
        REGISTRY.reset()
        JREGISTRY.reset()
        if want_labels:
            got, ref = runner.predict_ids(docs), jrunner.predict_ids(docs)
            np.testing.assert_array_equal(got, ref)
            assert got.dtype == np.int32
        else:
            got, ref = runner.score(docs), jrunner.score(docs)
            _check(got, ref)
            assert got.dtype == np.float32 and got.shape == (len(docs), 5)
        assert _counters(REGISTRY) == _counters(JREGISTRY)
    counters = _counters(REGISTRY)
    assert counters["dedup/rows_unique"] < counters["dedup/rows_in"] == len(docs)
    assert any(k.startswith("exec/len/") for k in counters)
    assert (counters.get("score/encoded_batches", 0) > 0) == device_encode


@pytest.mark.parametrize("pname,strategy", CASES)
def test_forms_lanes_workers_and_dedup_are_bit_identical(profiles, pname, strategy, monkeypatch):
    profile = profiles[pname]
    docs = _docs(1)
    unpacks = []
    real_unpack = pack_mod.unpack_ragged

    def counting_unpack(*a):
        unpacks.append(1)
        return real_unpack(*a)

    monkeypatch.setattr(pack_mod, "unpack_ragged", counting_unpack)
    # The padded reference: the size test never picks the ragged form.
    monkeypatch.setattr(pack_mod, "ragged_fit", lambda *a: None)
    base = _runner(profile, strategy, dedup=False, batch_size=64)
    ref_s, ref_l = base.score(docs), base.predict_ids(docs)
    assert not unpacks
    monkeypatch.undo()
    monkeypatch.setattr(pack_mod, "unpack_ragged", counting_unpack)
    variants = {
        "ragged": dict(),
        "wire": dict(device_encode=True),
        "workers": dict(dispatch_workers=2, batch_size=8),
        "dedup": dict(dedup=True),
    }
    for name, kw in variants.items():
        kw = {"batch_size": 64, "dedup": False, **kw}
        r = _runner(profile, strategy, **kw)
        s, lab = r.score(docs), r.predict_ids(docs)
        if name in ("dedup", "workers") and strategy == "hybrid":
            # The f64 histogram contraction may take another reduction
            # order for another batch geometry.
            np.testing.assert_allclose(s, ref_s, atol=ATOL, rtol=RTOL)
        else:
            np.testing.assert_array_equal(s, ref_s, err_msg=name)
        np.testing.assert_array_equal(lab, ref_l, err_msg=name)
    assert unpacks, "the ragged form never ran"
    block = _runner(profile, strategy, batch_size=64, dedup=False)
    np.testing.assert_array_equal(block.score(DocBlock.from_bytes(docs)), ref_s)
    np.testing.assert_array_equal(block.predict_ids(DocBlock.from_bytes(docs)), ref_l)
    capped = _runner(profile, strategy, batch_size=64, max_score_bytes=200)
    np.testing.assert_array_equal(
        capped.score(DocBlock.from_bytes(docs)),
        _runner(profile, strategy, batch_size=64, max_score_bytes=200, dedup=False).score(docs),
    )


def test_dedup_scatters_back_every_duplicate(profiles):
    docs = [b"abc", b"xyz", b"abc", b"", b"", b"abc"]
    runner = _runner(profiles["hashed"], "fused")
    s = runner.score(docs)
    np.testing.assert_array_equal(s[0], s[2])
    np.testing.assert_array_equal(s[0], s[5])
    np.testing.assert_array_equal(s[3], s[4])
    np.testing.assert_array_equal(s, _runner(profiles["hashed"], "fused", dedup=False).score(docs))
    assert runner.score([]).shape == (0, 5) and runner.predict_ids([]).shape == (0,)
    assert runner.score(DocBlock.from_bytes([])).shape == (0, 5)


# ------------------------------------------------- runner chaos (JAX shapes) -
def _fast_policy(**kw):
    kw.setdefault("max_attempts", 2)
    kw.setdefault("base_delay_s", 0.0)
    return RetryPolicy(**kw)


def _chaos_runner(**kw):
    spec = VocabSpec(EXACT, (1, 2))
    rng = np.random.default_rng(3)
    weights = rng.normal(size=(spec.id_space_size, 3)).astype(np.float32)
    kw.setdefault("retry_policy", _fast_policy())
    kw.setdefault("strategy", "gather")
    return BatchRunner(weights=weights, lut=None, spec=spec, batch_size=8, device="cpu", **kw)


def _chaos_docs(n=20, length=100):
    rng = np.random.default_rng(5)
    return [bytes(rng.integers(0, 256, length, dtype=np.uint8)) for _ in range(n)]


def test_runner_injected_dispatch_fault_recovers():
    runner = _chaos_runner()
    docs = _chaos_docs()
    want = runner.score(docs)
    with faults.plan_scope(FaultPlan.parse("score/dispatch:error@2")):
        got = runner.score(docs)
    np.testing.assert_array_equal(got, want)
    assert runner.metrics.snapshot()["counters"]["retries"] == 1
    assert runner.breaker.state == "closed"


def test_runner_injected_pack_fault_falls_to_host_rung():
    REGISTRY.reset()
    want = _chaos_runner().score(_chaos_docs())
    runner = _chaos_runner(device_encode=True, degraded_fallback=True)
    with faults.plan_scope(FaultPlan.parse("score/pack:error")):
        got = runner.score(_chaos_docs())
    np.testing.assert_array_equal(got, want)
    counters = REGISTRY.snapshot()["counters"]
    assert counters.get("resilience/degraded_batches", 0) > 0
    assert counters.get("resilience/degraded_host", 0) > 0
    np.testing.assert_array_equal(runner.score(_chaos_docs()), want)
    np.testing.assert_array_equal(_chaos_runner(device_encode=True).score(_chaos_docs()), want)
    assert REGISTRY.snapshot()["counters"].get("score/encoded_batches", 0) > 0


def test_runner_injected_pack_fault_transient_retries_in_lane():
    runner = _chaos_runner(device_encode=True)
    docs = _chaos_docs()
    want = _chaos_runner().score(docs)
    with faults.plan_scope(FaultPlan.parse("score/pack:error@1")):
        got = runner.score(docs)
    np.testing.assert_array_equal(got, want)
    assert runner.metrics.snapshot()["counters"]["retries"] == 1


def test_runner_injected_fetch_fault_replays():
    runner = _chaos_runner()
    docs = _chaos_docs()
    want = runner.score(docs)
    with faults.plan_scope(FaultPlan.parse("score/fetch:error@1")):
        got = runner.score(docs)
    np.testing.assert_array_equal(got, want)
    assert runner.metrics.snapshot()["counters"]["retries"] == 1


def test_runner_injected_fault_label_path():
    runner = _chaos_runner()
    docs = _chaos_docs() + [b"ab" * 5000]  # a chunked document, too
    want = runner.predict_ids(docs)
    with faults.plan_scope(FaultPlan.parse("score/dispatch:error@1;score/fetch:error@2")):
        got = runner.predict_ids(docs)
    np.testing.assert_array_equal(got, want)


def test_runner_breaker_opens_degrades_and_recovers():
    REGISTRY.reset()
    clk = {"t": 0.0}
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=10.0, clock=lambda: clk["t"],
                             name="score")
    runner = _chaos_runner(retry_policy=_fast_policy(max_attempts=1), breaker=breaker)
    docs = _chaos_docs()
    want = runner.score(docs)
    with faults.plan_scope(FaultPlan.parse("score/dispatch:error@1")):
        got = runner.score(docs)
        np.testing.assert_array_equal(got, want)
        assert breaker.state == "open"
        snap = REGISTRY.snapshot()
        assert snap["counters"]["resilience/degraded_batches"] >= 1
        assert snap["counters"]["resilience/breaker_opened"] == 1
        assert snap["counters"]["resilience/breaker_short_circuit"] >= 1
        assert REGISTRY.gauge_series()["langdetect_degraded"][0][1] == 1.0
        clk["t"] = 11.0
        got2 = runner.score(docs)
    np.testing.assert_array_equal(got2, want)
    assert breaker.state == "closed"
    assert REGISTRY.gauge_series()["langdetect_degraded"][0][1] == 0.0
    assert runner.metrics.snapshot()["counters"]["degraded_batches"] >= 1


@pytest.mark.parametrize("level", ["host", "gather"])
def test_runner_degraded_ladder_from_fast_strategy(level):
    """A kernel strategy degrades through the device-gather rung; failing
    that rung too (both count at ``score/dispatch``) leaves the host rung.
    Either rung's scores equal ``strategy='gather'``'s bit for bit."""
    REGISTRY.reset()
    docs = _chaos_docs(12)
    oracle = _chaos_runner().score(docs)
    clk = {"t": 0.0}
    runner = _chaos_runner(
        strategy="pallas", retry_policy=_fast_policy(max_attempts=1),
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=1e9, clock=lambda: clk["t"]),
    )
    plan = "score/dispatch:error@1-2" if level == "host" else "score/dispatch:error@1"
    with faults.plan_scope(FaultPlan.parse(plan)):
        got = runner.score(docs[:8])
    np.testing.assert_array_equal(got, oracle[:8])
    assert REGISTRY.snapshot()["counters"].get(f"resilience/degraded_{level}", 0) >= 1


def test_runner_deterministic_error_propagates_unretried(monkeypatch):
    runner = _chaos_runner()
    calls = {"n": 0}

    def bad(self, *a, **kw):
        calls["n"] += 1
        raise ValueError("programming error")

    monkeypatch.setattr(BatchRunner, "_dispatch_device", bad)
    with pytest.raises(ValueError):
        runner.score(_chaos_docs(4))
    assert calls["n"] == 1


# ------------------------------------------------ kernel failures propagate -
@pytest.mark.parametrize("error", [KernelLaunchError, KernelBuildError])
@pytest.mark.parametrize("pname,strategy,target", [
    ("hashed", "fused", (score_fused, "fused_detect")),
    ("cuckoo", "hybrid", (score_hist, "row_hist")),
])
def test_kernel_failure_propagates_without_retry_or_ladder(profiles, monkeypatch, error,
                                                           pname, strategy, target):
    runner = _runner(profiles[pname], strategy,
                     breaker=CircuitBreaker(failure_threshold=1, cooldown_s=1e9))
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise error("kernel failed: CUDA error 700 (an illegal memory access)")

    monkeypatch.setattr(*target, broken)
    REGISTRY.reset()
    for call in (runner.score, runner.predict_ids):
        with pytest.raises(error):
            call(_docs(2))
    assert len(calls) == 2
    counters = REGISTRY.snapshot()["counters"]
    assert not [k for k in counters if k.startswith(("resilience/", "score/retries"))]
    assert runner.breaker.state == "closed"
    assert runner.metrics.snapshot()["counters"].get("retries", 0) == 0


@pytest.mark.parametrize("pname,strategy,kernel", [
    ("hashed", "fused", (score_fused, "fused_detect", score_fused.FUSED_DETECT)),
    ("cuckoo", "hybrid", (score_hist, "row_hist", score_hist.ROW_HIST)),
])
def test_kernel_loader_oserror_propagates_without_retry_or_ladder(profiles, monkeypatch,
                                                                  tmp_path, pname, strategy,
                                                                  kernel):
    """``ctypes.CDLL`` failing with an OSError (retryable in itself) reaches
    the runner as a KernelBuildError: no replay, no rung, no counter."""
    module, wrapper, k = kernel
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(k, "_lib", None)
    k.library_path.write_bytes(b"")

    def cdll(path):
        raise OSError(f"{path}: cannot open shared object file")

    monkeypatch.setattr(_kernels.ctypes, "CDLL", cdll)
    # The wrapper as on the card: it loads its library before it launches.
    monkeypatch.setattr(module, wrapper, lambda *a, **kw: k.launch())
    runner = _runner(profiles[pname], strategy,
                     breaker=CircuitBreaker(failure_threshold=1, cooldown_s=1e9))
    REGISTRY.reset()
    for call in (runner.score, runner.predict_ids):
        with pytest.raises(KernelBuildError) as info:
            call(_docs(2))
        assert isinstance(info.value.__cause__, OSError)
    counters = REGISTRY.snapshot()["counters"]
    assert not [k for k in counters if k.startswith(("resilience/", "score/retries"))]
    assert runner.breaker.state == "closed"


@pytest.mark.parametrize("strategy", ["fused", "pallas", "hybrid", "hist", "gather"])
def test_ladder_is_withheld_from_kernel_paths_on_the_card(strategy):
    """On a CUDA device a kernel path replays and raises, never degrades;
    the gather programs (and every path on the CPU) keep the ladder."""
    runner = _chaos_runner(strategy="gather")
    runner.strategy = strategy  # the decision reads only the strategy and the device
    assert runner._ladder_allowed() and runner._ladder_allowed(segment=True)
    runner.device = torch.device("cuda")
    assert runner._ladder_allowed() == (strategy == "gather")
    assert runner._ladder_allowed(segment=True) == (strategy != "fused")
    runner.degraded_fallback = False
    assert not runner._ladder_allowed() and not runner._ladder_allowed(segment=True)


def test_cuda_error_at_the_fetch_propagates_without_replay(profiles, monkeypatch):
    runner = _runner(profiles["hashed"], "gather")

    def sticky(started):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(runner_mod, "host_numpy", sticky)
    REGISTRY.reset()
    with pytest.raises(RuntimeError, match="CUDA error"):
        runner.score(_docs(3))
    assert runner.metrics.snapshot()["counters"].get("retries", 0) == 0
    assert not [k for k in REGISTRY.snapshot()["counters"] if k.startswith("resilience/")]


# ------------------------------------------------------------- segment ------
def _cells_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("plan", ["score/dispatch:error@1", "score/fetch:error@1"])
def test_segment_cells_take_the_ladder_and_stay_exact(profiles, plan):
    profile = profiles["hashed"]
    docs = _docs(4)[:30] + [b"abcdefgh" * 500]
    gather = _runner(profile, "gather").segment_cells(docs)
    fused = _runner(profile, "fused").segment_cells(docs)
    assert fused[1] == gather[1] == docs
    for a, b in zip(fused[0], gather[0]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    REGISTRY.reset()
    runner = _runner(profile, "fused", retry_policy=_fast_policy(max_attempts=1),
                     breaker=CircuitBreaker(failure_threshold=1, cooldown_s=1e9))
    with faults.plan_scope(FaultPlan.parse(plan)):
        cells, scored = runner.segment_cells(docs)
    counters = REGISTRY.snapshot()["counters"]
    assert counters["resilience/degraded_gather"] == counters["resilience/degraded_batches"]
    assert scored == docs
    if plan.startswith("score/dispatch"):
        # The breaker opened on the first failure: every batch rode the
        # gather cell scorer on the f32 weights, bit for bit the gather
        # strategy's cells.
        _cells_equal(cells, gather[0])
    else:
        # Only the failed fetch's batch took the ladder.
        assert counters["resilience/degraded_batches"] == 1
        for a, b in zip(cells, gather[0]):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


def test_segment_cells_dedup_and_workers_bit_identical(profiles):
    docs = _docs(5)
    for strategy in ("fused", "gather"):
        ref = _runner(profiles["hashed"], strategy, dedup=False).segment_cells(docs)
        _cells_equal(_runner(profiles["hashed"], strategy).segment_cells(docs)[0], ref[0])
        _cells_equal(_runner(profiles["hashed"], strategy, dispatch_workers=2,
                             batch_size=4).segment_cells(docs)[0],
                     _runner(profiles["hashed"], strategy, dedup=False,
                             batch_size=4).segment_cells(docs)[0])


def test_host_rung_segment_cells_equal_gather(profiles):
    profile = profiles["cuckoo"]
    docs = _docs(6)[:20]
    want = _runner(profile, "gather").segment_cells(docs)[0]
    runner = _runner(profile, "hybrid", retry_policy=_fast_policy(max_attempts=1),
                     breaker=CircuitBreaker(failure_threshold=1, cooldown_s=1e9))
    REGISTRY.reset()
    with faults.plan_scope(FaultPlan.parse("score/dispatch:error@1")):
        cells, _ = runner.segment_cells(docs)
    _cells_equal(cells, want)
    assert REGISTRY.snapshot()["counters"]["resilience/degraded_host"] >= 1
