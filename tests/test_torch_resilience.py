"""The port's retry policy, circuit breaker and fault plans against the JAX
package's.

* the policy, breaker and fault-plan tests of the JAX package's
  ``tests/test_chaos.py``, each run on both packages with the same outcome;
* the same ``FaultPlan`` (explicit calls, ranges, ``%prob``) fires on the
  same calls in both packages, and their backoff schedules are equal;
* the port's classifier refuses ``KernelBuildError``, ``KernelLaunchError``
  and CUDA errors, where the JAX classifier retries any ``RuntimeError``.
"""

import time
from types import SimpleNamespace

import pytest
import torch

from spark_languagedetector_tpu.resilience import faults as jfaults
from spark_languagedetector_tpu.resilience import policy as jpolicy
from spark_languagedetector_tpu.telemetry import REGISTRY as JREGISTRY
from spark_languagedetector_tpu_torch.ops import KernelBuildError, KernelLaunchError
from spark_languagedetector_tpu_torch.ops import _kernels
from spark_languagedetector_tpu_torch.resilience import faults, policy
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

PORT = SimpleNamespace(faults=faults, policy=policy, registry=REGISTRY, name="port")
JAX = SimpleNamespace(faults=jfaults, policy=jpolicy, registry=JREGISTRY, name="jax")
BOTH = pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])


def _fast(pkg, **kw):
    kw.setdefault("max_attempts", 2)
    kw.setdefault("base_delay_s", 0.0)
    return pkg.policy.RetryPolicy(**kw)


# ------------------------------------------------------------ classifier ----
@BOTH
def test_classifier_shared_cases(pkg):
    ok = pkg.policy.is_retryable
    assert ok(RuntimeError("device lost"))
    assert ok(OSError("reset"))
    assert ok(TimeoutError("deadline"))
    assert ok(pkg.faults.InjectedFault("chaos"))
    assert ok(torch.OutOfMemoryError("out of memory"))
    for exc in (ValueError("bad"), TypeError("bad"), NotImplementedError("todo"),
                RecursionError("loop"), KeyboardInterrupt(), SystemExit(1)):
        assert not ok(exc), exc


def test_port_classifier_refuses_kernel_and_cuda_errors():
    ok = policy.is_retryable
    assert issubclass(KernelBuildError, RuntimeError)
    assert issubclass(KernelLaunchError, RuntimeError)
    refused = [
        KernelBuildError("nvcc failed"),
        KernelLaunchError("fused_detect launch failed: CUDA error 700"),
        torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
        RuntimeError("CUDA error: device-side assert triggered"),
        RuntimeError("  CUDA error: misaligned address"),
    ]
    for exc in refused:
        assert not ok(exc), exc
        # The JAX classifier would replay every one of them.
        assert jpolicy.is_retryable(exc)
    assert ok(RuntimeError("the CUDA error was transient"))  # not the prefix
    with pytest.raises(KernelLaunchError):
        _fast(PORT, max_attempts=5).run(
            lambda: (_ for _ in ()).throw(KernelLaunchError("x")), site="u"
        )


def test_kernel_wrappers_raise_the_new_classes(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels.Path, "is_file", lambda self: False)
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        _kernels.nvcc_path()
    # Existing checks that expect a RuntimeError still hold.
    with pytest.raises(RuntimeError):
        _kernels.nvcc_path()

    class FakeLib:
        def fake_launch(self, *a):
            return 700

        def kernel_error_string(self, rc):
            return b"an illegal memory access was encountered"

    k = _kernels.CudaKernel("fake", "fused_detect.cu", "fake_launch", [], None)
    monkeypatch.setattr(k, "library", lambda: FakeLib())
    with pytest.raises(KernelLaunchError, match="CUDA error 700"):
        k.launch()
    assert k.launches == 0


@pytest.mark.parametrize("failure", ["mkdir", "popen", "cdll", "symbol"])
def test_every_build_or_load_failure_is_a_kernel_build_error(tmp_path, monkeypatch, failure):
    """An OSError (or a missing symbol) on the way to a loaded library is a
    KernelBuildError, which the retry classifier refuses."""
    k = _kernels.CudaKernel("fake", "fused_detect.cu", "fake_launch", [], None)
    if failure == "mkdir":
        (tmp_path / "file").write_text("")
        monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "file" / "kernels")
    else:
        monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    if failure == "popen":
        monkeypatch.setattr(_kernels, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    elif failure in ("cdll", "symbol"):
        k.library_path.write_bytes(b"")

        class Lib:
            kernel_error_string = None

        def cdll(path):
            if failure == "cdll":
                raise OSError(f"{path}: invalid ELF header")
            return Lib()

        monkeypatch.setattr(_kernels.ctypes, "CDLL", cdll)
    with pytest.raises(KernelBuildError) as info:
        k.library()
    assert not policy.is_retryable(info.value)
    assert k._lib is None and k.launches == 0


# ---------------------------------------------------------- retry policy ----
@BOTH
def test_backoff_deterministic_bounded_and_equal_across_packages(pkg):
    kw = dict(base_delay_s=0.1, multiplier=2.0, max_delay_s=1.0, jitter=0.5, seed=7)
    p = pkg.policy.RetryPolicy(**kw)
    delays = [p.backoff_s(a) for a in range(1, 8)]
    assert delays == [jpolicy.RetryPolicy(**kw).backoff_s(a) for a in range(1, 8)]
    for a, d in enumerate(delays, start=1):
        base = min(1.0, 0.1 * 2.0 ** (a - 1))
        assert base * 0.5 <= d <= base
    other = pkg.policy.RetryPolicy(**{**kw, "seed": 8})
    assert [other.backoff_s(a) for a in range(1, 8)] != delays
    flat = pkg.policy.RetryPolicy(base_delay_s=0.1, multiplier=2.0, max_delay_s=1.0, jitter=0.0)
    assert flat.backoff_s(1) == pytest.approx(0.1)
    assert flat.backoff_s(10) == pytest.approx(1.0)


@BOTH
def test_run_recovers_transient_and_reports_retries(pkg):
    calls, seen, slept = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) <= 2:
            raise RuntimeError("transient")
        return 42

    p = pkg.policy.RetryPolicy(max_attempts=3, base_delay_s=0.01, jitter=0.0)
    out = p.run(flaky, site="unit", on_retry=lambda a, d, e: seen.append(a), sleep=slept.append)
    assert out == 42 and len(calls) == 3 and seen == [1, 2]
    assert slept == [p.backoff_s(1), p.backoff_s(2)]


@BOTH
def test_run_exhausts_then_raises_and_never_replays_deterministic(pkg):
    calls = []

    def always():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(OSError):
        _fast(pkg, max_attempts=3).run(always, site="u")
    assert len(calls) == 3
    calls.clear()

    def bad():
        calls.append(1)
        raise ValueError("schema")

    with pytest.raises(ValueError):
        _fast(pkg, max_attempts=5).run(bad, site="u")
    assert len(calls) == 1
    calls.clear()

    def interrupted():
        calls.append(1)
        raise KeyboardInterrupt()

    with pytest.raises(KeyboardInterrupt):
        _fast(pkg, max_attempts=5).run(interrupted, site="u")
    assert len(calls) == 1


@BOTH
def test_run_deadline_and_initial_error(pkg):
    p = pkg.policy.RetryPolicy(max_attempts=5, base_delay_s=0.0, attempt_deadline_s=0.005)

    def slow_fail():
        time.sleep(0.02)
        raise RuntimeError("slow transient")

    with pytest.raises(pkg.policy.DeadlineExceeded):
        p.run(slow_fail, site="u")
    calls = []
    replay = lambda: calls.append(1) or "ok"  # noqa: E731
    assert _fast(pkg).run(replay, initial_error=RuntimeError("x"), site="u") == "ok"
    assert len(calls) == 1
    with pytest.raises(RuntimeError):
        _fast(pkg, max_attempts=1).run(replay, initial_error=RuntimeError("x"), site="u")
    calls.clear()
    with pytest.raises(ValueError):
        _fast(pkg).run(replay, initial_error=ValueError("x"), site="u")
    assert calls == []


@BOTH
def test_from_env_reads_knobs(pkg, monkeypatch):
    monkeypatch.setenv("LANGDETECT_RETRY_MAX_ATTEMPTS", "4")
    monkeypatch.setenv("LANGDETECT_RETRY_BASE_DELAY_S", "0.25")
    monkeypatch.setenv("LANGDETECT_RETRY_JITTER", "0")
    monkeypatch.setenv("LANGDETECT_RETRY_ATTEMPT_DEADLINE_S", "9")
    monkeypatch.setenv("LANGDETECT_BREAKER_THRESHOLD", "3")
    p = pkg.policy.RetryPolicy.from_env()
    assert (p.max_attempts, p.base_delay_s, p.jitter, p.attempt_deadline_s) == (4, 0.25, 0.0, 9.0)
    assert pkg.policy.RetryPolicy.from_env(max_attempts=1).max_attempts == 1
    assert pkg.policy.CircuitBreaker.from_env(name="x").failure_threshold == 3
    monkeypatch.setenv("LANGDETECT_RETRY_MAX_ATTEMPTS", "many")
    with pytest.raises(ValueError):
        pkg.policy.RetryPolicy.from_env()


# ------------------------------------------------------- circuit breaker ----
@BOTH
def test_breaker_lifecycle(pkg):
    clk = {"t": 0.0}
    br = pkg.policy.CircuitBreaker(failure_threshold=2, cooldown_s=10.0,
                                   clock=lambda: clk["t"], name="unit")
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clk["t"] = 11.0
    assert br.allow() and br.state == "half_open"
    br.record_success()
    assert br.state == "closed"
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == "closed"
    # A probe failure re-opens and restarts the cooldown.
    br2 = pkg.policy.CircuitBreaker(failure_threshold=1, cooldown_s=5.0, clock=lambda: clk["t"])
    br2.record_failure()
    clk["t"] = 17.0
    assert br2.allow()
    br2.record_failure()
    assert br2.state == "open" and not br2.allow()
    clk["t"] = 22.0
    assert br2.allow()


@BOTH
def test_breaker_success_while_open_heals_and_gauge(pkg):
    pkg.registry.reset()
    br = pkg.policy.CircuitBreaker(failure_threshold=1, cooldown_s=5.0, name="gaugetest")
    br.record_failure()
    series = pkg.registry.gauge_series()["langdetect_breaker_state"]
    assert {tuple(sorted(l.items())): v for l, v in series}[(("breaker", "gaugetest"),)] == 2.0
    br.record_success()
    assert br.state == "closed"
    br2 = pkg.policy.CircuitBreaker(failure_threshold=1, cooldown_s=5.0, probe_successes=2)
    br2.record_failure()
    br2.record_success()
    assert br2.state == "half_open"
    br2.record_success()
    assert br2.state == "closed"
    br3 = pkg.policy.CircuitBreaker(failure_threshold=1, cooldown_s=1000.0)
    br3.record_failure()
    with pytest.raises(pkg.policy.BreakerOpen):
        _fast(pkg).run(lambda: None, site="u", breaker=br3, breaker_gates=True)


# ------------------------------------------------------------- fault plan ---
PLANS = [
    "seed=42;score/dispatch:error@2,5-7;score/fetch:delay=0.001@1;"
    "stream/batch:poison=2@4;shard_step:error%0.25",
    "seed=3;score/pack:error%0.4;score/dispatch:error@1-3",
    "score/fetch:error",
]


@pytest.mark.parametrize("text", PLANS)
def test_same_plan_fires_on_the_same_calls_in_both_packages(text):
    plan, jplan = faults.FaultPlan.parse(text), jfaults.FaultPlan.parse(text)
    assert plan.seed == jplan.seed
    assert [(s.site, s.kind, s.value, s.calls, s.prob) for s in plan.specs] == [
        (s.site, s.kind, s.value, s.calls, s.prob) for s in jplan.specs
    ]
    for a, b in zip(plan.specs, jplan.specs):
        assert [a.fires(c, plan.seed) for c in range(1, 300)] == [
            b.fires(c, jplan.seed) for c in range(1, 300)
        ]
    assert plan.poison_rows(4, 10) == jplan.poison_rows(4, 10)
    sites = ("score/dispatch", "score/fetch", "score/pack", "shard_step")

    def drive(mod):
        fired = []
        with mod.plan_scope(mod.FaultPlan.parse(text)):
            for call in range(60):
                site = sites[call % len(sites)]
                try:
                    mod.inject(site)
                except mod.InjectedFault:
                    fired.append((site, call))
        return fired

    assert drive(faults) == drive(jfaults)


def test_prob_schedule_is_process_independent():
    assert faults._fnv1a("shard_step") == 0x106C1B6B59E3862E
    plan = faults.FaultPlan.parse("seed=42;shard_step:error%0.3")
    assert [c for c in range(1, 21) if plan.specs[0].fires(c, plan.seed)] == [
        1, 3, 7, 8, 11, 17, 18, 19
    ]


@BOTH
@pytest.mark.parametrize("bad", [
    "nosuchsite:error@1", "score/dispatch:explode@1", "score/dispatch:error@0",
    "score/dispatch:error@3-1", "score/dispatch:error@1%0.5", "score/dispatch",
])
def test_fault_plan_parse_rejects(pkg, bad):
    with pytest.raises(ValueError):
        pkg.faults.FaultPlan.parse(bad)


@BOTH
def test_inject_counts_calls_shield_and_delay(pkg):
    f = pkg.faults
    with f.plan_scope(f.FaultPlan.parse("score/dispatch:error@2")):
        f.inject("score/dispatch")
        with pytest.raises(f.InjectedFault):
            f.inject("score/dispatch")
        f.inject("score/dispatch")
        f.inject("score/fetch")
    f.inject("score/dispatch")  # no plan: no-op
    with f.plan_scope(f.FaultPlan.parse("score/fetch:delay=0.02@1")):
        t0 = time.perf_counter()
        f.inject("score/fetch")
        assert time.perf_counter() - t0 >= 0.015


@BOTH
def test_install_from_env(pkg, monkeypatch):
    f = pkg.faults
    f.uninstall()
    monkeypatch.setenv("LANGDETECT_FAULT_PLAN", "seed=3;fit/count:error@1")
    plan = f.install_from_env()
    assert plan is not None and plan.seed == 3 and f.active() is plan
    f.uninstall()
    assert f.active() is None
    monkeypatch.setenv("LANGDETECT_FAULT_PLAN", "garbage")
    with pytest.raises(ValueError):
        f.install_from_env()
    monkeypatch.setenv("LANGDETECT_FAULT_PLAN", "")
    assert f.install_from_env() is None
