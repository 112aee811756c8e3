"""The port's device gauges, build-cache counters, analytic cost model,
profiler trace, NaN checks and segment telemetry, on the CPU.

* ``sample_device_gauges`` without a CUDA device returns ``{}`` and sets no
  gauge; the kernel builder counts ``compile_cache/misses`` and the
  ``compile_cache/build_s`` histogram when it runs the compiler and
  ``compile_cache/hits`` when a library matches its source hash.
* The cost model's numbers for tiny shapes equal counts done by hand, for
  every strategy and for the fit's count loop. (These are the port's own
  model, not XLA's numbers, so the JAX package is not compared here.) The
  peaks are the H100's, overridable by the knobs.
* A runner records its cost once, on a non-daemon thread shielded from the
  fault plan; ``stage_summary`` joins it with the span times.
* ``trace`` does nothing without a directory; with one it writes a Chrome
  trace per labelled call, records ``profile/trace`` at the root, and keeps
  both when the region raises; the ``trace_dir`` knob traces every score.
* ``nan_checks`` raises on a NaN weight table or a NaN score batch, and
  restores the prior setting; outside it nothing changes.
* Segment mode emits the JAX package's ``segment/*`` counters, histogram
  counts and ``segment/merge`` span on the same corpus.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest

from spark_languagedetector_tpu_torch import LanguageDetectorModel
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.models.profile import GramProfile
from spark_languagedetector_tpu_torch.ops import _kernels
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch, texts_to_bytes
from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec, window_ids_numpy
from spark_languagedetector_tpu_torch.resilience import faults
from spark_languagedetector_tpu_torch.resilience.faults import FaultPlan
from spark_languagedetector_tpu_torch.telemetry import REGISTRY, Registry, cost
from spark_languagedetector_tpu_torch.telemetry.gauges import sample_device_gauges
from spark_languagedetector_tpu_torch.utils import debug
from spark_languagedetector_tpu_torch.utils.profiling import TRACE_FILE, trace


# ------------------------------------------------------------------ gauges --
def test_sample_device_gauges_without_a_card_sets_nothing():
    reg = Registry()
    assert sample_device_gauges(reg) == {}
    assert reg.snapshot()["gauges"] == {}


class _FakeKernel(_kernels.CudaKernel):
    """A kernel whose "compiler" writes a placeholder library."""

    def build_command(self, out):
        return [sys.executable, "-c", f"open({str(out)!r}, 'wb').write(b'so')"]


def test_kernel_build_cache_counts_hits_misses_and_seconds(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
    k = _FakeKernel("fake", "k.cu", "fake_launch", [], None)
    REGISTRY.reset()
    built = _kernels.build_all([k])
    snap = REGISTRY.snapshot()
    assert set(built) == {"fake"} and k.library_path.is_file()
    assert snap["counters"]["compile_cache/misses"] == 1
    assert "compile_cache/hits" not in snap["counters"]
    assert snap["histograms"]["compile_cache/build_s"]["count"] == 1
    assert _kernels.build_all([k]) == {}
    snap = REGISTRY.snapshot()
    assert (snap["counters"]["compile_cache/hits"], snap["counters"]["compile_cache/misses"]) \
        == (1, 1)
    src.write_text("// edited kernel\n")  # a new source hash misses again
    _kernels.build_all([k])
    assert REGISTRY.snapshot()["counters"]["compile_cache/misses"] == 2


# ------------------------------------------------------------- cost model ---
def _docs(seed=0):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(97, 106, int(rng.integers(1, 80))).tolist()) for _ in range(20)]


def _profile(mode, glens, bits=20, langs="abcd"):
    rng = np.random.default_rng(1)
    spec = VocabSpec(mode, glens, bits)
    batch, _ = pad_batch(_docs(), 512)
    seen = np.unique(np.concatenate([window_ids_numpy(batch, n, spec).ravel() for n in glens]))
    ids = np.unique(rng.choice(seen, len(seen) // 2, replace=False))
    w = rng.normal(size=(len(ids), len(langs)))
    return GramProfile(spec=spec, languages=tuple(langs), ids=ids, weights=w)


def _runner(profile, strategy):
    w, lut, cuckoo = profile.device_membership(device="cpu")
    return BatchRunner(weights=w, lut=lut, cuckoo=cuckoo, spec=profile.spec, device="cpu",
                       strategy=strategy, length_buckets=(128, 256))


def _storage(t):
    return t.untyped_storage().nbytes()


# (vocab, gram lengths, strategy) -> the weight tensors the strategy reads
STRATEGY_TABLES = {
    ("exact", (1, 2), "fused"): lambda r: [r.table],
    ("exact", (1, 2), "gather"): lambda r: [r.table],
    ("exact", (1, 2), "pallas"): lambda r: [r.pallas_state.w2],  # w1 views the same table
    ("exact", (1, 2, 3), "hist"): lambda r: [r.hist_state.weights_pad],
    ("exact", (1, 2, 3), "hybrid"): lambda r: [r.pallas_state.w2, r.hist_state.weights_pad],
}


@pytest.mark.parametrize("key", sorted(STRATEGY_TABLES), ids=lambda k: f"{k[2]}-n{max(k[1])}")
def test_dispatch_cost_equals_a_count_by_hand(key):
    mode, glens, strategy = key
    runner = _runner(_profile(mode, glens), strategy)
    assert runner.strategy == strategy
    rows, pad_to, L = 3, 128, 4
    windows = rows * sum(pad_to - n + 1 for n in glens)  # every padded window
    tables = STRATEGY_TABLES[key](runner)
    table_bytes = sum(min(windows * L * t.element_size(), _storage(t)) for t in tables)
    want_bytes = rows * pad_to + 4 * rows + 8 * windows + table_bytes + 4 * rows * L
    got = cost.dispatch_cost(runner, rows, pad_to)
    assert got == {"flops": float(2 * windows * L), "bytes_accessed": float(want_bytes)}


def test_dispatch_cost_of_the_fused_strategy_in_numbers():
    runner = _runner(_profile("exact", (1, 2)), "fused")
    # 3 rows x (128 unigram + 127 bigram windows) = 765 windows, 4 languages.
    # Bytes: 384 batch + 12 lengths + 6,120 id plane + 765 x 4 x 4 table rows
    # (under the 65,792-row table's 1,052,672) + 48 scores.
    assert _storage(runner.table) == 65_792 * 4 * 4
    assert cost.dispatch_cost(runner, 3, 128) == {"flops": 6120.0, "bytes_accessed": 18804.0}
    # A huge batch is bounded by the whole table instead.
    big = cost.dispatch_cost(runner, 4096, 2048)
    windows = 4096 * (2048 + 2047)
    assert big["bytes_accessed"] == 4096 * 2048 + 4 * 4096 + 8 * windows + 1_052_672 + 16 * 4096


def test_fit_step_cost_equals_a_count_by_hand():
    spec = VocabSpec("exact", (1, 2))
    # 5 rows x 255 windows; at most one table cell per window.
    assert cost.fit_step_cost(spec, 3, 5, 128) == {
        "flops": 1275.0, "bytes_accessed": float(640 + 40 + 8 * 1275 + 8 * 1275)}
    # A tiny id space bounds the cells: exact n = 1 has 256 ids x 2 languages.
    one = cost.fit_step_cost(VocabSpec("exact", (1,)), 2, 4, 256)
    assert one == {"flops": 1024.0, "bytes_accessed": float(1024 + 32 + 8 * 1024 + 8 * 512)}
    reg = Registry()
    total = cost.record_fit_count_cost(spec, 3, {(5, 128): 2, (1, 256): 1, (0, 128): 4},
                                       platform="cpu", registry=reg)
    single = cost.fit_step_cost(spec, 3, 1, 256)
    assert total == {k: 2 * v + single[k] for k, v in cost.fit_step_cost(spec, 3, 5, 128).items()}
    gauges = reg.snapshot()["gauges"]
    assert gauges["program_flops"]["program=fit/count"] == total["flops"]
    assert gauges["device_peak_flops"]["device=cpu"] == 1.0e11
    assert cost.record_fit_count_cost(spec, 3, {}, registry=reg) is None


def test_peak_rates_are_the_h100s_and_the_knobs_override(monkeypatch):
    for var in ("LANGDETECT_PEAK_FLOPS", "LANGDETECT_PEAK_BYTES_PER_S"):
        monkeypatch.delenv(var, raising=False)
    assert cost.peak_rates("cuda") == (67e12, 3.35e12)
    assert cost.peak_rates("unknown-platform") is None
    monkeypatch.setenv("LANGDETECT_PEAK_FLOPS", "5e12")
    assert cost.peak_rates("cuda") == (5e12, 3.35e12)
    monkeypatch.setenv("LANGDETECT_PEAK_BYTES_PER_S", "not-a-number")
    assert cost.peak_rates("cuda") == (67e12, 3.35e12)  # advisory: malformed is ignored


def _model():
    return LanguageDetectorModel.from_gram_map(
        {b"ab": [1.0, 0.0], b"xy": [0.0, 1.0], b"abx": [0.5, 0.2]}, [2, 3], ["a", "x"],
        device="cpu")


def test_runner_records_cost_once_off_the_dispatch_path():
    REGISTRY.reset()
    model = _model()
    runner = model.runner
    docs = texts_to_bytes(["ababab", "xyxy", "abx"] * 4)
    runner.predict_ids(docs)
    thread = runner._cost_thread
    assert runner._cost_recorded and thread.name == "runner-cost-gauges" and not thread.daemon
    thread.join(timeout=60)
    assert runner._cost_error is None
    runner.score(docs)
    assert runner._cost_thread is thread  # once per runner
    entry = REGISTRY.stage_summary()["score/dispatch"]
    assert entry["est_flops_per_call"] > 0 and "flops_utilization" in entry
    gauges = REGISTRY.snapshot()["gauges"]
    assert gauges["program_flops"]["program=score/fused"] == \
        gauges["program_flops"]["program=score/dispatch"]
    assert gauges["langdetect_table_bytes"] == {
        "program=score/dispatch,quant=f32,strategy=fused": float(runner.table_bytes())}
    assert gauges["device_peak_bytes_per_s"] == {"device=cpu": 5.0e10}


def test_cost_thread_is_shielded_from_the_fault_plan(monkeypatch):
    """Instrumented code on the cost thread spends no call of a plan: the
    plan's second score/dispatch still lands on the second dispatch."""
    seen = []

    def instrumented(runner, rows, pad_to, registry=None):
        faults.inject("score/dispatch")
        seen.append(threading.current_thread().name)

    monkeypatch.setattr(cost, "record_runner_cost", instrumented)
    REGISTRY.reset()
    runner = _model().runner
    docs = texts_to_bytes(["ababab", "xyxy"])
    want = runner.score(docs)
    runner._cost_thread.join(timeout=60)
    seen.clear()
    runner = _model().runner
    with faults.plan_scope(FaultPlan.parse("score/dispatch:error@2")):
        np.testing.assert_array_equal(runner.score(docs), want)  # call 1
        runner._cost_thread.join(timeout=60)
        assert seen == ["runner-cost-gauges"] and runner._cost_error is None
        np.testing.assert_array_equal(runner.score(docs), want)  # call 2 fires, retried
    counters = REGISTRY.snapshot()["counters"]
    assert counters["resilience/faults_injected"] == 1 and counters["score/retries"] == 1


def test_device_fit_records_count_cost():
    from spark_languagedetector_tpu_torch.ops.fit_tpu import fit_profile_device

    REGISTRY.reset()
    spec = VocabSpec("exact", (1, 2))
    fit_profile_device([b"abab", b"xyxy", b"abxy"], np.asarray([0, 1, 0]), 2, spec, 50,
                       device="cpu")
    entry = REGISTRY.stage_summary()["fit/count"]
    assert entry["est_flops_per_call"] > 0
    assert "bytes_utilization" in entry and "flops_utilization" in entry


# --------------------------------------------------------------- profiling --
def test_trace_is_a_no_op_without_a_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("LANGDETECT_TRACE_DIR", raising=False)
    REGISTRY.reset()
    with trace() as where:
        assert where is None
    with trace(label="score") as where:
        assert where is None
    assert "profile/trace" not in REGISTRY.stage_summary()


def test_trace_writes_a_chrome_trace_and_records_at_the_root(tmp_path):
    REGISTRY.reset()
    runner = _model().runner
    with trace(str(tmp_path), label="call") as where:
        runner.score(texts_to_bytes(["ababab"]))
    assert os.path.basename(where).startswith("call-")
    with open(os.path.join(where, TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    assert events
    stages = REGISTRY.stage_summary()
    assert stages["profile/trace"]["count"] == 1
    assert "score" in stages and not any(p.startswith("profile/trace/") for p in stages)
    with pytest.raises(RuntimeError, match="boom"):
        with trace(str(tmp_path), label="call") as second:
            raise RuntimeError("boom")
    assert second != where and os.path.isfile(os.path.join(second, TRACE_FILE))
    assert REGISTRY.stage_summary()["profile/trace"]["count"] == 2


def test_trace_dir_knob_traces_every_score(tmp_path, monkeypatch):
    monkeypatch.setenv("LANGDETECT_TRACE_DIR", str(tmp_path))
    runner = _model().runner
    runner.score(texts_to_bytes(["ababab"]))
    runner.predict_ids(texts_to_bytes(["xyxy"]))
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("score-"))
    assert len(dirs) == 2
    assert all(os.path.isfile(tmp_path / d / TRACE_FILE) for d in dirs)


# ---------------------------------------------------------------- debug -----
def test_nan_checks_raise_and_restore():
    model = _model()
    w = np.array(model.runner._host_weights)
    w[:, 0] = np.nan  # every window's language-0 weight
    spec = model.runner.spec
    assert not debug.nan_checks_enabled()
    with debug.nan_checks():
        assert debug.nan_checks_enabled()
        with pytest.raises(ValueError, match=f"runner weight table contains {len(w)} non-finite"):
            BatchRunner(w, None, spec, device="cpu")
        with debug.nan_checks(False):
            assert not debug.nan_checks_enabled()
        assert debug.nan_checks_enabled()
    assert not debug.nan_checks_enabled()
    # Outside the scope nothing changes: the runner builds and scores.
    runner = BatchRunner(w, None, spec, device="cpu", strategy="gather")
    docs = texts_to_bytes(["ab", "xy"])
    scores = runner.score(docs)
    assert np.isnan(scores[:, 0]).all() and np.isfinite(scores[:, 1]).all()
    with debug.nan_checks():
        with pytest.raises(ValueError, match="fetched score batch"):
            runner.score(docs)
        np.testing.assert_array_equal(model.runner.score(docs), _model().runner.score(docs))
    with pytest.raises(ValueError, match="fitted weight table"):
        with debug.nan_checks():
            debug.check_finite([np.asarray([np.inf])], "fitted weight table")


def test_assert_finite_on_tensors_and_arrays():
    import torch

    debug.assert_finite(np.ones((3, 3)), "ok")
    debug.assert_finite(torch.zeros((0, 2)), "empty ok")
    debug.assert_finite(torch.arange(3), "integers ok")
    with pytest.raises(ValueError, match="t contains 2 non-finite"):
        debug.assert_finite(torch.tensor([1.0, float("nan"), float("inf")]), "t")


# ------------------------------------------------------ segment telemetry ---
SEGMENT_NAMES = ("segment/docs", "segment/rejects", "segment/spans")
SEGMENT_HISTS = ("segment/spans_per_doc", "segment/span_len_bytes")


def _segment_models():
    import bench
    from spark_languagedetector_tpu import LanguageDetector as JaxDetector
    from spark_languagedetector_tpu import Table as JaxTable
    from spark_languagedetector_tpu_torch.convert import model_from_arrays

    langs = ["en", "de", "fr", "es"]
    docs, labels = bench.make_corpus(langs, 30, mean_len=300, seed=3)
    jax_model = JaxDetector(langs, [1, 2, 3], 200).fit(JaxTable({"lang": labels, "fulltext": docs}))
    p = jax_model.profile
    model = model_from_arrays(p.spec.mode, p.spec.gram_lengths, p.spec.hash_bits,
                              p.spec.hash_scheme, p.languages, p.ids, p.weights, device="cpu")
    texts, _ = bench.make_codeswitch_corpus(langs, 8, seed=31)
    return jax_model, model, texts + ["", "a", "köln 京都", "the quick brown fox"]


def test_segment_telemetry_matches_jax():
    from spark_languagedetector_tpu import Table as JaxTable
    from spark_languagedetector_tpu.telemetry import REGISTRY as JAX_REGISTRY
    from spark_languagedetector_tpu_torch import Table

    jax_model, model, texts = _segment_models()
    out = {}
    for name, reg, seg, table in (
        ("torch", REGISTRY, model.copy({"resultMode": "segment", "rejectThreshold": 0.5}), Table),
        ("jax", JAX_REGISTRY,
         jax_model.copy().set_result_mode("segment").set_reject_threshold(0.5), JaxTable),
    ):
        reg.reset()
        results = [json.loads(v) for v in
                   seg.transform(table({"fulltext": texts})).column("lang").tolist()]
        snap = reg.snapshot()
        out[name] = (
            {k: snap["counters"].get(k) for k in SEGMENT_NAMES},
            {k: snap["histograms"][k]["count"] for k in SEGMENT_HISTS},
            reg.stage_summary()["segment/merge"]["count"],
        )
        counts = (len(results), sum(r["rejected"] for r in results),
                  sum(len(r["spans"]) for r in results))
        assert tuple(out[name][0].values()) == counts
    assert out["torch"] == out["jax"]
    counters = out["torch"][0]
    assert counters["segment/docs"] == len(texts) and counters["segment/rejects"] > 0
    assert out["torch"][1]["segment/span_len_bytes"] == counters["segment/spans"]
