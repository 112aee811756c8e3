"""The port's offline shape autotuner (``exec/tune.py``) against the JAX
package's.

* The same capture and the same constraints give the same
  ``TuningProfile`` in both packages, content ``version`` included: on
  synthetic captures (length bins alone; with serving, cache, wire and
  budget signals; under every constraint flag), on a capture the port
  wrote (a runner over documents of many lengths and a serve batcher with
  its cache), on a capture the JAX package wrote, and on the JAX package's
  checked-in fixture, which carries no length distribution and is refused
  by both.
* The counterparts of the JAX tuner tests: the exact DP's lattice, the
  solve's serve fields and determinism, the CLI's contract, and a runner
  and a batcher loading the profile (explicit values and env still win).
"""

import json
import os

import numpy as np
import pytest

from spark_languagedetector_tpu.exec import tune as jtune
from spark_languagedetector_tpu.telemetry import report as jreport
from spark_languagedetector_tpu_torch.exec import config as exec_config
from spark_languagedetector_tpu_torch.exec import tune
from spark_languagedetector_tpu_torch.exec.profile import TuningProfile, content_version
from spark_languagedetector_tpu_torch.telemetry import REGISTRY, report

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "telemetry_fixture.jsonl")


def _capture(tmp_path, counters, histograms=None, name="cap.jsonl"):
    events = [
        {"event": "telemetry.span", "ts": 100.0, "path": "score", "wall_s": 0.5},
        {"event": "telemetry.snapshot", "ts": 110.0, "counters": counters, "gauges": {},
         "histograms": histograms or {}},
    ]
    path = tmp_path / name
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    return str(path)


SERVE = (
    {"exec/len/256": 500, "exec/len/320": 300, "exec/len/1024": 20,
     "serve/coalesced_rows": 1000, "serve/dispatches": 50},
    {"serve/rows_per_dispatch": {"count": 50, "mean": 20.0, "p90": 40.0}},
)
EVERYTHING = (
    {"exec/len/128": 40, "exec/len/192": 900, "exec/len/704": 33, "exec/len/3008": 5,
     "serve/coalesced_rows": 5000, "cache/lookups": 4000, "cache/hits": 1000,
     "cache/bytes_saved": 250_000, "dedup/rows_in": 9000, "dedup/rows_unique": 7000,
     "score/real_bytes": 300_000, "score/capacity_bytes": 900_000},
    {"serve/rows_per_dispatch": {"count": 100, "mean": 50.0, "p90": 300.0},
     "score/batch_latency_s": {"count": 10, "mean": 0.004}},
)

# name -> (counters, histograms, solve kwargs)
SYNTHETIC = {
    "lengths_only": ({"exec/len/256": 10}, None, {}),
    "lengths_three_shapes": ({"exec/len/256": 10}, None, {"max_shapes": 3}),
    "serve": (*SERVE, {"max_shapes": 4}),
    "serve_p99": (*SERVE, {"max_shapes": 4, "p99_ms": 6.0}),
    "everything": (*EVERYTHING, {}),
    "everything_budget": (*EVERYTHING, {"max_batch_ms": 50.0, "min_width": 256}),
    "wire_already_on": ({"exec/len/640": 7, "score/encoded_batches": 3}, None, {}),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_synthetic_capture_tunes_alike(case, tmp_path):
    counters, hists, kw = SYNTHETIC[case]
    events = report.load_events(_capture(tmp_path, counters, hists))
    mine, theirs = tune.solve(events, **kw), jtune.solve(events, **kw)
    assert mine.to_json() == theirs.to_json()
    assert mine.version == theirs.version == content_version(mine.tuned)
    assert tune.capture_signals(events) == jtune.capture_signals(events)


def _docs(rng, n):
    lengths = np.concatenate([rng.integers(1, 200, n // 2), rng.integers(200, 3000, n // 4),
                              rng.integers(3000, 9000, n - n // 2 - n // 4)])
    return [bytes(rng.integers(97, 123, int(k)).tolist()) for k in lengths]


def _port_capture(path):
    """A port runner over documents of many lengths, then a serve batcher
    with its cache over repeated documents, into the jsonl sink."""
    from spark_languagedetector_tpu_torch import LanguageDetectorModel
    from spark_languagedetector_tpu_torch.serve import ContinuousBatcher
    from spark_languagedetector_tpu_torch.telemetry.export import JsonlSink

    rng = np.random.default_rng(11)
    model = LanguageDetectorModel.from_gram_map(
        {b"ab": [1.0, 0.0], b"xy": [0.0, 1.0], b"abx": [0.5, 0.2]}, [2, 3], ["a", "x"],
        device="cpu")
    sink = JsonlSink(str(path))
    REGISTRY.reset()
    REGISTRY.add_sink(sink)
    try:
        docs = _docs(rng, 120)
        model.runner.score(docs)
        with ContinuousBatcher(model.runner, max_wait_ms=2, max_rows=64) as b:
            for i in range(3):
                b.submit(docs[:30] + docs[:10]).result(timeout=60)
        model.runner._cost_thread.join()
        REGISTRY.flush()
    finally:
        REGISTRY.remove_sink(sink)
        sink.close()
    return str(path)


def _jax_capture(path):
    from spark_languagedetector_tpu import LanguageDetectorModel as JaxModel
    from spark_languagedetector_tpu.telemetry import REGISTRY as JAX_REGISTRY
    from spark_languagedetector_tpu.telemetry.export import JsonlSink

    rng = np.random.default_rng(12)
    model = JaxModel.from_gram_map({b"ab": [1.0, 0.0], b"xy": [0.0, 1.0]}, [2], ["a", "x"])
    sink = JsonlSink(str(path))
    JAX_REGISTRY.reset()
    JAX_REGISTRY.add_sink(sink)
    try:
        model._get_runner().score(_docs(rng, 60))
        JAX_REGISTRY.flush()
    finally:
        JAX_REGISTRY.remove_sink(sink)
        sink.close()
    return str(path)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_written_capture_tunes_alike_in_both_packages(writer, tmp_path, capsys):
    path = (_port_capture if writer == "port" else _jax_capture)(tmp_path / "cap.jsonl")
    events = report.load_events(path)
    assert events == jreport.load_events(path)
    signals = tune.capture_signals(events)
    assert signals["len_bins"], "the capture carries the exec/len distribution"
    for kw in ({}, {"max_shapes": 4, "max_batch_ms": 20.0, "p99_ms": 30.0}):
        mine, theirs = tune.solve(events, **kw), jtune.solve(events, **kw)
        assert mine.to_json() == theirs.to_json() and mine.version == theirs.version
    if writer == "port":
        assert "serve_max_rows" in mine.tuned and "cache_rows" in mine.tuned
    outs = []
    for mod in (tune, jtune):
        out = tmp_path / f"{mod.__name__.split('.')[0]}.json"
        capsys.readouterr()
        assert mod.main([path, "-o", str(out), "--max-shapes", "5"]) == 0
        outs.append((capsys.readouterr().out.replace(str(out), "OUT"), out.read_text()))
    assert outs[0] == outs[1]
    assert TuningProfile.load(str(tmp_path / "spark_languagedetector_tpu.json")).version == \
        json.loads(outs[0][1])["version"]


def test_jax_fixture_is_refused_alike(capsys):
    events = report.load_events(FIXTURE)
    for mod in (tune, jtune):
        with pytest.raises(ValueError, match="exec/len"):
            mod.solve(events)
        capsys.readouterr()
        assert mod.main([FIXTURE]) == 2
        assert "cannot tune from this capture" in capsys.readouterr().err


# ------------------------------------------- the JAX tuner tests' in the port
def test_solve_buckets_dp_finds_tight_lattice():
    bins = {320: 100, 1024: 10}
    assert tune.solve_buckets(bins, max_shapes=2) == [384, 1024]
    assert tune.solve_buckets(bins, max_shapes=1) == [1024]
    many = {64 * i: 5 for i in range(1, 20)}
    got = tune.solve_buckets(many, max_shapes=4)
    assert len(got) <= 4 and got == jtune.solve_buckets(many, max_shapes=4)
    assert tune.padded_bytes(many, got) == jtune.padded_bytes(many, got)
    with pytest.raises(ValueError, match="exec/len"):
        tune.solve_buckets({})


def test_solve_emits_valid_profile_with_serve_fields(tmp_path):
    events = report.load_events(_capture(tmp_path, *SERVE))
    profile = tune.solve(events, max_shapes=4)
    assert profile.tuned["length_buckets"][-1] == 8192
    assert 1024 in profile.tuned["length_buckets"]
    assert len(profile.tuned["length_buckets"]) <= 4
    assert "batch_bytes" not in profile.tuned and "fit_batch_bytes" not in profile.tuned
    assert profile.tuned["serve_max_rows"] == 64
    assert profile.tuned["serve_queue_rows"] == 64 * 16
    assert 1.0 <= profile.tuned["serve_max_wait_ms"] <= 50.0
    assert profile.created == 110.0
    assert tune.solve(events, max_shapes=4).to_json() == profile.to_json()


@pytest.mark.parametrize("argv", [
    [], ["a.jsonl", "b.jsonl"], ["--bogus", "x"], ["missing.jsonl"], ["CAP", "--max-shapes", "0"],
    ["CAP", "--min-width", "64"], ["CAP", "-o"],
], ids=["none", "two", "bogus", "missing", "zero_shapes", "narrow", "no_out"])
def test_tune_cli_usage_errors_match_jax(argv, tmp_path, capsys):
    cap = _capture(tmp_path, {"exec/len/256": 10})
    argv = [cap if a == "CAP" else (str(tmp_path / a) if a.endswith(".jsonl") else a)
            for a in argv]
    for mod in (tune, jtune):
        assert mod.main(argv) == 2


def test_tune_cli_writes_the_profile(tmp_path, capsys):
    empty = _capture(tmp_path, {}, name="empty.jsonl")
    assert tune.main([empty]) == 2
    cap = _capture(tmp_path, {"exec/len/256": 10})
    out = tmp_path / "prof.json"
    capsys.readouterr()
    assert tune.main([cap, "-o", str(out), "--max-shapes", "3"]) == 0
    assert TuningProfile.load(str(out)).tuned["length_buckets"] == (256, 8192)
    assert "predicted padded-byte reduction" in capsys.readouterr().out


def test_runner_and_batcher_load_a_tuned_profile(monkeypatch, tmp_path):
    from spark_languagedetector_tpu_torch import LanguageDetectorModel
    from spark_languagedetector_tpu_torch.api.runner import BatchRunner
    from spark_languagedetector_tpu_torch.serve import ContinuousBatcher

    profile = tune.solve(report.load_events(_capture(tmp_path, *EVERYTHING)),
                         max_batch_ms=50.0)
    path = tmp_path / "p.json"
    profile.save(str(path))
    model = LanguageDetectorModel.from_gram_map(
        {b"ab": [1.0, 0.0], b"xy": [0.0, 1.0]}, [2], ["a", "x"], device="cpu")
    r = model.runner
    monkeypatch.setenv(exec_config.PROFILE_ENV, str(path))
    exec_config.reload_profile()
    try:
        tuned = BatchRunner(r._host_weights, None, r.spec, device="cpu")
        assert tuned.length_buckets == tuple(profile.tuned["length_buckets"])
        assert tuned.batch_bytes == profile.tuned["batch_bytes"]
        pinned = BatchRunner(r._host_weights, None, r.spec, device="cpu",
                             length_buckets=(128, 512))
        assert pinned.length_buckets == (128, 512)
        with ContinuousBatcher(tuned) as b:
            assert b.max_rows == profile.tuned["serve_max_rows"]
        monkeypatch.setenv("LANGDETECT_SERVE_MAX_ROWS", "16")
        with ContinuousBatcher(tuned) as b:
            assert b.max_rows == 16
        docs = [b"ab" * k for k in range(1, 400, 7)]
        np.testing.assert_array_equal(tuned.predict_ids(docs), r.predict_ids(docs))
    finally:
        monkeypatch.delenv(exec_config.PROFILE_ENV)
        exec_config.reload_profile()
