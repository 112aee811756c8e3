"""The port's report and compare CLIs against the JAX package's, on the same
captures (``telemetry/report.py``, ``telemetry/compare.py``).

* report: the text is string-equal to the JAX report's on the checked-in
  fixtures, on garbage lines, on an empty capture, on a capture that holds
  only a snapshot and on malformed snapshot sections; the usage errors
  exit 2 in both.
* compare: both packages give the same exit code, the same printed diff
  and the same regression list on the fixture pair, the threshold and
  direction cases, the fill ratios (histogram and counter), the tracked
  ``table_bytes``, ``est_bytes_utilization`` and ``fit_collect_bytes``,
  the serve fill and waste, the wire bytes per document, the zoo's
  cross-tenant reject, per-tenant shed and informational counters, and the
  usage and input errors.

Every comparison is exact: strings, lists and integers.
"""

import json
import os
import re

import pytest

from spark_languagedetector_tpu.telemetry import compare as jcompare
from spark_languagedetector_tpu.telemetry import report as jreport
from spark_languagedetector_tpu_torch.telemetry import compare, report

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE = os.path.join(FIXTURES, "telemetry_fixture.jsonl")
FIXTURE_REGRESSED = os.path.join(FIXTURES, "telemetry_fixture_regressed.jsonl")


def _write(path, events) -> str:
    path.write_text("".join(json.dumps(ev) + "\n" for ev in events))
    return str(path)


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(mod, jmod, argv, capsys):
    """(rc, stdout, stderr) of the port's CLI, asserted equal to the JAX
    CLI's apart from the usage line, which names each package."""
    mine = _run(mod.main, argv, capsys)
    theirs = _run(jmod.main, argv, capsys)
    assert mine[:2] == theirs[:2]
    assert mine[2].replace("spark_languagedetector_tpu_torch", "spark_languagedetector_tpu") \
        == theirs[2]
    return mine


# ----------------------------------------------------------------- report ---
def _garbage(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text(
        '{"event": "telemetry.span", "path": "a", "wall_s": 0.1, "ts": 1.0}\n'
        "this is not json\n"
        '{"event": "telemetry.span", "path": "a", "wall_s": 0.3, "ts": 2.0}\n'
    )
    return str(p)


def _empty(tmp_path):
    p = tmp_path / "empty.jsonl"
    p.write_text("")
    return str(p)


def _snapshot_only(tmp_path):
    return _write(tmp_path / "snap.jsonl", [{
        "event": "telemetry.snapshot", "ts": 1.0,
        "counters": {"compile_cache/hits": 3},
        "gauges": {"live_buffer_bytes": {"device=cuda:0": 64.0}},
        "histograms": {"score/batch_fill_ratio": {
            "count": 1, "sum": 0.5, "mean": 0.5, "p50": 0.5, "p99": 0.5,
        }},
    }])


def _malformed(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text(
        "not json at all\n"
        + json.dumps({"event": "telemetry.span", "ts": 1.0, "path": "a", "wall_s": 0.1}) + "\n"
        + json.dumps({
            "event": "telemetry.snapshot", "ts": 2.0,
            "counters": "not-a-dict",
            "gauges": {"g": "not-a-dict", 7: {"x": 1.0}},
            "histograms": {
                "h1": "not-a-dict",
                "h2": {"count": 2, "mean": "NaNish"},
                "h3": {"count": 1, "sum": 0.1, "mean": 0.1, "p50": 0.1, "p99": 0.1},
            },
        }) + "\n"
    )
    return str(p)


def _resilience(tmp_path):
    return _write(tmp_path / "res.jsonl", [
        {"event": "telemetry.span", "ts": 1.0, "path": "score/dispatch", "wall_s": 0.02},
        {"event": "telemetry.snapshot", "ts": 2.0,
         "counters": {"score/retries": 4, "resilience/faults_injected": 2, "dedup/rows_in": 9},
         "gauges": {"langdetect_breaker_state": {"name=score": 1.0},
                    "langdetect_degraded": {"": 0.0}},
         "histograms": {}},
    ])


REPORT_CAPTURES = {
    "fixture": lambda tmp: FIXTURE,
    "fixture_regressed": lambda tmp: FIXTURE_REGRESSED,
    "garbage_lines": _garbage,
    "empty": _empty,
    "snapshot_only": _snapshot_only,
    "malformed_sections": _malformed,
    "resilience_block": _resilience,
}


@pytest.mark.parametrize("case", sorted(REPORT_CAPTURES))
def test_report_text_equals_jax(case, tmp_path, capsys):
    path = REPORT_CAPTURES[case](tmp_path)
    events = report.load_events(path)
    assert events == jreport.load_events(path)
    text = report.render_report(events)
    assert text == jreport.render_report(events)
    rc, out, _ = _both(report, jreport, [path], capsys)
    assert rc == 0 and out == text + "\n"


def test_report_sections_on_the_fixture(capsys):
    rc, out, _ = _run(report.main, [FIXTURE], capsys)
    assert rc == 0
    for stage in ("fit", "count", "topk", "score", "pack", "dispatch", "fetch"):
        assert re.search(rf"^\s*{stage}\b", out, re.M), stage
    for section in ("counters (last snapshot):", "histograms (last snapshot):"):
        assert section in out
    assert "score/batch_fill_ratio" in out


def test_report_edge_captures(tmp_path, capsys):
    assert "empty capture" in report.render_report(report.load_events(_empty(tmp_path)))
    text = report.render_report(report.load_events(_snapshot_only(tmp_path)))
    assert "no span events found" in text and "live_buffer_bytes" in text
    text = report.render_report(report.load_events(_malformed(tmp_path)))
    assert re.search(r"^a\s+1\b", text, re.M) and "h3" in text and "h2" not in text
    assert re.search(r"^a\s+2\b", report.render_report(report.load_events(_garbage(tmp_path))),
                     re.M)


def test_report_aggregates_like_jax():
    events = report.load_events(FIXTURE)
    mine, theirs = report.aggregate_spans(events), jreport.aggregate_spans(events)
    assert set(mine) == set(theirs)
    for path in mine:
        assert mine[path].snapshot() == theirs[path].snapshot()
    assert mine["score/pack"].count == 2 and mine["fit/count"].count == 1


@pytest.mark.parametrize("argv", [[], ["-h"], ["a.jsonl", "b.jsonl"], ["missing.jsonl"]],
                         ids=["none", "help", "two", "missing"])
def test_report_usage_and_missing_file(argv, tmp_path, capsys):
    argv = [str(tmp_path / a) if a.endswith(".jsonl") else a for a in argv]
    rc, _, _ = _both(report, jreport, argv, capsys)
    assert rc == 2


# ---------------------------------------------------------------- compare ---
def _fill(path, fill):
    return _write(path, [
        {"event": "telemetry.span", "ts": 1.0, "path": "score", "wall_s": 0.01},
        {"event": "telemetry.snapshot", "ts": 2.0, "counters": {}, "gauges": {},
         "histograms": {"score/batch_fill_ratio": {
             "count": 4, "sum": 4 * fill, "mean": fill, "p50": fill, "p99": fill}}},
    ])


def _table(path, table_bytes, per_dispatch_s=0.01, bytes_accessed=8e6, quant="int8",
           strategy="fused"):
    return _write(path, [
        {"event": "telemetry.span", "ts": 1.0, "path": "score/dispatch",
         "wall_s": per_dispatch_s},
        {"event": "telemetry.snapshot", "ts": 2.0, "counters": {}, "histograms": {},
         "gauges": {
             "langdetect_table_bytes": {
                 f"program=score/dispatch,quant={quant},strategy={strategy}": table_bytes},
             "program_bytes_accessed": {"program=score/dispatch": bytes_accessed},
             "device_peak_bytes_per_s": {"device=cuda": 3.35e12},
         }},
    ])


def _collect(path, collect_bytes):
    return _write(path, [
        {"event": "telemetry.span", "ts": 1.0, "path": "fit/collect", "wall_s": 0.002},
        {"event": "telemetry.snapshot", "ts": 2.0, "counters": {}, "histograms": {},
         "gauges": {"langdetect_fit_collect_bytes": {"program=fit/collect": collect_bytes}}},
    ])


def _counters(path, counters, span_path="serve/dispatch"):
    return _write(path, [
        {"event": "telemetry.span", "ts": 1.0, "path": span_path, "wall_s": 0.01},
        {"event": "telemetry.snapshot", "ts": 2.0, "counters": counters, "gauges": {},
         "histograms": {}},
    ])


def _serve_fill(path, fill, waste, coalesced, capacity):
    return _write(path, [
        {"event": "telemetry.span", "ts": 1.0, "path": "serve/dispatch", "wall_s": 0.01},
        {"event": "telemetry.snapshot", "ts": 2.0,
         "counters": {"serve/coalesced_rows": coalesced,
                      "serve/dispatch_capacity_rows": capacity},
         "gauges": {},
         "histograms": {"serve/fill_ratio": {"count": 10, "mean": fill, "p99": fill},
                        "serve/padding_waste": {"count": 10, "mean": waste, "p99": waste}}},
    ])


def _wire(path, wire_bytes, docs, real, cap):
    return _counters(path, {"score/wire_bytes": wire_bytes, "score/wire_docs": docs,
                            "score/real_bytes": real, "score/capacity_bytes": cap},
                     span_path="score")


def _cold(path, p50):
    return _write(path, [
        {"event": "telemetry.span", "ts": 1.0, "path": "serve/dispatch", "wall_s": 0.01},
        {"event": "telemetry.snapshot", "ts": 2.0, "counters": {}, "gauges": {},
         "histograms": {"zoo/cold_load_s": {"count": 9, "mean": 0.3, "p50": p50, "p99": 0.6}}},
    ])


# name -> (capture builder over tmp_path -> argv, expected exit code)
COMPARE_CASES = {
    "fixture_self": (lambda t: [FIXTURE, FIXTURE], 0),
    "fixture_regressed": (lambda t: [FIXTURE, FIXTURE_REGRESSED], 1),
    "generous_threshold": (lambda t: [FIXTURE, FIXTURE_REGRESSED, "--threshold", "5.0"], 0),
    "improvement_never_flags": (
        lambda t: [FIXTURE_REGRESSED, FIXTURE, "--threshold", "0.9"], 0),
    "metrics_p50_only": (lambda t: [FIXTURE, FIXTURE_REGRESSED, "--metrics", "p50"], 1),
    "min_seconds": (lambda t: [FIXTURE, FIXTURE_REGRESSED, "--min-seconds", "100"], 1),
    "fill_collapsed": (lambda t: [_fill(t / "a.jsonl", 0.9), _fill(t / "b.jsonl", 0.3)], 1),
    "fill_improved": (lambda t: [_fill(t / "b.jsonl", 0.3), _fill(t / "a.jsonl", 0.9)], 0),
    "table_bytes_dequantized": (lambda t: [
        _table(t / "a.jsonl", 12.6e6),
        _table(t / "b.jsonl", 50.4e6, quant="f32", strategy="gather")], 1),
    "table_bytes_same": (lambda t: [_table(t / "a.jsonl", 12.6e6)] * 2, 0),
    "bytes_utilization_up": (lambda t: [
        _table(t / "a.jsonl", 12.6e6, bytes_accessed=8e6),
        _table(t / "b.jsonl", 12.6e6, bytes_accessed=40e6)], 1),
    "tracked_only_in_candidate": (lambda t: [
        _counters(t / "plain.jsonl", {}, span_path="score/dispatch"),
        _table(t / "a.jsonl", 12.6e6)], 0),
    "fit_collect_ballooned": (lambda t: [
        _collect(t / "a.jsonl", 57_000.0), _collect(t / "b.jsonl", 1_572_864.0)], 1),
    "fit_collect_shrunk": (lambda t: [
        _collect(t / "b.jsonl", 1_572_864.0), _collect(t / "a.jsonl", 57_000.0)], 0),
    "serve_fill_down_waste_up": (lambda t: [
        _serve_fill(t / "a.jsonl", 0.9, 0.1, 900, 1000),
        _serve_fill(t / "b.jsonl", 0.4, 0.6, 400, 1000)], 1),
    "serve_fill_up": (lambda t: [
        _serve_fill(t / "b.jsonl", 0.4, 0.6, 400, 1000),
        _serve_fill(t / "a.jsonl", 0.9, 0.1, 900, 1000)], 0),
    "wire_bytes_per_doc_up": (lambda t: [
        _wire(t / "a.jsonl", 48_000, 1000, 40_000, 44_000),
        _wire(t / "b.jsonl", 132_000, 1000, 40_000, 128_000)], 1),
    "wire_bytes_per_doc_down": (lambda t: [
        _wire(t / "b.jsonl", 132_000, 1000, 40_000, 128_000),
        _wire(t / "a.jsonl", 48_000, 1000, 40_000, 44_000)], 0),
    "cross_tenant_reject_appears": (lambda t: [
        _counters(t / "a.jsonl", {}),
        _counters(t / "b.jsonl", {"zoo/cross_tenant_rejects": 1})], 1),
    "cross_tenant_reject_steady": (lambda t: [
        _counters(t / "b.jsonl", {"zoo/cross_tenant_rejects": 1})] * 2, 0),
    "per_tenant_shed": (lambda t: [
        _counters(t / "a.jsonl", {}), _counters(t / "b.jsonl", {"zoo/shed/noisy": 12})], 1),
    "evictions_informational": (lambda t: [
        _counters(t / "a.jsonl", {"zoo/evictions": 2, "zoo/cold_loads": 4}),
        _counters(t / "b.jsonl", {"zoo/evictions": 40, "zoo/cold_loads": 80})], 0),
    "evictions_appear": (lambda t: [
        _counters(t / "e.jsonl", {}),
        _counters(t / "a.jsonl", {"zoo/evictions": 2, "zoo/cold_loads": 4})], 0),
    "reject_rate_appears": (lambda t: [
        _counters(t / "a.jsonl", {"segment/docs": 10, "segment/rejects": 0}),
        _counters(t / "b.jsonl", {"segment/docs": 10, "segment/rejects": 3})], 1),
    "cold_load_p50": (lambda t: [_cold(t / "a.jsonl", 0.2), _cold(t / "b.jsonl", 0.4)], 1),
    "usage_none": (lambda t: [], 2),
    "usage_one": (lambda t: [FIXTURE], 2),
    "usage_bogus_flag": (lambda t: [FIXTURE, FIXTURE, "--bogus"], 2),
    "usage_threshold_without_value": (lambda t: [FIXTURE, FIXTURE, "--threshold"], 2),
    "missing_file": (lambda t: [str(t / "nope.jsonl"), FIXTURE], 2),
    "empty_baseline": (lambda t: [_empty(t), FIXTURE], 2),
}


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_matches_jax(case, tmp_path, capsys):
    build, want_rc = COMPARE_CASES[case]
    argv = build(tmp_path)
    rc, out, _ = _both(compare, jcompare, argv, capsys)
    assert rc == want_rc, out
    if rc == 2:
        return
    paths = [a for a in argv if a.endswith(".jsonl")]
    flags = dict(zip(argv[2::2], argv[3::2]))
    kw = {"threshold": float(flags.get("--threshold", compare.DEFAULT_THRESHOLD)),
          "min_seconds": float(flags.get("--min-seconds", 0.0))}
    if "--metrics" in flags:
        kw["metrics"] = tuple(flags["--metrics"].split(","))
    base, new = (compare.capture_stats(report.load_events(p)) for p in paths)
    jbase, jnew = (jcompare.capture_stats(jreport.load_events(p)) for p in paths)
    assert (base, new) == (jbase, jnew)
    got = compare.compare_captures(base, new, **kw)
    assert got == jcompare.compare_captures(jbase, jnew, **kw)
    assert bool(got[1]) == (want_rc == 1)


def test_compare_names_what_regressed(tmp_path, capsys):
    rc, out, _ = _run(compare.main, [FIXTURE, FIXTURE_REGRESSED], capsys)
    assert rc == 1 and "REGRESSION" in out
    assert re.search(r"score/dispatch\s+p99", out) and "score/batch_latency_s" in out
    a = _table(tmp_path / "a.jsonl", 12.6e6, bytes_accessed=8e6)
    key = "est_bytes_utilization[score/dispatch]"
    assert compare.capture_stats(report.load_events(a))["tracked"][key] == round(
        8e6 / 0.01 / 3.35e12, 6)
    rc, out, _ = _run(compare.main, [
        _counters(tmp_path / "e.jsonl", {}),
        _counters(tmp_path / "z.jsonl", {"zoo/evictions": 2})], capsys)
    assert rc == 0 and "informational" in out
