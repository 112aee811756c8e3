"""The port's SLO evaluator, trace stitcher and router front ``slo=``
against the JAX package's, and captures read across the packages.

* SLO: the same aggregate sequence under the same ``now=`` sequence gives
  the same status dict at every step in both packages (trip and clear of
  availability, a counter reset, latency and freshness, a latency alert
  clearing in silence, quiet windows), and the same ``slo/*`` counters,
  histogram and gauges.
* stitch: the same clock offsets, labels, flows, nesting slack and
  stitched JSON on a synthetic two-process capture, and from the CLI.
* ``RouterServer(slo=)`` on the CPU: ``/healthz`` carries the same ``slo``
  block as the JAX front's, its reasons join while an objective burns and
  leave when it clears; ``/varz`` carries the status too.
* Across the packages: a capture the port wrote renders in the JAX
  ``report``, ``compare`` and ``stitch`` CLIs exactly as in the port's, and
  a JAX capture in the port's.
"""

import json
import re

import numpy as np
import pytest

from spark_languagedetector_tpu.telemetry import compare as jcompare
from spark_languagedetector_tpu.telemetry import registry as jregistry
from spark_languagedetector_tpu.telemetry import report as jreport
from spark_languagedetector_tpu.telemetry import slo as jslo
from spark_languagedetector_tpu.telemetry import stitch as jstitch
from spark_languagedetector_tpu_torch.telemetry import compare, report, slo, stitch
from spark_languagedetector_tpu_torch.telemetry.registry import Registry


def _agg(requests, sheds, *, p99=None, age=None):
    out = {
        "counters": {"fleet/requests": requests, "fleet/shed_requests": sheds,
                     "serve/shed_requests": 0},
        "histograms": {}, "gauges": {},
    }
    if p99 is not None:
        out["histograms"]["fleet/request_s"] = {"count": requests, "p99": p99}
    if age is not None:
        out["gauges"]["langdetect_fleet_scrape_age_s"] = {"": age}
    return out


# name -> (objective kwargs, [(aggregate, now), ...])
SLO_SEQUENCES = {
    "availability_trip_and_clear": ({}, [
        (_agg(100, 0), 0.0), (_agg(200, 50), 1.0), (_agg(300, 50), 2.0),
        (_agg(400, 50), 20.0)]),
    "counter_reset_clamped": ({}, [(_agg(100, 0), 0.0), (_agg(40, 0), 1.0)]),
    "latency_and_freshness": ({"latency_p99_ms": 250.0, "freshness_s": 10.0}, [
        (_agg(10, 0, p99=0.1, age=1.0), 0.0), (_agg(20, 0, p99=0.9, age=99.0), 1.0),
        (_agg(30, 0, p99=0.1, age=1.0), 20.0)]),
    "latency_clears_in_silence": ({"latency_p99_ms": 250.0}, [
        (_agg(10, 0, p99=0.9), 0.0), (_agg(20, 0, p99=0.9), 1.0),
        (_agg(20, 0, p99=0.9), 20.0)]),
    "quiet_windows": ({}, [(_agg(0, 0), float(t)) for t in range(5)]),
    "long_window_holds_back": ({}, [
        (_agg(1000, 0), 0.0), (_agg(1100, 0), 25.0), (_agg(1110, 10), 50.0),
        (_agg(1120, 20), 51.0), (_agg(2000, 20), 90.0)]),
}


def _slo_run(mod, reg, objective_kw, seq):
    ev = mod.SloEvaluator(mod.default_objectives(**objective_kw), registry=reg,
                          short_window_s=10.0, long_window_s=30.0)
    steps = [(ev.ingest(agg, now=now), ev.burning(), ev.reasons()) for agg, now in seq]
    snap = reg.snapshot()
    names = {
        "counters": {k: v for k, v in snap["counters"].items() if k.startswith("slo/")},
        "histograms": {k: v for k, v in snap["histograms"].items() if k.startswith("slo/")},
        "gauges": {k: v for k, v in snap["gauges"].items() if "slo" in k},
    }
    return steps, names


@pytest.mark.parametrize("case", sorted(SLO_SEQUENCES))
def test_slo_sequence_matches_jax(case):
    objective_kw, seq = SLO_SEQUENCES[case]
    mine = _slo_run(slo, Registry(), objective_kw, seq)
    theirs = _slo_run(jslo, jregistry.Registry(), objective_kw, seq)
    assert mine == theirs
    assert mine[1]["histograms"]["slo/burn_rate"]["count"] == len(seq)


def test_slo_availability_trips_once_and_clears():
    reg = Registry()
    ev = slo.SloEvaluator(slo.default_objectives(), registry=reg,
                          short_window_s=10.0, long_window_s=30.0)
    assert not ev.ingest(_agg(100, 0), now=0.0)["burning"]
    st = ev.ingest(_agg(200, 50), now=1.0)
    assert st["burning"] and st["reasons"] == ["slo_availability_burn"]
    assert st["objectives"]["availability"]["burn_long"] >= 1.0
    assert ev.ingest(_agg(300, 50), now=2.0)["burning"]
    assert reg.counters["slo/alerts"] == 1
    st = ev.ingest(_agg(400, 50), now=20.0)
    assert not st["burning"] and not ev.burning() and reg.counters["slo/alerts"] == 1
    assert reg.snapshot()["gauges"]["langdetect_slo_burn_rate"][
        "objective=availability"] == 0.0


def test_slo_objective_validation_matches_jax():
    for mod in (slo, jslo):
        with pytest.raises(ValueError, match="unknown objective kind"):
            mod.Objective("x", "nope")
        with pytest.raises(ValueError, match="target"):
            mod.Objective("x", "availability", target=1.0)
        with pytest.raises(ValueError, match="threshold"):
            mod.Objective("x", "latency_p99")
        with pytest.raises(ValueError, match="windows"):
            mod.SloEvaluator(short_window_s=10.0, long_window_s=5.0)
    assert [o.describe() for o in slo.default_objectives()] == [
        o.describe() for o in jslo.default_objectives()]
    assert slo.SloEvaluator(registry=Registry()).status() == jslo.SloEvaluator(
        registry=jregistry.Registry()).status()


# ---------------------------------------------------------------- stitch ----
def _span(ts, path, wall_s, trace_id=None, **ident):
    ev = {"event": "telemetry.span", "ts": ts, "path": path, "wall_s": wall_s}
    if trace_id is not None:
        ev["trace_id"] = trace_id
    ev.update(ident)
    return ev


def _write(path, events):
    path.write_text("".join(json.dumps(ev) + "\n" for ev in events))
    return str(path)


def _two_process(tmp_path):
    router = [
        {"event": stitch.CLOCK_SYNC_EVENT, "ts": 90.0, "replica": "r0", "pid": 123,
         "platform": "gpu", "offset_s": 2.0},
        _span(100.0, "fleet/dispatch", 1.0, trace_id="t1", tid=1),
        {"event": "telemetry.snapshot", "ts": 101.0, "counters": {},
         "gauges": {"langdetect_fleet_ready_replicas": {"": 1.0}}, "histograms": {}},
    ]
    replica = [
        _span(98.35, "serve/dispatch", 0.8, trace_id="t1", replica="r0", pid=123,
              platform="gpu", tid=2),
        _span(98.2, "serve/dispatch/score", 0.5, trace_id="t1", replica="r0", pid=123,
              platform="gpu", tid=2, device_s=0.4),
        _span(98.0, "score/pack", 0.01, replica="r0", pid=123, tid=3),
    ]
    return [_write(tmp_path / "router.jsonl", router),
            _write(tmp_path / "replica-r0.jsonl", replica)]


def test_stitch_matches_jax(tmp_path):
    paths = _two_process(tmp_path)
    caps = stitch.load_captures(paths)
    assert caps == jstitch.load_captures(paths)
    by_label = {c["label"]: c for c in caps}
    assert by_label["router"]["offset_s"] == 0.0 and by_label["r0"]["offset_s"] == 2.0
    flows = stitch.trace_flows(caps)
    assert flows == jstitch.trace_flows(caps)
    spans = flows["t1"]
    assert [s["path"] for s in spans] == [
        "fleet/dispatch", "serve/dispatch", "serve/dispatch/score"]
    assert spans[1]["start_s"] == pytest.approx(99.55)
    slack = stitch.nesting_slack_s(spans)
    assert slack == jstitch.nesting_slack_s(spans) == pytest.approx(0.2)
    assert stitch.nesting_slack_s(spans[:2]) is None
    assert stitch.render_stitched_trace(caps) == jstitch.render_stitched_trace(caps)


def test_stitch_clock_offsets_match_jax():
    events = [
        {"event": stitch.CLOCK_SYNC_EVENT, "replica": "r0", "offset_s": 1.0},
        {"event": stitch.CLOCK_SYNC_EVENT, "replica": "r0", "offset_s": 3.5},
        {"event": stitch.CLOCK_SYNC_EVENT, "replica": "r1", "offset_s": -0.5},
        {"event": stitch.CLOCK_SYNC_EVENT, "replica": None, "offset_s": 9.0},
    ]
    assert stitch.clock_offsets(events) == jstitch.clock_offsets(events) == {
        "r0": 3.5, "r1": -0.5}


def test_stitch_cli_matches_jax(tmp_path, capsys):
    paths = _two_process(tmp_path)
    outs = []
    for mod in (stitch, jstitch):
        out = tmp_path / mod.__name__.split(".")[0] / "stitched.json"
        capsys.readouterr()
        assert mod.main([*paths, "-o", str(out)]) == 0
        assert capsys.readouterr().out == f"{out}\n"
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1]
    names = {ev["args"]["name"] for ev in outs[0]["traceEvents"]
             if ev.get("name") == "process_name"}
    assert names == {"router", "r0 (pid 123)"}
    for mod in (stitch, jstitch):
        assert mod.main([]) == 2 and mod.main(["-o"]) == 2


# ------------------------------------------------------ router front slo= --
LANGS = ("x", "y", "z")
GRAM_MAP = {g: np.random.default_rng(3).normal(size=3).tolist()
            for g in (b"ab", b"bc", b"zz", b"abc", b"zza")}


def _fronts():
    """One two-replica fleet of each package behind its router front, with
    an SloEvaluator on its own registry."""
    from spark_languagedetector_tpu import LanguageDetectorModel as JaxModel
    from spark_languagedetector_tpu.serve.fleet import ServeFleet as JaxFleet
    from spark_languagedetector_tpu.serve.quarantine import QuarantineTable as JaxQuarantine
    from spark_languagedetector_tpu.serve.router import RouterServer as JaxFront
    from spark_languagedetector_tpu_torch import LanguageDetectorModel
    from spark_languagedetector_tpu_torch.serve import QuarantineTable, RouterServer, ServeFleet

    kw = dict(probe_interval_ms=30.0, probe_timeout_s=10.0, breaker_threshold=2,
              breaker_cooldown_s=30.0)
    jmodel = JaxModel.from_gram_map(GRAM_MAP, (2, 3), LANGS)
    model = LanguageDetectorModel.from_gram_map(GRAM_MAP, (2, 3), LANGS, device="cpu")
    jfleet = JaxFleet([jmodel] * 2, router_kw={**kw, "quarantine": JaxQuarantine(0)},
                      max_wait_ms=2).start(probe=False)
    fleet = ServeFleet([model] * 2, device="cpu", max_wait_ms=2,
                       router_kw={**kw, "quarantine": QuarantineTable(0)}).start(probe=False)
    jev = jslo.SloEvaluator(registry=jregistry.Registry(), short_window_s=10.0,
                            long_window_s=30.0)
    ev = slo.SloEvaluator(registry=Registry(), short_window_s=10.0, long_window_s=30.0)
    return ((fleet, RouterServer(fleet.router, fleet=fleet, port=0, slo=ev), ev),
            (jfleet, JaxFront(jfleet.router, fleet=jfleet, port=0, slo=jev), jev))


def test_router_front_healthz_carries_the_jax_slo_block():
    from spark_languagedetector_tpu_torch.serve import ServeClient

    fronts = _fronts()
    try:
        for _, front, _ in fronts:
            front.start()
        clients = [ServeClient(*front.address) for _, front, _ in fronts]
        seen = []
        for agg, now in SLO_SEQUENCES["availability_trip_and_clear"][1]:
            for _, _, ev in fronts:
                ev.ingest(agg, now=now)
            mine, theirs = (c.healthz() for c in clients)
            assert mine["slo"] == theirs["slo"]
            burning = [r for r in mine.get("reasons", []) if r.startswith("slo_")]
            assert burning == [r for r in theirs.get("reasons", []) if r.startswith("slo_")]
            seen.append((mine["slo"]["burning"], burning))
        assert seen == [(False, []), (True, ["slo_availability_burn"]),
                        (True, ["slo_availability_burn"]), (False, [])]
        assert clients[0].varz()["slo"] == fronts[0][2].status()
    finally:
        for fleet, front, _ in fronts:
            front.stop()
            fleet.close()


# ------------------------------------------------------ across the packages -
def _port_capture(path):
    """A capture the port writes: a fit and two transforms of a tiny model
    through the runner, spans and a snapshot, in the jsonl sink."""
    from spark_languagedetector_tpu_torch import LanguageDetector, Table
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY
    from spark_languagedetector_tpu_torch.telemetry.export import JsonlSink

    sink = JsonlSink(str(path))
    REGISTRY.reset()
    REGISTRY.add_sink(sink)
    try:
        rows = [{"lang": ("en", "de")[i % 2], "fulltext": ("the cat sat", "der hund lief")[i % 2]
                 * (1 + i % 3)} for i in range(20)]
        model = LanguageDetector(["en", "de"], [1, 2, 3], 50, device="cpu").fit(
            Table.from_rows(rows))
        for _ in range(2):
            model.transform(Table({"fulltext": ["the cat", "der hund", "cat dog"] * 3}))
        model.runner._cost_thread.join()
        REGISTRY.flush()
    finally:
        REGISTRY.remove_sink(sink)
        sink.close()
    return str(path)


def _jax_capture(path):
    from spark_languagedetector_tpu import LanguageDetector, Table
    from spark_languagedetector_tpu.telemetry import REGISTRY
    from spark_languagedetector_tpu.telemetry.export import JsonlSink

    sink = JsonlSink(str(path))
    REGISTRY.reset()
    REGISTRY.add_sink(sink)
    try:
        rows = [{"lang": ("en", "de")[i % 2], "fulltext": ("the cat sat", "der hund lief")[i % 2]
                 * (1 + i % 3)} for i in range(20)]
        model = LanguageDetector(["en", "de"], [1, 2, 3], 50).fit(Table.from_rows(rows))
        model.transform(Table({"fulltext": ["the cat", "der hund", "cat dog"] * 3}))
        REGISTRY.flush()
    finally:
        REGISTRY.remove_sink(sink)
        sink.close()
    return str(path)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_captures_render_alike_in_both_packages_clis(writer, tmp_path, capsys):
    path = (_port_capture if writer == "port" else _jax_capture)(tmp_path / f"{writer}.jsonl")
    events = report.load_events(path)
    assert any(e.get("event") == "telemetry.span" for e in events)
    assert any(e.get("event") == "telemetry.snapshot" for e in events)

    def run(main, argv):
        capsys.readouterr()
        rc = main(argv)
        return rc, capsys.readouterr().out

    for mine, theirs, argv in (
        (report.main, jreport.main, [path]),
        (compare.main, jcompare.main, [path, path]),
    ):
        got = run(mine, argv)
        assert got == run(theirs, argv)
        assert got[0] == 0
    outs = []
    for mod in (stitch, jstitch):
        out = tmp_path / f"{mod.__name__.split('.')[0]}.json"
        assert run(mod.main, [path, "-o", str(out)]) == (0, f"{out}\n")
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1]
    if writer == "port":
        text = report.render_report(events)
        for stage in ("fit", "score", "pack", "dispatch", "fetch"):
            assert re.search(rf"^\s*{stage}\b", text, re.M), stage
        assert "program_flops{program=score/dispatch}" in text
