"""The port's metric exporters held against the JAX package's.

The same sequence of registry operations, rendered by both packages'
``render_prometheus``, gives the same text (label escaping included); the
same events through both ``JsonlSink``s parse to the same records; and
``parse_sink_spec`` and ``configure_sinks_from_env`` agree, errors
included. A subprocess shows that ``LANGDETECT_METRICS_SINK`` arms the
port's sinks at import, with no import of JAX.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from spark_languagedetector_tpu.telemetry import export as jexport
from spark_languagedetector_tpu.telemetry.registry import Registry as JaxRegistry
from spark_languagedetector_tpu_torch.telemetry import export
from spark_languagedetector_tpu_torch.telemetry.registry import Registry

ROOT = Path(__file__).resolve().parent.parent


def _drive(reg) -> None:
    """One fixed sequence of registry operations (counters, histograms,
    gauges with labels that need escaping, spans with and without device
    time)."""
    reg.incr("score/batches", 3)
    reg.incr("stream/retries")
    reg.incr("fit/collect_bytes", 123456)
    for i in range(40):
        reg.observe("stream/queue_depth", (i * 7) % 5)
        reg.observe("score/batch_latency_s", 0.001 * (i + 1))
    reg.set_gauge("langdetect_dlq_rows", 2)
    reg.set_gauge("langdetect_fit_collect_bytes", 123456.0, program="fit/collect")
    reg.set_gauge("langdetect_retry_attempts", 1, site='stream/"batch"\\x\ny')
    reg.set_gauge("langdetect_serve_model_version", 1.0, version="v2")
    for i in range(12):
        reg.record_span("stream/transform", 0.01 * (i % 4 + 1), None, {"batch": i})
        reg.record_span("fit/count", 0.5 + i, 0.25 * (i + 1), {})
    reg.record_span('odd"path\\n', 0.125, None, {})


def test_render_prometheus_matches_the_jax_package():
    mine, ref = Registry(), JaxRegistry()
    assert export.render_prometheus(mine) == jexport.render_prometheus(ref) == ""
    _drive(mine)
    _drive(ref)
    text = export.render_prometheus(mine)
    assert text == jexport.render_prometheus(ref)
    assert '# TYPE langdetect_span_device_seconds summary' in text
    assert 'site="stream/\\"batch\\"\\\\x\\ny"' in text
    assert 'langdetect_counter_total{name="fit/collect_bytes"} 123456' in text


def test_prometheus_snapshot_sink_writes_on_flush(tmp_path):
    reg = Registry()
    _drive(reg)
    sink = export.PrometheusSnapshotSink(str(tmp_path / "m.prom"))
    reg.add_sink(sink)
    reg.flush()
    assert (tmp_path / "m.prom").read_text() == export.render_prometheus(reg)
    assert not (tmp_path / "m.prom.tmp").exists()


def test_jsonl_sink_lines_parse_to_the_same_events(tmp_path):
    events = [
        {"event": "telemetry.span", "ts": 100.0, "path": "stream", "wall_s": 0.5},
        {"event": "telemetry.span", "ts": 100.0, "path": "stream/batch", "rows": 3},
        {"event": "dlq.row", "ts": 99.0, "row": {"fulltext": "x"}, "batch": 2},
        {"event": "telemetry.snapshot", "ts": 101.5, "counters": {"a": 1},
         "obj": Path("/x")},
    ]
    mine = export.JsonlSink(str(tmp_path / "port" / "e.jsonl"))
    ref = jexport.JsonlSink(str(tmp_path / "jax" / "e.jsonl"))
    for e in events:
        mine.emit(dict(e))
        ref.emit(dict(e))
    mine.close()
    ref.close()
    mine.close()  # idempotent
    got = [json.loads(l) for l in (tmp_path / "port" / "e.jsonl").read_text().splitlines()]
    want = [json.loads(l) for l in (tmp_path / "jax" / "e.jsonl").read_text().splitlines()]
    assert got == want
    ts = [e["ts"] for e in got]
    assert ts == sorted(set(ts)) and ts[0] == 100.0  # strictly increasing


@pytest.mark.parametrize("spec", [
    "", "jsonl:/a.jsonl", " jsonl:/a.jsonl , prom:/b.prom ,", "prom:rel/x.prom",
    "jsonl", "csv:/a", "jsonl:", ":x", "prometheus:/b.prom",
])
def test_parse_sink_spec_agrees(spec):
    try:
        want = jexport.parse_sink_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            export.parse_sink_spec(spec)
        assert str(mine.value) == str(e)
    else:
        assert export.parse_sink_spec(spec) == want


def test_configure_sinks_from_env_agrees(tmp_path):
    assert export.configure_sinks_from_env(Registry(), env={}) == []
    assert jexport.configure_sinks_from_env(JaxRegistry(), env={}) == []
    for pkg, reg, mod in (("port", Registry(), export), ("jax", JaxRegistry(), jexport)):
        env = {export.SINK_ENV: f"jsonl:{tmp_path}/{pkg}/e.jsonl,prom:{tmp_path}/{pkg}/m.prom"}
        sinks = mod.configure_sinks_from_env(reg, env=env)
        assert [(s.kind, Path(s.path).name) for s in sinks] == [("jsonl", "e.jsonl"),
                                                               ("prom", "m.prom")]
        assert reg.sinks == sinks
        reg.clear_sinks()
    # All or nothing: the second entry fails, so the first is closed and
    # nothing is attached.
    blocker = tmp_path / "file"
    blocker.write_text("")
    bad = {export.SINK_ENV: f"jsonl:{tmp_path}/ok.jsonl,jsonl:{blocker}/sub/e.jsonl"}
    for reg, mod in ((Registry(), export), (JaxRegistry(), jexport)):
        with pytest.raises(OSError):
            mod.configure_sinks_from_env(reg, env=bad)
        assert reg.sinks == []
    with pytest.raises(ValueError, match="LANGDETECT_METRICS_SINK"):
        export.configure_sinks_from_env(Registry(), env={export.SINK_ENV: "csv:/x"})


def test_metrics_sink_env_arms_the_port_at_import(tmp_path):
    script = textwrap.dedent(
        """
        import json, sys
        for name in ("jax", "jaxlib", "spark_languagedetector_tpu"):
            sys.modules[name] = None
        from spark_languagedetector_tpu_torch.telemetry import REGISTRY, span
        from spark_languagedetector_tpu_torch.exec import config
        with span("stream", rows=3):
            REGISTRY.incr("stream/retries")
        REGISTRY.flush()
        print(json.dumps(config.effective_config()["knobs"]["metrics_sink"]))
        """
    )
    env = {**os.environ, "LANGDETECT_METRICS_SINK":
           f"jsonl:{tmp_path}/e.jsonl,prom:{tmp_path}/m.prom"}
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    knob = json.loads(res.stdout.strip().splitlines()[-1])
    assert knob["source"] == "env" and knob["value"].startswith("jsonl:")
    events = [json.loads(l) for l in (tmp_path / "e.jsonl").read_text().splitlines()]
    assert [e["event"] for e in events] == ["telemetry.span", "telemetry.snapshot"]
    assert events[0]["path"] == "stream" and events[1]["counters"]["stream/retries"] == 1
    assert 'langdetect_counter_total{name="stream/retries"} 1' in (
        tmp_path / "m.prom").read_text()
