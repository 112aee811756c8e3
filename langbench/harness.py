"""Run one benchmark cell once and report it.

``python3 langbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (``configs``), its traffic mix
(``langbench/mixes/<traffic>.json``), the mix's entry point
(``langbench/entries/<entry>.py``), the readers of its metrics
(``langbench/metrics/<metric>.py``) and the limits of its comparisons
(``langbench/limits/<workload>.json``). Adding a cell, a configuration, a mix
or a metric adds files and entries; no file here changes.

A run: set-up (the entry's: inputs from the seed, the program built and
warmed); the window, ``seconds`` long, traced with ``--trace 1``; the peak
device memory read; the program's state freed; then the plain reference,
the comparisons against their limits, and one JSON line on standard output,
last. Without a CUDA card (or with fewer than the cell asks for) it exits
with code 2 and prints no result; if JAX or the JAX package got loaded, with
code 3.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_languagedetector_tpu")


def process_age_s() -> float | None:
    """Seconds since this process started (from ``/proc``), or None."""
    try:
        import os

        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return None


_IMPORTED_AT = time.perf_counter()
_AGE_AT_IMPORT = process_age_s()


def setup_clock() -> float:
    """Seconds since the process started."""
    base = _AGE_AT_IMPORT if _AGE_AT_IMPORT is not None else 0.0
    return base + time.perf_counter() - _IMPORTED_AT


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"langbench._by_name.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(name: str):
    return importlib.import_module(f"langbench.entries.{name}")


def cell_plan(bench: dict, workload: str) -> dict:
    """The cell ``workload`` resolved: its entry, configuration, mix, and the
    end-to-end and per-layer metrics it reports."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((CHECKOUT / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
    return {"cell": cell, "config": config, "mix": mix, "end_to_end": e2e, "per_layer": layer}


def read_metrics(specs: list[dict], rec: dict) -> dict:
    """Each metric's reader (``metrics/<name>.py``, ``read(rec)``) over the
    window's record; a reader that finds nothing returns None and the metric
    is left out."""
    out = {}
    for m in specs:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit() -> str | None:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return got.stdout.strip().splitlines()[0] if got.stdout.strip() else None


def run_cell(plan: dict, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """One run of a resolved cell on ``device`` ("cuda:0" for a measurement;
    the tests run it on "cpu"). Returns the result object."""
    import torch

    from . import checks, devtrace, program
    from .peaks import peaks_of

    cell, config, mix = plan["cell"], plan["config"], plan["mix"]
    entry = load_entry(mix["entry"])
    cuda = device.startswith("cuda")
    phases = [("start and imports", setup_clock())]
    if cuda:
        program.use_checkout_build_dirs()
        phases.append(("program import", setup_clock() - phases[0][1]))
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        phases.append(("device context", setup_clock() - sum(s for _, s in phases)))
    state = entry.setup(config, mix, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = setup_clock()
    phases += state.pop("phases", [])
    print("langbench: set-up " + ", ".join(f"{n} {s:.3f} s" for n, s in phases), file=sys.stderr)
    # Set-up's objects leave the collector's generations, so a collection in
    # the window walks only what the window allocates.
    gc.collect()
    gc.freeze()

    sink = tracer = None
    if trace:
        sink = devtrace.SpanSink()
        program.registry().add_sink(sink)
        tracer = devtrace.DeviceTrace().__enter__() if cuda else None
    try:
        calls = entry.window(state, seconds)
    finally:
        if tracer is not None:
            tracer.__exit__(None, None, None)
        if sink is not None:
            program.registry().remove_sink(sink)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    failed = [c for c in calls if not c["ok"]]
    if failed:
        print(f"langbench: {len(failed)} of {len(calls)} calls failed, the first with "
              f"{failed[0]['error']}", file=sys.stderr)
    out = entry.outputs(state, calls)
    del state
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = entry.reference(config, out, device)
    correct, table = checks.judge(entry.readings(out, ref), checks.limits_of(cell["name"]))

    rec = {"entry": mix["entry"], "calls": calls, "setup_s": setup_s,
           "window_s": calls[-1]["t1"] - calls[0]["t0"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": sum(c["docs"] for c in calls),
              "failed": sum(c["docs"] for c in calls if not c["ok"])}
    if trace:
        # Device numbers come from the card's trace alone: a CPU run has none.
        summary = devtrace.summarize(tracer, sink.spans, calls, mix["entry"]) if cuda else None
        peaks = peaks_of(dev["kind"]) if cuda else None
        rec.update(spans=sink.spans, device=summary, peaks=peaks,
                   work=entry.work(config, out, ref, calls, device) if peaks else None)
        result["metrics"] = read_metrics(plan["per_layer"], rec)
        if summary is not None:
            dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    else:
        result["metrics"] = read_metrics(plan["end_to_end"], rec)
    if cuda:
        dev["power_limit"] = power_limit()
    result["device"] = dev
    result["checks"] = table
    return result


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    plan = cell_plan(bench, args.workload)
    import torch

    chips = int(plan["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"langbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(plan, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"langbench: the run loaded {bad}", file=sys.stderr)
        return 3
    dev = result["device"]
    print(f"langbench: {args.workload} seed {args.seed} on {dev['kind']} "
          f"({dev.get('power_limit')}); correct={result['correct']}", file=sys.stderr)
    for name, t in result["checks"].items():
        print(f"check {name} = {t['value']!r} (limit {t['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
