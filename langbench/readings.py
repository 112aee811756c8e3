#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from.

    python3 langbench/readings.py --workload <name> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: the cell's set-up and a short window at the
cell's own load (long enough that every document of the mix is labelled at
least once, or one fit is made), then the comparisons of
:mod:`langbench.checks` twice: of the program's outputs (the lower
readings) and of the control's, the plain reference put in the program's
place one precision down (the upper readings; each entry's ``control``),
and of the reference with each fault of the entry planted (``faults``).
One JSON line per seed, then one with the largest program reading and the
smallest control reading of each number. It needs a CUDA card, as a run
does; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from langbench import harness  # noqa: E402


def margins(scores) -> dict:
    """Quantiles (0, 0.1%, 1%, 50%) of the reference's lead of the best
    language over the second, as a share of the best score (at least 1)."""
    import numpy as np

    s = np.sort(np.concatenate(scores), axis=1)
    lead = (s[:, -1] - s[:, -2]) / np.maximum(s[:, -1], 1.0)
    return dict(zip(("min", "q0.001", "q0.01", "median"),
                    np.quantile(lead, [0, 0.001, 0.01, 0.5]).tolist()))


def read_seed(plan: dict, seed: int, seconds: float, device: str) -> dict:
    import torch

    from langbench import program

    config, mix = plan["config"], plan["mix"]
    entry = harness.load_entry(mix["entry"])
    if device.startswith("cuda"):
        program.use_checkout_build_dirs()
    state = entry.setup(config, mix, seed, device)
    calls = entry.window(state, seconds)
    out = entry.outputs(state, calls)
    del state
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    ref = entry.reference(config, out, device)
    row = {"seed": seed, "calls": len(calls), "program": entry.readings(out, ref),
           "control": entry.readings(entry.control(config, out, ref, device), ref)}
    if mix["entry"] == "transform":  # the same control with its sums in bfloat16 too
        row["margins"] = margins(ref["scores"])
        low = entry.control(config, out, ref, device, sum_dtype=torch.bfloat16)
        row["control_bf16_sums"] = entry.readings(low, ref)
    row["faults"] = {k: entry.readings(v, ref) for k, v in entry.faults(config, out, ref, device).items()}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("langbench.readings: no CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    plan = harness.cell_plan(bench, args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(read_seed(plan, seed, args.seconds, "cuda:0"))
        print(json.dumps(rows[-1]), flush=True)
    names = rows[0]["program"]
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows),
        "program_max": {k: max(r["program"][k] for r in rows) for k in names},
        "control_min": {k: min(r["control"][k] for r in rows) for k in names},
        "faults_min": {f: {k: min(r["faults"][f][k] for r in rows) for k in names}
                       for f in rows[0]["faults"]},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
