#!/usr/bin/env python3
"""How often the stream workers' buffer takes meet a pending copy, on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/staging_probe.py [--root DIR] [--runs 4]

``DIR`` (default: this checkout) is the checkout whose
``spark_languagedetector_tpu_torch`` and ``chip_smoke.py`` are imported, so
the same probe reads another version (for example the parent commit,
unpacked with ``git archive`` under ``build/``). It fits ``chip_smoke.py``'s
phase-16 model (config 4: 10 languages, exact n = 1..3, profile 3,000,
fused kernel) and streams its 10,000 documents as that phase's spin check
does: 1,024-row source batches, 64-row runner batches, four workers on one
runner, a 40M-cycle spin queued ahead of every host-to-device copy and one
pinned buffer per size class. It counts the takes that waited on a pending
copy (the ring's own ``waits``) and logs the time of every take, for the
gap between one worker's consecutive takes. A dispatch path that drains the
stream at every batch shows as workers taking in lockstep, one round per
four spins, with few waits.

Prints one line per run, the card's name and power limit, and as its last
line a JSON object with every run's numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("staging_probe: needs a CUDA card")
    import chip_smoke as cs
    from spark_languagedetector_tpu_torch import LanguageDetector, Table
    from spark_languagedetector_tpu_torch.exec import staging
    from spark_languagedetector_tpu_torch.ops._kernels import KERNELS, build_all
    from spark_languagedetector_tpu_torch.stream import memory_source, run_stream

    dev = torch.device("cuda", 0)
    build_all([k for k in KERNELS if k.name == "fused_detect"])
    langs = cs.language_names(10)
    train, labels = cs.make_corpus(langs, 60 * len(langs), seed=1)
    model = LanguageDetector(langs, [1, 2, 3], 3000, device=str(dev)).fit(
        Table({"lang": labels, "fulltext": train}))
    rows = [{"fulltext": t} for t in cs.make_corpus(langs, 10000, seed=2)[0]]
    runner = model.runner
    runner.batch_size = 64
    real_take = staging.HostStaging.take
    real_to_device = staging.Staged.to_device
    log: list[tuple[int, float]] = []

    def take(self, fields):
        st = real_take(self, fields)
        log.append((threading.get_ident(), time.perf_counter()))
        return st

    def delayed(self):
        torch.cuda._sleep(cs.STAGING_SPIN_CYCLES)
        return real_to_device(self)

    ring = runner._staging
    runs = []
    try:
        for i in range(args.runs):
            runner._staging = staging.HostStaging(dev)
            log.clear()
            t0 = time.perf_counter()
            with cs.swapped(staging, "RING_DEPTH", 1), \
                    cs.swapped(staging.Staged, "to_device", delayed), \
                    cs.swapped(staging.HostStaging, "take", take):
                run_stream(model, memory_source(rows, 1024), lambda t: None,
                           prefetch=6, workers=4)
            wall = time.perf_counter() - t0
            gaps = []
            for tid in {t for t, _ in log}:
                times = [t for u, t in log if u == tid]
                gaps += list(np.diff(times) * 1e3)
            run = {"takes": len(log), "waited": runner._staging.waits, "wall_s": wall,
                   "gap_ms_p50": float(np.median(gaps)) if gaps else None}
            runs.append(run)
            print(f"run {i}: {run['takes']} takes, {run['waited']} waited on a pending copy, "
                  f"wall {wall:.2f} s, a worker's takes {run['gap_ms_p50']:.1f} ms apart (p50)",
                  flush=True)
    finally:
        runner._staging = ring
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"root": str(args.root), "runs": runs}))


if __name__ == "__main__":
    main()
