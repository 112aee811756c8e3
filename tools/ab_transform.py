#!/usr/bin/env python3
"""Warm transforms of two checkouts of the PyTorch port, timed in turns on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/ab_transform.py --baseline OLD [--rounds 12] [--out FILE]

``OLD`` is another version's checkout (for example the parent commit,
unpacked with ``git archive`` under ``build/``). Each checkout gets a worker
process that imports its own ``spark_languagedetector_tpu_torch``, fits the
config-5 model (176 languages, hashed 2^20, n = 1..5, profile 400: fused
kernel) and the config-3 model (50 languages, exact n = 1..5, profile 1,000,
cuckoo: hybrid kernels) on the host from ``chip_smoke.py``'s synthetic
corpus, and warms both. The workers then take turns, one warm
``model.transform`` of the evaluation table at a time (6,004 documents at
config 5, 8,006 at config 3), in the order A B B A per round, so drift in
the card's or the host's speed falls on both sides alike; only the timed
worker runs, the other waits on its pipe. Times are host wall clock around
the call and a ``torch.cuda.synchronize``.

Prints one line per round, the medians and per-round ratios, the card's name
and power limit, and as its last line a JSON object with every time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ("5", "3")


def _models(dev):
    """(config -> (model, table)) fitted from chip_smoke.py's corpus."""
    import chip_smoke as cs
    from spark_languagedetector_tpu_torch import LanguageDetector, Table

    out = {}
    langs = cs.language_names(176)
    train, labels = cs.make_corpus(langs, 30 * len(langs), seed=1)
    det = (LanguageDetector(langs, [1, 2, 3, 4, 5], 400, device=str(dev))
           .set_vocab_mode("hashed").set_hash_bits(20))
    model = det.fit(Table({"lang": labels, "fulltext": train}))
    texts = (cs.make_corpus(langs, 6000, seed=2)[0]
             + cs.make_corpus(langs[:4], 4, mean_len=20000, seed=3)[0])
    out["5"] = (model, Table({"fulltext": texts}))
    langs = cs.language_names(50)
    train, labels = cs.make_corpus(langs, 40 * len(langs), seed=1)
    det = LanguageDetector(langs, [1, 2, 3, 4, 5], 1000, device=str(dev)).set_vocab_mode("exact")
    model = det.fit(Table({"lang": labels, "fulltext": train}))
    texts = (cs.make_corpus(langs, 8000, seed=2)[0]
             + cs.make_corpus(langs[:3], 3, mean_len=20000, seed=3)[0]
             + ["", "\x01\x02\x03\x04\x05\x06", "\x01"])
    out["3"] = (model, Table({"fulltext": texts}))
    return out


def worker(checkout: Path) -> None:
    """Serve timed transforms of ``checkout``'s package: one line in (a
    config), one line out (seconds)."""
    sys.path.insert(0, str(checkout))
    sys.path.insert(1, str(ROOT))  # chip_smoke.py's corpus
    import torch

    import spark_languagedetector_tpu_torch as port

    if Path(port.__file__).resolve().parent.parent != checkout.resolve():
        raise SystemExit(f"imported the port from {port.__file__}, not from {checkout}")
    dev = torch.device("cuda", 0)
    models = _models(dev)
    labels = {}
    for cfg, (model, table) in models.items():
        for _ in range(3):
            labels[cfg] = model.transform(table).column("lang").tolist()
        torch.cuda.synchronize()
    print(json.dumps({"ready": True, "labels": labels}), flush=True)
    for line in sys.stdin:
        model, table = models[line.strip()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transform(table)
        torch.cuda.synchronize()
        print(time.perf_counter() - t0, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True, metavar="DIR")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    ap.add_argument("--worker", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sides = {"change": ROOT, "baseline": args.baseline.resolve()}
    procs = {
        name: subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--baseline", str(path),
             "--worker", str(path)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        )
        for name, path in sides.items()
    }
    try:
        ready = {name: json.loads(p.stdout.readline()) for name, p in procs.items()}
        if ready["change"]["labels"] != ready["baseline"]["labels"]:
            raise SystemExit("the two checkouts label the tables differently")

        def timed(name: str, cfg: str) -> float:
            p = procs[name]
            p.stdin.write(cfg + "\n")
            p.stdin.flush()
            return float(p.stdout.readline())

        times = {cfg: {"change": [], "baseline": []} for cfg in CONFIGS}
        for r in range(args.rounds):
            for cfg in CONFIGS:
                order = ("change", "baseline") if r % 2 == 0 else ("baseline", "change")
                for name in order + order[::-1]:
                    times[cfg][name].append(timed(name, cfg))
            print(f"round {r + 1}: " + "; ".join(
                f"config {cfg} change {times[cfg]['change'][-1] * 1e3:.2f}/"
                f"{times[cfg]['change'][-2] * 1e3:.2f} ms, baseline "
                f"{times[cfg]['baseline'][-1] * 1e3:.2f}/{times[cfg]['baseline'][-2] * 1e3:.2f} ms"
                for cfg in CONFIGS), flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
        for p in procs.values():
            p.wait(timeout=60)
    summary = {}
    for cfg in CONFIGS:
        a, b = times[cfg]["change"], times[cfg]["baseline"]
        ratios = [x / y for x, y in zip(a, b)]
        summary[cfg] = {
            "change_median_ms": statistics.median(a) * 1e3,
            "baseline_median_ms": statistics.median(b) * 1e3,
            "ratio_median": statistics.median(ratios),
            "ratio_min": min(ratios),
            "ratio_max": max(ratios),
            "pairs": len(ratios),
        }
        print(f"config {cfg}: change median {summary[cfg]['change_median_ms']:.2f} ms, "
              f"baseline median {summary[cfg]['baseline_median_ms']:.2f} ms, change/baseline "
              f"per pair median {summary[cfg]['ratio_median']:.4f} (range "
              f"{summary[cfg]['ratio_min']:.4f}-{summary[cfg]['ratio_max']:.4f}, "
              f"{len(ratios)} pairs) ({smi})", flush=True)
    print(smi)
    result = {"card": smi, "summary": summary, "times_s": times}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result) + "\n")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
