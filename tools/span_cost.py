#!/usr/bin/env python3
"""The host's cost of one telemetry span, with no sink and with the
benchmark's ``SpanSink`` attached.

Run from the root of a checkout:

    python3 tools/span_cost.py [--root DIR] [--spans 100000] [--rounds 5]

``DIR`` (default: this checkout) is the checkout whose
``spark_languagedetector_tpu_torch`` and ``langbench`` are imported, so the
same probe reads another version (for example the parent commit, unpacked
with ``git archive``). Each round times ``--spans`` empty ``span()`` blocks
without a sink, then as many with ``langbench.devtrace.SpanSink`` on the
registry, in µs per span. Prints one JSON object: the machine's CPU, both
series and their medians.
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import sys
import time
from pathlib import Path


def per_span_us(span, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with span("bench/empty"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--spans", type=int, default=100_000)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    from langbench.devtrace import SpanSink
    from spark_languagedetector_tpu_torch.telemetry import REGISTRY, span

    per_span_us(span, 1_000)  # warm
    bare, sunk = [], []
    for _ in range(args.rounds):
        bare.append(per_span_us(span, args.spans))
        sink = SpanSink()
        REGISTRY.add_sink(sink)
        try:
            sunk.append(per_span_us(span, args.spans))
        finally:
            REGISTRY.remove_sink(sink)
        if len(sink.spans) != args.spans:
            raise RuntimeError(f"the sink kept {len(sink.spans)} of {args.spans} spans")
    print(json.dumps({
        "root": args.root, "cpu": platform.processor() or platform.machine(),
        "spans": args.spans, "no_sink_us": bare, "span_sink_us": sunk,
        "no_sink_us_median": statistics.median(bare),
        "span_sink_us_median": statistics.median(sunk),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
