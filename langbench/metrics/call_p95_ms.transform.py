"""``call_p95_ms.transform``: the 95th percentile of every call's time in
the window, from the call until the labelled table is back (host clock).
A per-layer reading: on a host whose cores are shared it spreads too widely
between runs to hold an end-to-end bound."""

import numpy as np


def read(rec: dict) -> float | None:
    if rec["entry"] != "transform":
        return None
    return float(np.percentile([(c["t1"] - c["t0"]) * 1e3 for c in rec["calls"]], 95))
