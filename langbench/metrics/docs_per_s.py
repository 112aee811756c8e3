"""``docs_per_s``: documents labelled by the window's calls over the
window's wall time (host clock, first call's start to last call's end)."""

from langbench.metrics._window import ok_calls


def read(rec: dict) -> float | None:
    if rec["entry"] != "transform":
        return None
    return sum(c["docs"] for c in ok_calls(rec)) / rec["window_s"]
