"""``fit_s``: the window's wall time over the fits it completed, the fits
run back to back (host clock)."""

from langbench.metrics._window import ok_calls


def read(rec: dict) -> float | None:
    n = len(ok_calls(rec))
    return rec["window_s"] / n if rec["entry"] == "fit" and n else None
