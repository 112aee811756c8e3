"""``mfu.fit``: the least time of the window's compulsory work
(:mod:`langbench.count`) over the traced window's wall time, in %: the
whole step's share of the card's peak."""

from langbench.metrics._window import roofline_pct


def read(rec: dict) -> float | None:
    return roofline_pct(rec, "fit", (rec.get("device") or {}).get("window_s", 0.0))
