"""``fit_collect_weigh_ms``: per fit, the program's ``fit/collect/weigh`` span
(the winners' float64 weights on the host)."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/collect/weigh")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
