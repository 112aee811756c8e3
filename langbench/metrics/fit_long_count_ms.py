"""``fit_long_count_ms``: per fit, the program's ``fit/long/count`` span (the
split fit's host count of the n = 4..5 windows per (gram, language))."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/long/count")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
