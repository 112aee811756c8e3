"""``fit_long_select_ms``: per fit, the program's ``fit/long/select`` span (the
n = 4..5 grams' float64 weights and per-language top-k on the host) plus
its ``fit/merge`` span (the joint top-k over both halves, the sort by id)."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/long/select") + span_s(rec, "fit/merge")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
