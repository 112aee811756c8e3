"""``fit_finalize_ms``: per fit, the program's ``fit/finalize`` span (the
weighting and the per-language top-k with its plateau re-rank)."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/finalize")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
