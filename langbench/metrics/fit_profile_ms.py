"""``fit_profile_ms``: per fit, the program's ``fit/profile`` span (the
``GramProfile`` and the model built from it)."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/profile")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
