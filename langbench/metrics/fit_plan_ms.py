"""``fit_plan_ms``: per fit, the program's ``fit/plan`` span (the plan of the
count pass's batches)."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/plan")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
