"""``fit_wait_ms``: per fit, the program's ``fit/winners`` span (the host's
wait for the device's count and finalize, and the winners' ids)."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/winners")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
