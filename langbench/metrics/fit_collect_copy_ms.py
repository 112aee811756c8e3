"""``fit_collect_copy_ms``: per fit, the program's ``fit/collect/copy`` span
(the winners' count rows gathered on the device and copied to the host)."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/collect/copy")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
