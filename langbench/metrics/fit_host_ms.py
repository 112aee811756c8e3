"""``fit_host_ms``: per fit, the program's ``fit/pack`` and ``fit/put`` spans
(planning and packing the batches into pinned staging, the copies)."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/pack") + span_s(rec, "fit/put")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
