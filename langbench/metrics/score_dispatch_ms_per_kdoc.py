"""``score_dispatch_ms_per_kdoc``: the program's ``score/dispatch`` spans
(the copy to the device, the wrappers' torch ops and the kernel launches;
unfenced, so host time) per 1,000 documents."""

from langbench.metrics._window import per_kdoc_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "score/dispatch")
    return per_kdoc_ms(rec, s) if rec["entry"] == "transform" and s > 0 else None
