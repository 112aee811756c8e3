"""``hybrid_short_dispatch_ms_per_kdoc``: the program's ``hybrid/short`` spans
inside ``score/dispatch`` (the hybrid route's lengths 1 and 2: the
``bigram_hist`` launch and its float64 contraction, enqueued; unfenced, so
host time) per 1,000 documents."""

from langbench.metrics._window import per_kdoc_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "dispatch/hybrid/short")
    return per_kdoc_ms(rec, s) if rec["entry"] == "transform" and s > 0 else None
