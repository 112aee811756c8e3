"""``transform_encode_ms_per_kdoc``: the program's ``transform/encode`` spans
(the estimator's input column to a list and to UTF-8 bytes) per 1,000
documents."""

from langbench.metrics._window import per_kdoc_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "transform/encode")
    return per_kdoc_ms(rec, s) if rec["entry"] == "transform" and s > 0 else None
