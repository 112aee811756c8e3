"""``transform_result_ms_per_kdoc``: the program's ``runner/finish`` spans
(after ``score``: the chunked documents' argmax, the dedup scatter-back) and
``transform/result`` spans (the ids to language names, the result
``Table``) per 1,000 documents."""

from langbench.metrics._window import per_kdoc_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "runner/finish") + span_s(rec, "transform/result")
    return per_kdoc_ms(rec, s) if rec["entry"] == "transform" and s > 0 else None
