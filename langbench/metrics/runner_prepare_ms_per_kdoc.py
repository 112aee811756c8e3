"""``runner_prepare_ms_per_kdoc``: the program's ``runner/prepare`` spans (the
runner's truncation, dedup, chunking, plan and chunk ranks, before its
``score`` span) per 1,000 documents."""

from langbench.metrics._window import per_kdoc_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "runner/prepare")
    return per_kdoc_ms(rec, s) if rec["entry"] == "transform" and s > 0 else None
