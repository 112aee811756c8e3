"""``score_pack_ms_per_kdoc``: the program's ``score/pack`` spans (the native
packer into pinned staging) per 1,000 documents."""

from langbench.metrics._window import per_kdoc_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "score/pack")
    return per_kdoc_ms(rec, s) if rec["entry"] == "transform" and s > 0 else None
