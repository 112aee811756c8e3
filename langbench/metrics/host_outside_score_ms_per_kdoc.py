"""``host_outside_score_ms_per_kdoc``: per 1,000 documents, the time of the
window's calls outside the program's ``score`` span: the estimator's text
to UTF-8 bytes, the runner's truncation, dedup and plan, the result table."""

from langbench.metrics._window import ok_calls, per_kdoc_ms


def read(rec: dict) -> float | None:
    if rec["entry"] != "transform" or not rec["spans"]:
        return None
    calls = sum(c["t1"] - c["t0"] for c in ok_calls(rec))
    score = sum(s["wall_s"] for s in rec["spans"] if s["path"] == "score")
    return per_kdoc_ms(rec, calls - score)
