"""Shared arithmetic of the metric readers: sums of the program's spans by
path suffix, per 1,000 documents or per call of the window."""


def ok_calls(rec: dict) -> list[dict]:
    return [c for c in rec["calls"] if c["ok"]]


def span_s(rec: dict, suffix: str) -> float:
    """Summed wall seconds of the spans whose path is ``suffix`` or ends
    with ``/suffix``."""
    return sum(s["wall_s"] for s in rec["spans"]
               if s["path"] == suffix or s["path"].endswith("/" + suffix))


def per_kdoc_ms(rec: dict, seconds: float) -> float | None:
    docs = sum(c["docs"] for c in ok_calls(rec))
    return seconds * 1e3 / (docs / 1e3) if docs else None


def per_call_ms(rec: dict, seconds: float) -> float | None:
    n = len(ok_calls(rec))
    return seconds * 1e3 / n if n else None


def roofline_pct(rec: dict, entry: str, denominator_s: float) -> float | None:
    """The window's least time (:mod:`langbench.count`) as a share of
    ``denominator_s``, in %; None without a count or a device time."""
    if rec["entry"] != entry or not rec.get("work") or not rec.get("peaks") or denominator_s <= 0:
        return None
    from langbench.count import least_seconds

    return 100.0 * least_seconds(rec["work"], rec["peaks"]) / denominator_s
