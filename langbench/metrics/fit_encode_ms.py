"""``fit_encode_ms``: per fit, the program's ``fit/encode`` span (the label
checks, the texts to UTF-8 bytes, the language ids)."""

from langbench.metrics._window import per_call_ms, span_s


def read(rec: dict) -> float | None:
    s = span_s(rec, "fit/encode")
    return per_call_ms(rec, s) if rec["entry"] == "fit" and s > 0 else None
