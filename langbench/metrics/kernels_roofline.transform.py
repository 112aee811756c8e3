"""``kernels_roofline.transform``: the least time of the window's compulsory
work (:mod:`langbench.count`) over the summed time of every kernel the
device ran in the traced window, in %."""

from langbench.metrics._window import roofline_pct


def read(rec: dict) -> float | None:
    return roofline_pct(rec, "transform", (rec.get("device") or {}).get("kernel_s", 0.0))
