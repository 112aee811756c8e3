"""Published peaks of the cards the benchmark knows, for roofline shares.

NVIDIA's H100 SXM data sheet (dense rates, no sparsity; at the full 700 W
power limit): float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s.
A card not in this table gets no roofline share (the metric is left out).
"""

from __future__ import annotations

PEAKS = {
    "H100": {"f32_ops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_of(device_name: str) -> dict | None:
    """The peaks of the card named ``device_name``, or None."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None
