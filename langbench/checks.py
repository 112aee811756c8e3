"""The comparisons that decide ``correct``: the program's outputs against
the plain reference, each as one number held against its limit.

- ``profile_grams_differing``: grams in one profile and not in the other.
- ``profile_weight_gap``: the largest absolute difference between the two
  profiles' float64 weights over the grams both hold.
- ``label_gap``: over every document that a timed call labelled, the
  largest amount by which the reference's score of the label the program
  gave lies below the reference's best score, as a share of that best
  score (at least 1). A label the reference would give, or one within
  rounding of it on a near tie, reads about 0; a label that is no language
  of the profile reads 1.
- ``calls_failed`` / ``fits_failed``: timed calls that raised or returned
  the wrong number of rows; ``fits_differing``: window fits whose profile
  differs, bit for bit, from the first one's.

The limits live in ``langbench/limits/<workload>.json``, one number each.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def profile_gaps(got, ref) -> dict:
    """``profile_grams_differing`` and ``profile_weight_gap`` of the profile
    ``got`` = ``(ids, weights)`` against ``ref``."""
    g_ids, g_w = got
    r_ids, r_w = ref
    common, gi, ri = np.intersect1d(g_ids, r_ids, assume_unique=True, return_indices=True)
    differing = int(g_ids.size + r_ids.size - 2 * common.size)
    gap = float(np.abs(g_w[gi] - r_w[ri]).max()) if common.size else 0.0
    if g_w.shape[1:] != r_w.shape[1:]:
        differing, gap = max(differing, 1), 1.0
    return {"profile_grams_differing": differing, "profile_weight_gap": gap}


def same_profile(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def label_gaps(ref_scores: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per document, the share by which the reference's score of ``labels``
    (language indices; -1 for a label that is no language) lies below its
    best score."""
    best = ref_scores.max(axis=1)
    ok = labels >= 0
    got = np.where(ok, ref_scores[np.arange(len(labels)), np.maximum(labels, 0)], -np.inf)
    gap = (best - got) / np.maximum(np.abs(best), 1.0)
    return np.where(ok, np.clip(gap, 0.0, 1.0), 1.0)


def limits_of(workload: str) -> dict:
    return json.loads((LIMITS_DIR / f"{workload}.json").read_text())


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every reading at or under
    its limit. A reading without a limit is an error of the benchmark."""
    missing = sorted(set(readings) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    table = {k: {"value": float(v), "limit": float(limits[k])} for k, v in readings.items()}
    return all(np.isfinite(t["value"]) and t["value"] <= t["limit"] for t in table.values()), table
