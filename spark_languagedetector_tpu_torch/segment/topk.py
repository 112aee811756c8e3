"""Top-k languages with calibrated probabilities + the reject option.

The whole-doc argmax answers "which one language" — structurally wrong
for mixed documents and overconfident for out-of-distribution input. The
segmentation result type answers with the top-k calibrated candidates
and an explicit ``unknown`` when even the best candidate's calibrated
probability sits below the reject threshold: a low-confidence answer is
information the caller must see, never a silently wrong label.
"""

from __future__ import annotations

import numpy as np

# The reject label. Deliberately NOT a language code (ISO 639-1 has no
# "unknown"), so it can never collide with a model's language list.
UNKNOWN = "unknown"


def topk_decode(
    probs: np.ndarray,
    languages,
    k: int,
    reject_threshold: float,
) -> tuple[list[dict], str, bool]:
    """(top-k entries, label, rejected) for one calibrated distribution.

    ``probs`` float [L] (a :func:`..calibrate.calibrated_probs` row);
    entries are ``{"lang", "prob"}`` sorted by descending probability
    (ties broken by ascending index — the reference's first-maximum
    rule). ``label`` is the top language, or :data:`UNKNOWN` when its
    probability is below ``reject_threshold`` (``rejected`` True). The
    top-k list is returned even for rejected documents — the caller sees
    WHAT the low-confidence guesses were.
    """
    p = np.asarray(probs, dtype=np.float64)
    if p.ndim != 1 or len(p) != len(languages):
        raise ValueError(
            f"probs shape {p.shape} disagrees with {len(languages)} languages"
        )
    k = max(1, min(int(k), len(p)))
    # Stable sort on -p: equal probabilities keep ascending language
    # index, matching the first-maximum tie rule everywhere else.
    order = np.argsort(-p, kind="stable")[:k]
    entries = [
        {"lang": str(languages[int(i)]), "prob": float(p[int(i)])}
        for i in order
    ]
    top_prob = entries[0]["prob"]
    rejected = bool(top_prob < float(reject_threshold))
    label = UNKNOWN if rejected else entries[0]["lang"]
    return entries, label, rejected
