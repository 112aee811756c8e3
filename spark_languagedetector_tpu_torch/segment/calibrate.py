"""Per-language temperature calibration for segmentation confidences.

Raw detector scores are sums of log-weight contributions — great for
argmax, meaningless as probabilities: a softmax over raw sums is almost a
one-hot for long documents and near-uniform for short ones. Segmentation's
reject option (:mod:`.topk`) needs an actual probability, so:

* scores are **length-normalized** first (divided by the scored byte
  count — :func:`normalize_scores`), making the logit scale
  length-invariant;
* a **per-language temperature** ``T_l`` divides each language's logit
  before the softmax: ``p = softmax(s_l / T_l)``. One global temperature
  is classic Platt/temperature scaling; the per-language refinement
  absorbs per-language weight-magnitude differences (profile sizes and
  gram coverage differ per language, so one scalar under-corrects).

The fit is **deterministic** (fixed grids, no RNG): a global-temperature
grid search minimizing held-out NLL, then a bounded number of
coordinate-descent passes refining each language's factor. Quality is
reported as expected calibration error (:func:`expected_calibration_error`)
before/after, in the fitted state's ``meta``.

The fitted state is tiny (one float per language), crosses between models
as a plain dict (:meth:`Calibration.to_dict` / :meth:`Calibration.from_dict`)
and is provenance stamped: an uncalibrated model segments with ``T = 1.0``
and an explicit ``calibrated: false`` flag on every result, never silently.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Deterministic fit grids (log-spaced): global pass, then per-language
# multiplicative refinement around the current value.
_GLOBAL_GRID = np.geomspace(0.02, 50.0, 81)
_REFINE_FACTORS = np.geomspace(0.5, 2.0, 15)
_REFINE_PASSES = 2


@dataclass
class Calibration:
    """Fitted per-language temperatures plus held-out provenance.

    ``temperatures`` float64 [L] (> 0); ``meta`` records the held-out doc
    count and the before/after NLL + ECE of the fit. ``version`` is a
    content hash of the temperatures, so results computed under different
    temperatures can be told apart.
    """

    temperatures: np.ndarray
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        t = np.asarray(self.temperatures, dtype=np.float64)
        if t.ndim != 1 or t.size == 0 or not np.all(np.isfinite(t)) or np.any(
            t <= 0
        ):
            raise ValueError(
                "calibration temperatures must be a 1-D positive finite "
                f"array, got shape {t.shape}"
            )
        self.temperatures = t

    @property
    def version(self) -> str:
        import hashlib

        return hashlib.sha256(
            np.ascontiguousarray(self.temperatures).tobytes()
        ).hexdigest()[:12]

    @staticmethod
    def identity(n_langs: int) -> "Calibration":
        """The uncalibrated default: every temperature 1.0 (the softmax of
        the raw normalized scores), ``calibrated: false`` provenance."""
        return Calibration(
            temperatures=np.ones(n_langs, dtype=np.float64),
            meta={"calibrated": False},
        )

    @property
    def calibrated(self) -> bool:
        return bool(self.meta.get("calibrated", True))

    # ------------------------------------------------- persistence codec ----
    def to_dict(self) -> dict:
        """JSON-ready state: temperatures + held-out provenance + the
        content version. JSON ``repr`` round-trips doubles exactly, so
        :meth:`from_dict` reconstructs bit-identical temperatures and
        therefore the identical ``version``."""
        return {
            "temperatures": [float(t) for t in self.temperatures],
            "meta": dict(self.meta),
            "version": self.version,
        }

    @staticmethod
    def from_dict(state: dict) -> "Calibration":
        calib = Calibration(
            temperatures=np.asarray(state["temperatures"], dtype=np.float64),
            meta=dict(state.get("meta", {})),
        )
        stored = state.get("version")
        if stored is not None and stored != calib.version:
            # The version is content-derived; a mismatch means the stored
            # temperatures were edited behind the codec's back.
            raise ValueError(
                f"calibration version {stored!r} does not match its "
                f"temperatures (recomputed {calib.version!r})"
            )
        return calib


def normalize_scores(scores: np.ndarray, byte_lens) -> np.ndarray:
    """Length-normalize raw score rows: float64 ``scores[i] / max(1, len_i)``
    — the logit form every calibration consumer uses (fit and decode must
    agree on this transform or the temperatures mean nothing)."""
    scores = np.asarray(scores, dtype=np.float64)
    denom = np.maximum(np.asarray(byte_lens, dtype=np.float64), 1.0)
    return scores / denom[:, None]


def calibrated_probs(
    norm_scores: np.ndarray, temperatures: np.ndarray
) -> np.ndarray:
    """softmax(norm_scores / T) row-wise, float64, numerically stable."""
    z = np.asarray(norm_scores, dtype=np.float64) / np.asarray(
        temperatures, dtype=np.float64
    )
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def nll(probs: np.ndarray, labels: np.ndarray) -> float:
    """Mean negative log-likelihood of the true labels (floored so a
    confidently-wrong sample can't produce inf and poison the grid)."""
    p = probs[np.arange(len(labels)), labels]
    return float(-np.mean(np.log(np.maximum(p, 1e-12))))


def expected_calibration_error(
    probs: np.ndarray, labels: np.ndarray, bins: int = 10
) -> float:
    """Standard ECE: bin predictions by top-probability, average
    |accuracy − confidence| weighted by bin mass."""
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    correct = (pred == np.asarray(labels)).astype(np.float64)
    edges = np.linspace(0.0, 1.0, bins + 1)
    ece = 0.0
    n = len(labels)
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (conf > lo) & (conf <= hi) if lo > 0 else (conf <= hi)
        if not sel.any():
            continue
        ece += (sel.sum() / n) * abs(
            correct[sel].mean() - conf[sel].mean()
        )
    return float(ece)


def fit_calibration(
    norm_scores: np.ndarray, label_idx, n_langs: int
) -> Calibration:
    """Fit per-language temperatures on held-out (scores, labels).

    ``norm_scores`` float [N, L] length-normalized (``normalize_scores``);
    ``label_idx`` int [N] true language indices. Deterministic: global
    grid search on NLL, then ``_REFINE_PASSES`` coordinate passes over
    the languages (ascending index) trying multiplicative factors and
    keeping strict improvements. Raises on an empty held-out set — a
    calibration fitted on nothing would be a silent lie.
    """
    s = np.asarray(norm_scores, dtype=np.float64)
    y = np.asarray(label_idx, dtype=np.int64)
    if s.ndim != 2 or s.shape[1] != n_langs:
        raise ValueError(
            f"held-out scores must be [N, {n_langs}], got {s.shape}"
        )
    if len(y) != len(s) or len(y) == 0:
        raise ValueError("calibration needs a non-empty held-out set")
    if y.min() < 0 or y.max() >= n_langs:
        raise ValueError("held-out label index out of range")

    ones = np.ones(n_langs, dtype=np.float64)
    nll_before = nll(calibrated_probs(s, ones), y)
    ece_before = expected_calibration_error(calibrated_probs(s, ones), y)

    # Global temperature first.
    best_t, best_nll = 1.0, nll_before
    for t in _GLOBAL_GRID:
        cur = nll(calibrated_probs(s, np.full(n_langs, t)), y)
        if cur < best_nll:
            best_t, best_nll = float(t), cur
    temps = np.full(n_langs, best_t, dtype=np.float64)

    # Per-language coordinate refinement (strict improvements only, so
    # the result is independent of float noise in equal-valued cells).
    for _ in range(_REFINE_PASSES):
        improved = False
        for lang in range(n_langs):
            base = temps[lang]
            for f in _REFINE_FACTORS:
                trial = temps.copy()
                trial[lang] = base * float(f)
                cur = nll(calibrated_probs(s, trial), y)
                if cur < best_nll - 1e-12:
                    temps, best_nll = trial, cur
                    improved = True
        if not improved:
            break

    probs_after = calibrated_probs(s, temps)
    return Calibration(
        temperatures=temps,
        meta={
            "calibrated": True,
            "heldout_docs": int(len(y)),
            "nll_before": round(nll_before, 6),
            "nll_after": round(nll(probs_after, y), 6),
            "ece_before": round(ece_before, 6),
            "ece_after": round(
                expected_calibration_error(probs_after, y), 6
            ),
        },
    )
