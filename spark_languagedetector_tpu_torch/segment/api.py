"""The segmentation orchestrator: runner cells → structured results.

:func:`segment_documents` is the one decode path of segment mode, so every
caller gets identical answers for identical documents and options.

Result shape (one dict per document, JSON-ready, key for key the JAX
package's):

.. code-block:: python

    {
      "label": "en" | "unknown",          # top-1, or the reject label
      "rejected": False,
      "calibrated": True,                 # explicit provenance — an
                                          # uncalibrated model says so
      "topk": [{"lang": "en", "prob": 0.93}, ...],
      "spans": [{"start": 0, "end": 57, "lang": "en",
                 "confidence": 0.91}, ...],
    }

Telemetry, under the JAX package's names: the host decode runs in a
``segment/merge`` span; ``segment/docs``, ``segment/rejects`` and
``segment/spans`` count every call (zeros included, so a zero-reject
capture still carries the ``segment/reject_rate`` denominator), and the
``segment/spans_per_doc`` and ``segment/span_len_bytes`` histograms
observe each document and span.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..telemetry import REGISTRY, span
from .calibrate import Calibration, calibrated_probs, normalize_scores
from .spans import decode_cells, merge_spans, smooth_cells
from .topk import UNKNOWN, topk_decode


@dataclass(frozen=True)
class SegmentOptions:
    """Every knob of one segmentation decode, hashable and stringable:
    :meth:`key` is canonical, so two decodes with different knobs can be
    told apart wherever results are kept."""

    cell: int = 256              # device cell width (bytes; multiple of 128)
    smooth: int = 3              # box-smoothing width in cells
    top_k: int = 3               # languages returned per document
    reject_threshold: float = 0.0  # calibrated-prob floor; 0 ⇒ never reject
    min_span_bytes: int = 16     # spans shorter than this heal into neighbors

    def __post_init__(self):
        if self.cell < 128 or self.cell % 128:
            raise ValueError(
                f"cell must be a positive multiple of 128, got {self.cell}"
            )
        if self.smooth < 1:
            raise ValueError(f"smooth must be >= 1, got {self.smooth}")
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if not 0.0 <= self.reject_threshold < 1.0:
            raise ValueError(
                "reject_threshold must be in [0, 1), got "
                f"{self.reject_threshold}"
            )
        if self.min_span_bytes < 1:
            raise ValueError(
                f"min_span_bytes must be >= 1, got {self.min_span_bytes}"
            )

    def key(self) -> str:
        """Canonical string of every knob."""
        return (
            f"cell={self.cell},smooth={self.smooth},k={self.top_k},"
            f"reject={self.reject_threshold!r},min={self.min_span_bytes}"
        )


def segment_documents(
    runner,
    byte_docs,
    languages,
    *,
    options: SegmentOptions | None = None,
    calibration: Calibration | None = None,
) -> list[dict]:
    """Segment ``byte_docs``: per-cell device scores → span merge →
    calibrated top-k with reject. One result dict per input document (the
    module docstring shows the shape); input order preserved.

    ``calibration`` None ⇒ the identity calibration (T = 1.0 everywhere)
    with ``calibrated: false`` stamped on every result — uncalibrated
    segmentation is explicit, never silent.
    """
    opts = options or SegmentOptions()
    languages = [str(l) for l in languages]
    if len(languages) != int(runner.num_langs):
        raise ValueError(
            f"{len(languages)} language names for a "
            f"{int(runner.num_langs)}-language runner"
        )
    calib = calibration or Calibration.identity(len(languages))
    if calib.temperatures.shape[0] != len(languages):
        raise ValueError(
            f"calibration covers {calib.temperatures.shape[0]} languages, "
            f"model has {len(languages)}"
        )
    calibrated = calib.calibrated

    cells_list, scored_docs = runner.segment_cells(byte_docs, cell=opts.cell)

    results: list[dict] = []
    n_rejects = 0
    n_spans_total = 0
    with span("segment/merge", docs=len(cells_list), cell=opts.cell):
        for cells, doc in zip(cells_list, scored_docs):
            doc_len = len(doc)
            smoothed = smooth_cells(cells, opts.smooth)
            winners, margins = decode_cells(smoothed)
            spans = merge_spans(
                winners, margins,
                cell=opts.cell, doc_len=doc_len, doc=doc,
                min_span_bytes=opts.min_span_bytes,
            )
            # Document-level calibrated distribution from the exact cell
            # sums (length-normalized — the calibration's logit form).
            doc_vec = normalize_scores(
                cells.sum(axis=0, dtype=np.float64)[None, :], [doc_len]
            )
            doc_probs = calibrated_probs(doc_vec, calib.temperatures)[0]
            topk, label, rejected = topk_decode(
                doc_probs, languages, opts.top_k, opts.reject_threshold
            )

            out_spans = []
            for s in spans:
                span_vec = normalize_scores(
                    cells[s.start // opts.cell: -(-s.end // opts.cell)].sum(
                        axis=0, dtype=np.float64
                    )[None, :],
                    [s.end - s.start],
                )
                conf = float(calibrated_probs(span_vec, calib.temperatures)[0][s.lang_id])
                out_spans.append({
                    "start": int(s.start),
                    "end": int(s.end),
                    # The span-level reject: a span whose own calibrated
                    # confidence sits below the threshold reports unknown
                    # rather than a coin-flip language.
                    "lang": (
                        UNKNOWN if conf < opts.reject_threshold
                        else languages[s.lang_id]
                    ),
                    "confidence": round(conf, 6),
                })
                REGISTRY.observe("segment/span_len_bytes", float(s.end - s.start))
            results.append({
                "label": label,
                "rejected": rejected,
                "calibrated": calibrated,
                "topk": [
                    {"lang": e["lang"], "prob": round(e["prob"], 6)}
                    for e in topk
                ],
                "spans": out_spans,
            })
            n_rejects += int(rejected)
            n_spans_total += len(out_spans)
            REGISTRY.observe("segment/spans_per_doc", float(len(out_spans)))
    REGISTRY.incr("segment/docs", len(results))
    REGISTRY.incr("segment/rejects", n_rejects)
    REGISTRY.incr("segment/spans", n_spans_total)
    return results
