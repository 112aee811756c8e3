"""Span-level code-switch segmentation: everything after the fetch.

Port of ``spark_languagedetector_tpu.segment``. The device side
(:mod:`..ops.score`, :mod:`..ops.score_fused`,
:meth:`..api.runner.BatchRunner.segment_cells`) produces raw per-cell score
tensors; this package, numpy only, turns them into results:

* :mod:`.spans`     — smoothing, per-cell decoding, and the byte-offset
  span merge (min-span, gap healing, UTF-8 boundary snapping);
* :mod:`.calibrate` — per-language temperature scaling fit on held-out
  data;
* :mod:`.topk`      — top-k languages with calibrated probabilities and
  the unknown/low-confidence reject;
* :mod:`.api`       — :func:`segment_documents`, the orchestrator the
  model's segment mode dispatches to.
"""

from .api import SegmentOptions, segment_documents  # noqa: F401
from .calibrate import Calibration, fit_calibration  # noqa: F401
from .topk import UNKNOWN, topk_decode  # noqa: F401
