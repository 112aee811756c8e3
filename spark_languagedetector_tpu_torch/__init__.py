"""Byte-n-gram language identification on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of ``spark_languagedetector_tpu``: the same Spark-ML-style
Estimator/Model API, the same profile format and scoring semantics, with the
scoring kernel written by hand in CUDA C++ for the H100 (``csrc/``). It
imports torch and numpy only.

Public API::

    from spark_languagedetector_tpu_torch import (
        LanguageDetector, LanguageDetectorModel, Table,
    )

Entry points run on the CUDA card unless given ``device="cpu"``, where the
kernels' plain PyTorch versions run; with no device and no card they raise.
"""

from .api.table import Schema, Table
from .models.estimator import LanguageDetector, LanguageDetectorModel

__version__ = "0.1.0"

__all__ = ["LanguageDetector", "LanguageDetectorModel", "Schema", "Table"]
