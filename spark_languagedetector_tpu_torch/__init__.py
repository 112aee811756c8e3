"""Byte-n-gram language identification on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of ``spark_languagedetector_tpu``: the same Spark-ML-style
Estimator/Model API, the same profile format and scoring semantics, with the
scoring kernel written by hand in CUDA C++ for the H100 (``csrc/``). It
imports torch and numpy only.

Public API::

    from spark_languagedetector_tpu_torch import (
        LanguageDetector, LanguageDetectorModel, Pipeline, PipelineModel,
        LowerCasePreprocessor, SpecialCharPreprocessor, Language, Table,
    )

Models and pipelines save and load in the JAX package's directory layout,
so either package loads what the other saved.

Entry points run on the CUDA card unless given ``device="cpu"``, where the
kernels' plain PyTorch versions run; with no device and no card they raise.
"""

from .api.pipeline import Pipeline, PipelineModel
from .api.table import Schema, Table
from .models.estimator import LanguageDetector, LanguageDetectorModel
from .models.language import ISO_LANGUAGE_CODES, Language
from .models.preprocessing import LowerCasePreprocessor, SpecialCharPreprocessor

__version__ = "0.1.0"

__all__ = [
    "ISO_LANGUAGE_CODES",
    "Language",
    "LanguageDetector",
    "LanguageDetectorModel",
    "LowerCasePreprocessor",
    "Pipeline",
    "PipelineModel",
    "Schema",
    "SpecialCharPreprocessor",
    "Table",
]
