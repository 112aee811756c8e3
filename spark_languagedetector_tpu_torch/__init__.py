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

Multi-process runs call ``init_distributed(...)`` once per process (the
``LANGDETECT_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID`` knobs
or arguments; see :func:`.parallel.distributed.initialize`); after it,
``device="mesh"`` transforms and ``fitBackend="device"`` fits span every
rank of the group. It is a no-op in a single process.
"""

from .api.pipeline import Pipeline, PipelineModel
from .api.table import Schema, Table
from .models.estimator import LanguageDetector, LanguageDetectorModel
from .models.language import ISO_LANGUAGE_CODES, Language
from .models.preprocessing import LowerCasePreprocessor, SpecialCharPreprocessor

__version__ = "0.1.0"


def __getattr__(name):
    # Loaded on first use, as the JAX package exports it.
    if name == "init_distributed":
        from .parallel.distributed import initialize

        return initialize
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    "init_distributed",
]
