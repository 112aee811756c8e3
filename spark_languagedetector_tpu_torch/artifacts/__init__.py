"""The cold-start plane: the kernel build cache and mmap-baked artifacts.

Port of ``spark_languagedetector_tpu.artifacts``. :mod:`.compile_cache`
shares the CUDA kernels' build directory across processes and prewarms the
bounded shape lattice; :mod:`.bake` lays the trained tables out as raw
little-endian blocks that a replica maps with ``np.memmap`` instead of
parsing parquet, in the JAX package's ``ldbake`` format.
"""

from .bake import (
    ArtifactError,
    artifact_path_for,
    bake_artifact,
    bake_model,
    load_artifact,
    load_baked_model,
    maybe_load_baked,
    recover_artifact,
)
from .compile_cache import enable_compile_cache, prewarm_lattice

__all__ = [
    "ArtifactError",
    "artifact_path_for",
    "bake_artifact",
    "bake_model",
    "enable_compile_cache",
    "load_artifact",
    "load_baked_model",
    "maybe_load_baked",
    "prewarm_lattice",
    "recover_artifact",
]
