"""Device gauges and the kernel build cache's counters.

Port of ``spark_languagedetector_tpu.telemetry.gauges``, with CUDA's
allocator in place of JAX's buffer list:

  * ``live_buffer_bytes{device="cuda:N"}``: bytes of tensors alive on the
    device, ``torch.cuda.memory_allocated(N)``;
  * ``device_bytes_in_use{device="cuda:N"}``: the caching allocator's
    current allocated bytes, ``torch.cuda.memory_stats(N)
    ["allocated_bytes.all.current"]``. (The same bytes: torch's
    allocator is the only one the port uses; the reserved pool is
    ``torch.cuda.memory_reserved`` and is not a gauge.)

Device labels take the JAX form ``<platform>:<id>``. Without a CUDA
device nothing is sampled: :func:`sample_device_gauges` returns ``{}`` and
sets no gauge.

The counterpart of the JAX package's ``install_jax_hooks`` lives in the
kernel builder (``ops/_kernels.py``), which counts into the registry
directly: ``compile_cache/hits`` when a kernel's library already matches
its source hash, ``compile_cache/misses`` when ``nvcc`` runs, and each
build's seconds in the ``compile_cache/build_s`` histogram.

``note_donation_reuse`` has no counterpart and no ``jax/*`` name is
emitted: the device fit's count table is updated in place by
``index_put_(accumulate=True)``, so there is no donated buffer whose reuse
could silently degrade to a copy.
"""

from __future__ import annotations

from .registry import REGISTRY, Registry

__all__ = ["sample_device_gauges"]


def sample_device_gauges(registry: Registry | None = None) -> dict:
    """Sample every visible CUDA device's memory gauges into the registry;
    returns them too, ``{gauge: {device label: bytes}}``."""
    import torch

    reg = registry if registry is not None else REGISTRY
    out: dict[str, dict[str, float]] = {}
    if not torch.cuda.is_available():
        return out
    live: dict[str, float] = {}
    in_use: dict[str, float] = {}
    for i in range(torch.cuda.device_count()):
        label = f"cuda:{i}"
        live[label] = float(torch.cuda.memory_allocated(i))
        stats = torch.cuda.memory_stats(i)
        if "allocated_bytes.all.current" in stats:
            in_use[label] = float(stats["allocated_bytes.all.current"])
    for name, series in (("live_buffer_bytes", live), ("device_bytes_in_use", in_use)):
        for dev, nbytes in series.items():
            reg.set_gauge(name, nbytes, device=dev)
        if series:
            out[name] = series
    return out
