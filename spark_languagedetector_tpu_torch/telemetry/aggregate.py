"""Process identity for telemetry scrapes and HTTP responses.

Port of the identity half of ``spark_languagedetector_tpu.telemetry.
aggregate``: :func:`process_identity` is the block a serving front end
stamps onto every response and onto its ``/telemetryz`` scrape, and
:func:`install_process_identity` names this process (replica, pid,
platform) once, so multi-process captures are attributable. The platform
is the serving device's type, ``"gpu"`` for a CUDA device and ``"cpu"``
otherwise.
"""

from __future__ import annotations

import os

import torch

from .registry import REGISTRY, Registry


def process_identity(registry: Registry | None = None) -> dict:
    """This process's identity block (replica/pid/platform when installed
    with :func:`install_process_identity`; a bare pid otherwise)."""
    reg = REGISTRY if registry is None else registry
    if reg.identity:
        return dict(reg.identity)
    return {"pid": os.getpid()}


def install_process_identity(
    registry: Registry | None = None,
    *,
    replica: str,
    device,
) -> dict:
    """Stamp (replica, pid, platform) into ``registry.identity``; the
    platform is ``"gpu"`` for a CUDA serving ``device``, else the device's
    type (``"cpu"``)."""
    reg = REGISTRY if registry is None else registry
    kind = torch.device(device).type
    reg.identity.update(
        replica=str(replica),
        pid=os.getpid(),
        platform="gpu" if kind == "cuda" else kind,
    )
    return dict(reg.identity)
