"""Where the port's entry points run.

Every entry point takes a ``device``. Left as None it means the CUDA card;
on a machine without one that is an error, never a quiet fall back to the
CPU — the plain PyTorch versions run only when the caller asks for
``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device (raises when none is visible);
    anything else → ``torch.device(device)``, checked to exist."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible"
            + (" and no device was given" if device is None else "")
            + "; pass device='cpu' to run the plain PyTorch versions on the host"
        )
    return dev
