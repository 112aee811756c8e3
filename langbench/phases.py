"""Timing of a set-up's phases, which the harness prints on standard error
before the window (they are not metrics: ``setup_s`` is the whole)."""

from __future__ import annotations

import time


class Phases:
    """Seconds of each phase of a set-up, each ended by :meth:`done` once
    the device has finished its work."""

    def __init__(self, device: str):
        self.cuda = device.startswith("cuda")
        self.phases: list[tuple[str, float]] = []
        self._t = time.perf_counter()

    def done(self, name: str) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        now = time.perf_counter()
        self.phases.append((name, now - self._t))
        self._t = now
