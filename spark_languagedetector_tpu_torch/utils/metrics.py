"""Lightweight counters/timers for observability.

Port of ``spark_languagedetector_tpu.utils.metrics``. The counters are
process-local; writes take a lock so producers on other threads (the
runner's dispatch workers) can update them concurrently with the caller's
thread — the cost is per batch, not per row. The timers read the host clock
only; a device time needs the card synchronized at the call sites that care.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Metrics:
    counters: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    timers: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    # Invocations per timer, so mean latency is derivable (total alone can't
    # distinguish "one slow call" from "many fast ones").
    timer_counts: dict[str, int] = field(
        default_factory=lambda: defaultdict(int)
    )
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    # Locks can't be pickled/deepcopied — models deepcopy themselves (and the
    # runner's Metrics with them) in Params.copy. Copies get a fresh lock;
    # counter values transfer as plain dicts.
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def incr(self, name: str, value: int = 1) -> None:
        with self._lock:
            self.counters[name] += value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timers[name] += dt
                self.timer_counts[name] += 1

    def throughput(self, counter: str, timer: str) -> float:
        """counter/sec over accumulated timer time; 0.0 if never timed."""
        elapsed = self.timers.get(timer, 0.0)
        return self.counters.get(counter, 0) / elapsed if elapsed > 0 else 0.0

    def mean_seconds(self, timer: str) -> float:
        """Mean duration of one timed region; 0.0 if never timed."""
        n = self.timer_counts.get(timer, 0)
        return self.timers.get(timer, 0.0) / n if n else 0.0

    def snapshot(self) -> dict:
        # Shape-compatible superset: "counters"/"timers" keep their original
        # {name: number} form; "timer_counts" rides alongside.
        return {
            "counters": dict(self.counters),
            "timers": dict(self.timers),
            "timer_counts": dict(self.timer_counts),
        }

    def reset(self) -> None:
        self.counters.clear()
        self.timers.clear()
        self.timer_counts.clear()


# Framework-global registry (scorers attach their own Metrics too).
GLOBAL = Metrics()
