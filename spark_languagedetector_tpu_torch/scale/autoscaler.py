"""Telemetry-driven autoscaler: the replica count follows the fleet's signals.

Port of ``spark_languagedetector_tpu.scale.autoscaler``, pure control logic:
on the same signal sequence it makes the JAX class's decisions. It reads
the admission queues' arrival-rate EMA, queue depth, shed counters and the
estimated-wait SLO live, and drives the replica count.

Decision rule, per tick, with hysteresis on both edges:

  * **pressure**: new sheds since the last tick, the fleet-wide estimated
    wait (queued rows / arrival EMA) at or past
    ``scale_pressure_wait_ms``, or a burning SLO. ``scale_up_ticks``
    *consecutive* pressure ticks raise the target by one (clamped to
    ``scale_max``): one burst spike never spawns a process.
  * **idle**: no pressure, an empty queue, nothing in flight, no new
    sheds, and the arrival EMA below ``scale_idle_rows_per_s``.
    ``scale_down_ticks`` consecutive idle ticks (the cooldown) lower the
    target by one (clamped to ``scale_min``): capacity is released more
    slowly than it is acquired.
  * **deferral**: while any member's breaker is open or half-open, or the
    fleet is below target (a supervised restart in progress), the tick
    makes **no** scale decision and the streaks freeze: mid-outage the
    breaker machinery owns the fleet's shape, and a dead replica must never
    read as idleness.
  * **min-floor repair**: a target below ``scale_min`` (a member past its
    restart budget was detached) is raised back to the floor.

The ``scale/decision`` fault site fires at the top of each tick: an
injected error skips that one tick (``scale/decision_skips``), never a
wrong scale action.
"""

from __future__ import annotations

import threading

from ..exec import config as exec_config
from ..resilience import faults
from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("scale.autoscaler")


class ScaleSignals:
    """One aggregated snapshot of the fleet's serving signals.

    ``ema_rows_per_s`` is the fleet arrival-rate EMA (decays to zero
    across silence — the idleness signal); ``est_wait_ms`` is the same
    estimate the admission queues shed on, fleet-wide (backlog over the
    summed dispatch-throughput EMAs); ``shed_delta`` is new sheds since
    the previous snapshot — appearance, not level, is the pressure
    signal (a counter's absolute value only says the fleet has history).
    ``shed_delta`` is differentiated from the fleet telemetry aggregate
    (the collector's monotone counters), and ``slo_burning`` carries the
    burn-rate verdict over the same aggregate — a burning objective is
    pressure even before sheds appear (a sustained p99 breach, say).
    """

    __slots__ = (
        "live", "ready", "queued_rows", "inflight_rows", "ema_rows_per_s",
        "est_wait_ms", "shed_delta", "breaker_open", "slo_burning",
    )

    def __init__(
        self,
        *,
        live: int = 0,
        ready: int = 0,
        queued_rows: int = 0,
        inflight_rows: int = 0,
        ema_rows_per_s: float = 0.0,
        est_wait_ms: float = 0.0,
        shed_delta: int = 0,
        breaker_open: bool = False,
        slo_burning: bool = False,
    ):
        self.live = live
        self.ready = ready
        self.queued_rows = queued_rows
        self.inflight_rows = inflight_rows
        self.ema_rows_per_s = ema_rows_per_s
        self.est_wait_ms = est_wait_ms
        self.shed_delta = shed_delta
        self.breaker_open = breaker_open
        self.slo_burning = slo_burning

    def describe(self) -> dict:
        return {s: getattr(self, s) for s in self.__slots__}


class Autoscaler:
    """Drives ``fleet`` (anything with ``signals()``, ``scale_to(n)``,
    ``check_members()``, and a ``target`` int property — in practice
    :class:`~.elastic.ElasticFleet`) between ``scale_min`` and
    ``scale_max``. ``tick()`` is the whole algorithm and is what the
    deterministic tests drive; :meth:`start` runs it on a background
    thread every ``scale_interval_ms``.
    """

    def __init__(
        self,
        fleet,
        *,
        scale_min: int | None = None,
        scale_max: int | None = None,
        interval_ms: float | None = None,
        up_ticks: int | None = None,
        down_ticks: int | None = None,
        pressure_wait_ms: float | None = None,
        idle_rows_per_s: float | None = None,
    ):
        self.fleet = fleet
        self.scale_min = int(exec_config.resolve("scale_min", scale_min))
        self.scale_max = int(exec_config.resolve("scale_max", scale_max))
        if self.scale_max < self.scale_min:
            raise ValueError(
                f"scale_max ({self.scale_max}) < scale_min "
                f"({self.scale_min})"
            )
        self.interval_s = float(exec_config.resolve(
            "scale_interval_ms", interval_ms
        )) / 1000.0
        self.up_ticks = int(exec_config.resolve("scale_up_ticks", up_ticks))
        self.down_ticks = int(exec_config.resolve(
            "scale_down_ticks", down_ticks
        ))
        self.pressure_wait_ms = float(exec_config.resolve(
            "scale_pressure_wait_ms", pressure_wait_ms
        ))
        self.idle_rows_per_s = float(exec_config.resolve(
            "scale_idle_rows_per_s", idle_rows_per_s
        ))
        self._pressure_streak = 0
        self._idle_streak = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- the loop --
    def tick(self) -> str:
        """One control-loop step; returns the decision taken (``"up"``,
        ``"down"``, ``"hold"``, ``"deferred"``, or ``"skipped"``)."""
        try:
            faults.inject("scale/decision")
        except faults.InjectedFault as e:
            # Fail static: a faulted decision path must never produce a
            # wrong scale action — this tick simply does not happen.
            REGISTRY.incr("scale/decision_skips")
            log_event(_log, "scale.tick_skipped", error=repr(e))
            return "skipped"
        self.fleet.check_members()
        sig = self.fleet.signals()
        target = int(self.fleet.target)
        REGISTRY.set_gauge("langdetect_fleet_target_replicas", float(target))
        REGISTRY.set_gauge("langdetect_fleet_live_replicas", float(sig.live))
        if sig.breaker_open or sig.live < target:
            # Mid-outage: ejection/half-open owns the fleet's shape.
            # Streaks freeze (they neither grow nor reset) so a recovered
            # fleet resumes exactly the trend it had.
            log_event(
                _log, "scale.tick_deferred", live=sig.live, target=target,
                breaker_open=sig.breaker_open,
            )
            return "deferred"
        if target < self.scale_min:
            # Min-floor repair: a member that exhausted its restart
            # budget was detached and dropped the target — replace it
            # with a fresh spawn rather than serving under the floor.
            self.fleet.scale_to(self.scale_min)
            REGISTRY.set_gauge(
                "langdetect_fleet_target_replicas", float(self.scale_min)
            )
            return "up"
        pressure = (
            sig.shed_delta > 0
            or sig.est_wait_ms >= self.pressure_wait_ms
            or sig.slo_burning
        )
        # Idleness explicitly excludes pressure: a tick that shows SLO
        # pressure can never ALSO count toward the scale-down cooldown,
        # even at the ceiling where the pressure has nowhere to go.
        idle = (
            not pressure
            and sig.queued_rows == 0
            and sig.inflight_rows == 0
            and sig.shed_delta == 0
            and sig.ema_rows_per_s < self.idle_rows_per_s
        )
        self._pressure_streak = self._pressure_streak + 1 if pressure else 0
        self._idle_streak = self._idle_streak + 1 if idle else 0
        decision = "hold"
        if pressure and (
            self._pressure_streak >= self.up_ticks
            and target < self.scale_max
        ):
            target += 1
            decision = "up"
            self._pressure_streak = 0
            self._idle_streak = 0
        elif idle and (
            self._idle_streak >= self.down_ticks and target > self.scale_min
        ):
            target -= 1
            decision = "down"
            self._idle_streak = 0
            self._pressure_streak = 0
        if decision != "hold":
            log_event(
                _log, "scale.decision", decision=decision, target=target,
                **sig.describe(),
            )
            self.fleet.scale_to(target)
            REGISTRY.set_gauge(
                "langdetect_fleet_target_replicas", float(target)
            )
        return decision

    # ------------------------------------------------------------ lifecycle --
    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="scale-autoscaler", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # the loop must survive anything
                log_event(_log, "scale.tick_error", error=repr(e))

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
