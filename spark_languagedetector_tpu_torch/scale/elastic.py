"""ElasticFleet: process replicas behind the dynamic-membership router.

Port of ``spark_languagedetector_tpu.scale.elastic``. A
:class:`~.replica.ReplicaSupervisor` owns process lifecycle, a
:class:`~..serve.router.FleetRouter` owns routing, health and failover,
and this class owns the mapping between them:

  * **scale-up**: spawn a replica to readiness (bounded backoff), then
    :meth:`~..serve.router.FleetRouter.add_replica` admits it with a fresh
    breaker and probes it once.
  * **scale-down**: drain, then detach: the router stops routing to the
    victim and waits out its outstanding requests, detaches it, and only
    then is the child asked to exit (its own drain answers whatever its
    batcher accepted), so no response is dropped.
  * **supervised restart**: an abrupt death keeps the member's router
    handle: the prober sees the address fail, the breaker ejects, the
    supervisor restarts the child on its pinned port, and the half-open
    probe re-admits it. Membership changes only on planned transitions.

:meth:`signals` aggregates the members' admission-queue stats (the
``/healthz`` batcher block: queued and in-flight rows, the ``admitted_rows``
odometer, the dispatch EMA) into one :class:`~.autoscaler.ScaleSignals`.
Each round also scrapes every live member's ``/telemetryz`` into the fleet's
:class:`~..telemetry.aggregate.FleetCollector` (fault site ``fleet/scrape``,
fired by the collector), so the shed pressure is differentiated from the
fleet aggregate (replica ``serve/shed_requests`` plus router
``fleet/shed_requests``, terminal scrapes included), which stays monotone
across restarts and scale-downs. The aggregate feeds the
:class:`~..telemetry.slo.SloEvaluator` each round; a burning objective is
pressure. The fleet arrival-rate EMA is differentiated here, on the
coordinator, from the admitted-rows odometers (the 0.7/0.3 fold of the
admission queue's dispatch EMA), so it decays to zero across silence.
"""

from __future__ import annotations

import threading
import time

from ..exec import config as exec_config
from ..serve.client import ServeClient
from ..serve.router import FleetRouter
from ..telemetry import REGISTRY
from ..telemetry.aggregate import FleetCollector
from ..telemetry.slo import SloEvaluator
from ..utils.logging import get_logger, log_event
from .autoscaler import ScaleSignals
from .replica import ReplicaSupervisor

_log = get_logger("scale.elastic")


class ElasticFleet:
    """N process replicas behind one router, with elastic membership.

    ``replicas`` is the initial (and minimum sensible) member count —
    default the ``scale_min`` knob. Construction reaps orphans (via the
    supervisor), spawns the initial members to readiness, and builds the
    router over them; :meth:`start` begins probing.
    """

    def __init__(
        self,
        model_path: str,
        *,
        replicas: int | None = None,
        host: str = "127.0.0.1",
        device: str = "cuda",
        fleet_name: str = "fleet",
        pidfile_dir: str | None = None,
        router_kw: dict | None = None,
        prewarm: bool = True,
        joiner_prewarm: bool | None = None,
        spawn_timeout_s: float | None = None,
        stats_timeout_s: float = 2.0,
        child_env: dict | None = None,
        metrics_dir: str | None = None,
        slo: SloEvaluator | None = None,
        compile_cache_dir: str | None = None,
        artifact: str | None = None,
        tuning_profile: str | None = None,
    ):
        self.supervisor = ReplicaSupervisor(
            model_path, host=host, device=device,
            fleet_name=fleet_name, pidfile_dir=pidfile_dir,
            prewarm=prewarm, spawn_timeout_s=spawn_timeout_s,
            child_env=child_env, metrics_dir=metrics_dir,
            # Every member, founders and joiners alike, boots against the
            # shared kernel build cache and the baked artifact.
            compile_cache_dir=compile_cache_dir, artifact=artifact,
            tuning_profile=tuning_profile,
        )
        self._host = host
        # Scale-up joiners may come up without the lattice prewarm (their
        # first dispatch pays it instead of the spawn-to-READY wait the
        # autoscaler sits out); None inherits ``prewarm``.
        self._joiner_prewarm = joiner_prewarm
        self._stats_timeout_s = stats_timeout_s
        self._scale_lock = threading.Lock()
        self._name_seq = 0
        initial = int(exec_config.resolve("scale_min", replicas))
        members = []
        for _ in range(initial):
            members.append(self.supervisor.spawn(self._next_name()))
        self.router = FleetRouter(members, **(router_kw or {}))
        self.target = initial
        self._stats_clients: dict[str, ServeClient] = {}
        # The collector accumulates every member's /telemetryz (terminal
        # scrapes retained across scale-downs and restarts); the SLO
        # evaluator rides its aggregate.
        self.collector = FleetCollector(local_name="router")
        self.slo = SloEvaluator() if slo is None else slo
        # Per-member arrival baselines (restart-aware) + the aggregate
        # shed baseline: delta, not level, is the pressure signal. The
        # aggregate is monotone by collector construction, but the
        # coordinator's process-global registry may carry counts from an
        # earlier fleet in this process — baseline them away.
        self._admitted_seen: dict[str, int] = {}
        self._agg_sheds_seen = self._aggregate_sheds()
        self._arrival_ema: float | None = None
        self._last_signals_t: float | None = None
        REGISTRY.set_gauge(
            "langdetect_fleet_live_replicas", float(len(members))
        )
        REGISTRY.set_gauge(
            "langdetect_fleet_target_replicas", float(self.target)
        )
        log_event(
            _log, "scale.fleet.start", replicas=initial,
            pidfile_dir=self.supervisor.pidfile_dir,
        )

    def _next_name(self) -> str:
        name = f"r{self._name_seq}"
        self._name_seq += 1
        return name

    # ------------------------------------------------------------ lifecycle --
    def start(self, *, probe: bool = True) -> "ElasticFleet":
        self.router.start(probe=probe)
        return self

    def close(self, *, drain: bool = True) -> None:
        self.router.close()
        self.supervisor.close(drain=drain)

    def __enter__(self) -> "ElasticFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def live_count(self) -> int:
        return self.supervisor.live_count()

    # ------------------------------------------------------------ membership --
    def scale_to(self, n: int) -> int:
        """Grow or shrink membership to ``n`` live replicas; returns the
        resulting target. Spawn failures raise (after the bounded
        backoff) with the target reflecting what actually happened —
        the autoscaler simply tries again on a later tick."""
        with self._scale_lock:
            while self.target < n:
                self._add_one_locked()
            while self.target > n:
                self._remove_one_locked()
            return self.target

    def _add_one_locked(self) -> None:
        name = self._next_name()
        rep = self.supervisor.spawn(name, prewarm=self._joiner_prewarm)
        self.router.add_replica(rep, name=name)
        self.target += 1
        REGISTRY.incr("scale/ups")
        REGISTRY.set_gauge(
            "langdetect_fleet_live_replicas", float(self.live_count())
        )
        log_event(
            _log, "scale.up", replica=name, port=rep.address[1],
            target=self.target,
        )

    def _remove_one_locked(self) -> None:
        victim = self._newest_member()
        if victim is None:
            self.target = self.live_count()
            return
        # Drain-then-detach, then ask the child to leave gracefully: the
        # router half stops NEW traffic and waits out routed requests;
        # the child half (stdin EOF) drains whatever its batcher already
        # accepted. Neither half can drop an accepted request. The down
        # is COMMITTED the moment the router detaches — a failure in the
        # child's cleanup must not leave target above live forever (the
        # autoscaler would defer on the phantom member for the rest of
        # its life); the stop escalates SIGTERM→SIGKILL internally and
        # the atexit reaper is the last-ditch backstop.
        self.router.remove_replica(victim, drain=True)
        self.target -= 1
        REGISTRY.incr("scale/downs")
        # Terminal scrape between the router drain (every routed request
        # answered, counters final) and the child's exit: the victim's
        # telemetry folds into the collector's retained base, so the
        # scale-down loses no counters (the worker's own exit-flush into
        # its JSONL capture is the belt to this suspender).
        rep = self.supervisor.members.get(victim)
        if rep is not None and rep.alive:
            host, port = rep.address
            self.collector.scrape(
                victim,
                self._member_client(victim, host, port).telemetryz,
            )
        self.collector.retire(victim)
        self._stats_clients.pop(victim, None)
        self._admitted_seen.pop(victim, None)
        try:
            self.supervisor.stop(victim, drain=True)
        except Exception as e:
            log_event(
                _log, "scale.down_stop_error", replica=victim,
                error=repr(e),
            )
        REGISTRY.set_gauge(
            "langdetect_fleet_live_replicas", float(self.live_count())
        )
        log_event(_log, "scale.down", replica=victim, target=self.target)

    def _newest_member(self) -> str | None:
        """Scale-down victim: the newest member (highest sequence) — the
        oldest replicas hold the longest-lived caches and the most
        settled breaker history, so capacity leaves in LIFO order."""
        with self.supervisor._lock:
            names = [
                name for name in self.supervisor.members
                if name not in self.supervisor._retired
                and name not in self.supervisor._failed
            ]
        if not names:
            return None
        return max(names, key=lambda n: int(n.lstrip("r") or 0))

    def check_members(self) -> list[str]:
        """One supervision round. Restarts keep the member's router
        handle (the breaker machinery re-admits); a member past its
        restart budget is detached from routing and the target drops —
        the autoscaler's min-floor repair spawns a fresh replacement."""
        events = self.supervisor.poll_once()
        for ev in events:
            name, _, what = ev.partition(":")
            # Every supervision event here began as a detected death
            # (restarted or gave up): charge the signature last routed to
            # that member in the query-of-death table, so a poison request
            # that kills process replicas out of band (the router never saw
            # a connection drop) still meets its K-death quarantine bound.
            self.router.quarantine.replica_died(name, source="supervisor")
            if what == "gave_up":
                try:
                    self.router.remove_replica(name, drain=False)
                except ValueError:
                    pass
                # Fully forgotten: a gave-up member must never be chosen
                # as a later scale-down victim (its router handle is
                # already gone — removing it again would wedge the
                # shrink path on a ValueError forever).
                self.supervisor.forget(name)
                with self._scale_lock:
                    self.target = max(0, self.target - 1)
                # The process is gone (no farewell scrape possible);
                # retiring retains whatever its last scrape carried.
                self.collector.retire(name)
                self._stats_clients.pop(name, None)
                self._admitted_seen.pop(name, None)
        if events:
            REGISTRY.set_gauge(
                "langdetect_fleet_live_replicas", float(self.live_count())
            )
        return events

    # -------------------------------------------------------------- signals --
    def _aggregate_sheds(self) -> float:
        # The fleet-aggregate shed odometer: replica-side admission sheds
        # plus router-side routing sheds, summed out of the collector
        # (retained generations + live scrapes + the coordinator's own
        # registry). Monotone by construction, so the pressure delta is
        # a plain subtraction — no per-member restart clamping.
        return (
            self.collector.counter("fleet/shed_requests")
            + self.collector.counter("serve/shed_requests")
        )

    def collect_telemetry(self) -> None:
        """Scrape every live member's ``/telemetryz`` into the collector
        (one round, run by every :meth:`signals` call). The collector fires
        the ``fleet/scrape`` fault site per scrape: an injected failure is
        counted (``fleet/agg_scrape_failures``) like a member dying mid
        scrape, never raised into the tick loop."""
        with self.supervisor._lock:
            members = [
                (name, rep)
                for name, rep in self.supervisor.members.items()
                if name not in self.supervisor._retired
            ]
        for name, rep in members:
            if not rep.alive:
                continue
            host, port = rep.address
            self.collector.scrape(
                name, self._member_client(name, host, port).telemetryz
            )
        self.collector.freshness_s()

    def _member_client(self, name: str, host: str, port: int) -> ServeClient:
        client = self._stats_clients.get(name)
        if client is None or client.port != port:
            client = ServeClient(host, port, timeout_s=self._stats_timeout_s)
            self._stats_clients[name] = client
        return client

    def signals(self) -> ScaleSignals:
        """Aggregate the autoscaler's inputs across the live fleet.

        ``ema_rows_per_s`` is the fleet arrival-rate EMA (differentiated
        from the admitted-rows odometers, so it decays across silence);
        ``est_wait_ms`` is backlog over the summed per-replica dispatch-
        throughput EMAs — the same estimate each admission queue sheds
        on, fleet-wide. ``shed_delta`` differentiates the **fleet
        telemetry aggregate** (one scrape round runs first), and
        ``slo_burning`` carries the burn-rate verdict over the same
        aggregate."""
        self.collect_telemetry()
        with self.supervisor._lock:
            members = [
                (name, rep) for name, rep in self.supervisor.members.items()
                if name not in self.supervisor._retired
            ]
        live = 0
        queued = inflight = 0
        service_ema = 0.0
        arrivals = 0
        for name, rep in members:
            if not rep.alive:
                continue
            host, port = rep.address
            try:
                health = self._member_client(name, host, port).healthz()
            except Exception:
                continue  # mid-death: the supervisor round handles it
            live += 1
            stats = health.get("batcher") or {}
            queued += int(stats.get("queued_rows", 0))
            inflight += int(stats.get("inflight_rows", 0))
            service_ema += float(stats.get("ema_rows_per_s", 0.0))
            # A restarted child restarts its odometer: clamp the delta
            # at the fresh count so the reset never reads as negative
            # arrivals. (Shed deltas no longer need this dance — the
            # collector's generation folding keeps the aggregate
            # monotone.)
            admitted = int(stats.get("admitted_rows", 0))
            seen_rows = self._admitted_seen.get(name, 0)
            arrivals += (
                admitted - seen_rows if admitted >= seen_rows else admitted
            )
            self._admitted_seen[name] = admitted
        agg_sheds = self._aggregate_sheds()
        shed_delta = max(0, int(agg_sheds - self._agg_sheds_seen))
        self._agg_sheds_seen = agg_sheds
        aggregate = self.collector.aggregate()
        slo_status = self.slo.ingest(aggregate)
        now = time.monotonic()
        if self._last_signals_t is not None and now > self._last_signals_t:
            rate = arrivals / (now - self._last_signals_t)
            self._arrival_ema = (
                rate if self._arrival_ema is None
                else 0.7 * self._arrival_ema + 0.3 * rate
            )
        self._last_signals_t = now
        router_health = self.router.healthz()
        breaker_open = any(
            h["breaker"] != "closed" for h in router_health["replicas"]
        )
        sig = ScaleSignals(
            live=live,
            ready=len(router_health["ready_replicas"]),
            queued_rows=queued,
            inflight_rows=inflight,
            ema_rows_per_s=self._arrival_ema or 0.0,
            est_wait_ms=(
                queued / service_ema * 1e3 if service_ema > 0
                else (0.0 if queued == 0 else float("inf"))
            ),
            shed_delta=shed_delta,
            breaker_open=breaker_open,
            slo_burning=bool(slo_status.get("burning")),
        )
        REGISTRY.set_gauge("langdetect_fleet_live_replicas", float(live))
        return sig

    # -------------------------------------------------------------- status ---
    def healthz(self) -> dict:
        out = self.router.healthz()
        out["target_replicas"] = self.target
        out["live_replicas"] = self.live_count()
        out["pidfile_dir"] = self.supervisor.pidfile_dir
        slo = self.slo.status()
        out["slo"] = slo
        if slo["burning"]:
            out["reasons"] = list(out.get("reasons") or []) + slo["reasons"]
        out["telemetry"] = {
            "members": self.collector.members(),
            "scrapes": self.collector.scrapes,
            "scrape_failures": self.collector.scrape_failures,
            "freshness_s": round(self.collector.freshness_s(), 3),
        }
        return out
