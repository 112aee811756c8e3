"""A replicated serving fleet: N replicas, one router, coordinated swaps.

Port of ``spark_languagedetector_tpu.serve.fleet``. Each
:class:`ServeReplica` is a registry, a batcher and an HTTP server;
:class:`ServeFleet` puts N of them behind one
:class:`~.router.FleetRouter` and owns the failure drills and the
two-phase fleet-wide swap that keeps a client stream from ever seeing two
versions interleaved:

Phase 1, prepare everywhere: each replica's registry builds and prewarms
the new version off its serving path
(:meth:`~.registry.ModelRegistry.prepare`). Any failure (a bad directory,
an out-of-memory, a ``fleet/swap`` fault) aborts the swap on every
replica; nothing was serving-visible.

Phase 2, drain and flip one replica at a time: the router marks the
replica draining, waits for its outstanding requests, the registry commits
the flip, and the next replica follows. The router's version pin stays on
the old version until the first flip and moves to the new one right after
it, so a stream sees ``old ... old | new ... new``. A crash in phase 2
rolls every flipped replica back to the old version and re-pins it.

In one process the replicas share one model (:meth:`ServeFleet.from_path`
loads it once), so they share one runner and its CUDA kernels on the card;
each registry holds that runner, so a swap builds one runner per distinct
model and the old one is freed once every replica has retired it.
"""

from __future__ import annotations

import re
import threading
import time

from ..exec import config as exec_config
from ..resilience import faults
from ..telemetry import REGISTRY, span
from ..utils.logging import get_logger, log_event
from .registry import ModelRegistry
from .router import FleetRouter, FleetSwapError
from .server import ServingServer

_log = get_logger("serve.fleet")


def _load_model(path: str, device: str | None):
    from ..models.estimator import LanguageDetectorModel

    return LanguageDetectorModel.load(path, device=device)


class ServeReplica:
    """One fleet member: its own registry, batcher and HTTP server. Its port
    is pinned at the first bind (``port=0`` picks one), so :meth:`kill` and
    :meth:`revive` put it back at the address the router knows."""

    def __init__(
        self,
        name: str,
        model,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        version: str = "v1",
        prewarm: bool = True,
        **batcher_kw,
    ):
        self.name = name
        self.registry = ModelRegistry(device=model.get("device"))
        self.registry.install(model, version=version, prewarm=prewarm)
        self._host = host
        self._port = port
        self._batcher_kw = dict(batcher_kw)
        self.server: ServingServer | None = None
        self.start()

    @property
    def address(self) -> tuple[str, int]:
        return (self._host, self._port)

    @property
    def alive(self) -> bool:
        return self.server is not None

    def start(self) -> "ServeReplica":
        """(Re)start the HTTP server and a fresh batcher on the pinned
        address. The registry (versions, history, leases) survives: a
        revived replica serves what it served before, and the router's pin
        keeps it out of rotation if the fleet moved on meanwhile."""
        if self.server is not None:
            return self
        self.server = ServingServer(
            self.registry, host=self._host, port=self._port, **self._batcher_kw
        ).start()
        self._port = self.server.address[1]
        log_event(_log, "fleet.replica.start", replica=self.name, port=self._port)
        return self

    revive = start

    def kill(self) -> None:
        """Abrupt death: new connections are refused, queued requests fail
        with 503 at once, and the router fails them over."""
        if self.server is None:
            return
        self.server.stop(drain=False)
        self.server = None
        log_event(_log, "fleet.replica.killed", replica=self.name)

    def stop(self) -> None:
        """Graceful stop: answer accepted work, then tear down."""
        if self.server is None:
            return
        self.server.stop(drain=True)
        self.server = None
        log_event(_log, "fleet.replica.stop", replica=self.name)

    def batcher_idle(self) -> bool:
        if self.server is None:
            return True
        stats = self.server.batcher.stats()
        return stats["queued_rows"] == 0 and stats["inflight_rows"] == 0


class ServeFleet:
    """N serving replicas behind one :class:`~.router.FleetRouter`.

    ``models``: one fitted model per replica, distinct objects or one
    shared object (what :meth:`from_path` gives). ``device`` is where the
    models a swap loads from a directory go (None: the CUDA card).
    ``router_kw`` goes to the router, ``batcher_kw`` to every replica's
    batcher.
    """

    def __init__(
        self,
        models,
        *,
        host: str = "127.0.0.1",
        version: str = "v1",
        device: str | None = None,
        router_kw: dict | None = None,
        **batcher_kw,
    ):
        models = list(models)
        if not models:
            raise ValueError("a fleet needs at least one replica model")
        self._host = host
        self.device = device
        self._batcher_kw = dict(batcher_kw)
        self._name_seq = len(models)  # later members continue r<i>
        # Prewarm once per distinct model: shared models share one runner.
        seen: set[int] = set()
        self.replicas = []
        for i, model in enumerate(models):
            self.replicas.append(ServeReplica(
                f"r{i}", model, host=host, version=version, prewarm=id(model) not in seen,
                **batcher_kw,
            ))
            seen.add(id(model))
        self.router = FleetRouter(self.replicas, **(router_kw or {}))
        self.router.pin_version(version)
        # One coordinator at a time for swaps, rollbacks and membership
        # changes; ``_coordinator`` names the holder, so a swap waits out a
        # membership change instead of failing as "already in progress".
        self._swap_lock = threading.Lock()
        self._coordinator: str | None = None

    @classmethod
    def from_path(cls, path: str, *, replicas: int | None = None, device: str | None = None,
                  **kw) -> "ServeFleet":
        """``replicas`` replicas (default: the ``fleet_replicas`` knob) of
        one saved model directory, loaded once onto ``device`` (None: the
        CUDA card) and shared: one copy of the tables per process."""
        n = int(exec_config.resolve("fleet_replicas", replicas))
        model = _load_model(path, device)
        return cls([model] * n, device=device, **kw)

    # ---------------------------------------------------------- lifecycle ---
    def start(self, *, probe: bool = True) -> "ServeFleet":
        self.router.start(probe=probe)
        return self

    def close(self) -> None:
        self.router.close()
        for rep in self.replicas:
            rep.stop()

    def __enter__(self) -> "ServeFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def replica(self, name: str) -> ServeReplica:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        raise ValueError(f"unknown replica {name!r}")

    # ------------------------------------------------- coordinator lock -----
    def _acquire_coordinator(self, kind: str) -> None:
        """A swap or rollback arriving while another runs fails at once (two
        interleaved rounds could pin a version no replica serves); arriving
        during a membership change it waits for it."""
        if self._swap_lock.acquire(blocking=kind == "membership"):
            self._coordinator = kind
            return
        if kind in ("swap", "rollback") and self._coordinator == "membership":
            self._swap_lock.acquire()
            self._coordinator = kind
            return
        raise FleetSwapError(
            f"a fleet {self._coordinator or 'swap/rollback'} is already in progress"
        )

    def _release_coordinator(self) -> None:
        self._coordinator = None
        self._swap_lock.release()

    # -------------------------------------------------------- membership ----
    def add_replica(self, model=None, *, path: str | None = None, name: str | None = None,
                    prewarm: bool = True) -> ServeReplica:
        """Grow the fleet by one replica serving the pinned version (so it
        is swap-consistent at once). Serialized with swaps: a replica never
        joins half-way through phase 2."""
        if (model is None) == (path is None):
            raise ValueError("pass exactly one of model= or path=")
        self._acquire_coordinator("membership")
        try:
            if path is not None:
                model = _load_model(path, self.device)
            version = self.router.pinned_version or self.replicas[0].registry.current_version()
            if name is None:
                name = f"r{self._name_seq}"
                self._name_seq += 1
            rep = ServeReplica(name, model, host=self._host, version=version, prewarm=prewarm,
                               **self._batcher_kw)
            self.replicas.append(rep)
            self.router.add_replica(rep, name=name)
            log_event(_log, "fleet.replica.joined", replica=name, version=version,
                      replicas=len(self.replicas))
            return rep
        finally:
            self._release_coordinator()

    def remove_replica(self, name: str, *, drain: bool = True) -> None:
        """Shrink the fleet by one: the router drains and detaches it, then
        the replica stops (gracefully with ``drain``). The last replica
        cannot be removed."""
        self._acquire_coordinator("membership")
        try:
            rep = self.replica(name)
            if len(self.replicas) == 1:
                raise ValueError("cannot remove the last replica of a serving fleet")
            self.router.remove_replica(name, drain=drain)
            self.replicas.remove(rep)
            if drain:
                rep.stop()
            else:
                rep.kill()
            log_event(_log, "fleet.replica.left", replica=name, replicas=len(self.replicas))
        finally:
            self._release_coordinator()

    # ------------------------------------------------------------- swaps ----
    def _next_version(self) -> str:
        n = 0
        for rep in self.replicas:
            for v in rep.registry.versions():
                m = re.fullmatch(r"v(\d+)", v["version"])
                if m:
                    n = max(n, int(m.group(1)))
        return f"v{n + 1}"

    def swap(self, path: str | None = None, *, models=None, version: str | None = None,
             prewarm: bool = True) -> str:
        """Fleet-wide two-phase swap to a saved model directory (loaded once
        onto the fleet's device, shared) or to ``models`` (one per
        replica); returns the new version. Raises
        :class:`~.router.FleetSwapError` on an abort or a rollback, with the
        fleet on one version either way."""
        self._acquire_coordinator("swap")
        try:
            return self._swap_locked(path, models=models, version=version, prewarm=prewarm)
        finally:
            self._release_coordinator()

    def _swap_locked(self, path, *, models, version, prewarm) -> str:
        if (path is None) == (models is None):
            raise ValueError("pass exactly one of path= or models=")
        if models is not None:
            models = list(models)
            if len(models) != len(self.replicas):
                raise ValueError(
                    f"need one model per replica ({len(self.replicas)}), got {len(models)}"
                )
        version = version or self._next_version()
        old = self.router.pinned_version or self.replicas[0].registry.current_version()
        t0 = time.perf_counter()
        with span("fleet/swap", replicas=len(self.replicas), version=version):
            if models is None:
                models = [_load_model(path, self.device)] * len(self.replicas)
            # Phase 1: prepare on every replica (prewarm once per distinct
            # model). Any failure aborts everywhere; the old version serves.
            prepared = []
            warmed: set[int] = set()
            for rep, model in zip(self.replicas, models):
                try:
                    faults.inject("fleet/swap")
                    prepared.append(rep.registry.prepare(
                        model, version=version, prewarm=prewarm and id(model) not in warmed,
                        source=path and str(path), metadata={"fleet_swap": version},
                    ))
                    warmed.add(id(model))
                except Exception as e:
                    REGISTRY.incr("fleet/swap_aborts")
                    log_event(_log, "fleet.swap_abort", phase=1, replica=rep.name,
                              version=version, error=repr(e))
                    raise FleetSwapError(
                        f"phase 1 (prepare) failed on {rep.name}: {e!r}; swap aborted "
                        f"fleet-wide, {old!r} keeps serving"
                    ) from e
            # Phase 2: drain and flip one replica at a time; the pin moves
            # to the new version once, right after the first flip.
            self.router.pin_version(old)
            flipped: list[ServeReplica] = []
            current: ServeReplica | None = None
            try:
                for i, (rep, prep) in enumerate(zip(self.replicas, prepared)):
                    current = rep
                    self.router.set_draining(rep.name, True)
                    self._drain(rep)
                    faults.inject("fleet/swap")
                    rep.registry.commit(prep)
                    self.router.note_version(rep.name, version)
                    self.router.set_draining(rep.name, False)
                    flipped.append(rep)
                    if i == 0:
                        self.router.pin_version(version)
            except Exception as e:
                # Converge back: flipped replicas return to the named old
                # version (activate, not rollback: the history may hold
                # standbys of earlier aborted swaps). Its runner is still
                # held by the unflipped replicas, so no rebuild happens.
                if current is not None:
                    self.router.set_draining(current.name, False)
                for rep in flipped:
                    rep.registry.activate(old)
                    self.router.note_version(rep.name, old)
                self.router.pin_version(old)
                REGISTRY.incr("fleet/swap_aborts")
                log_event(
                    _log, "fleet.swap_abort", phase=2,
                    replica=current.name if current else None, version=version,
                    rolled_back=[r.name for r in flipped], error=repr(e),
                )
                raise FleetSwapError(
                    f"phase 2 (commit) failed on {current.name if current else '?'}: {e!r}; "
                    f"{len(flipped)} flipped replica(s) rolled back to {old!r}"
                ) from e
        REGISTRY.incr("fleet/swaps")
        log_event(_log, "fleet.swap", version=version, previous=old,
                  replicas=len(self.replicas),
                  wall_ms=round((time.perf_counter() - t0) * 1e3, 3))
        return version

    def rollback(self) -> str:
        """Fleet-wide rollback: phase 2 walked backwards (drain and flip one
        replica at a time behind the pin). Serialized with :meth:`swap`."""
        self._acquire_coordinator("rollback")
        try:
            return self._rollback_locked()
        finally:
            self._release_coordinator()

    def _rollback_locked(self) -> str:
        old = self.router.pinned_version or self.replicas[0].registry.current_version()
        with span("fleet/rollback", replicas=len(self.replicas)):
            self.router.pin_version(old)
            target: str | None = None
            for i, rep in enumerate(self.replicas):
                self.router.set_draining(rep.name, True)
                try:
                    self._drain(rep)
                    version = rep.registry.rollback()
                finally:
                    self.router.set_draining(rep.name, False)
                if target is None:
                    target = version
                elif version != target:
                    raise FleetSwapError(
                        f"divergent rollback: {rep.name} landed on {version!r}, "
                        f"expected {target!r}"
                    )
                self.router.note_version(rep.name, version)
                if i == 0:
                    self.router.pin_version(version)
        REGISTRY.incr("fleet/rollbacks")
        log_event(_log, "fleet.rollback", version=target, previous=old)
        return target

    def _drain(self, rep: ServeReplica) -> None:
        """Wait (bounded) until no routed request is outstanding on ``rep``
        and its batcher is idle. On a timeout the flip goes ahead: the
        registry's leases still finish in-flight dispatches on their
        version."""
        deadline = time.monotonic() + self.router.drain_timeout_s
        self.router.wait_drained(rep.name, timeout_s=max(deadline - time.monotonic(), 0.0))
        while not rep.batcher_idle():
            if time.monotonic() >= deadline:
                log_event(_log, "fleet.drain_timeout", replica=rep.name)
                break
            time.sleep(0.002)

    def versions(self) -> dict:
        return {rep.name: rep.registry.current_version() for rep in self.replicas}
