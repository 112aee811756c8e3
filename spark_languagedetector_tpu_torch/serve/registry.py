"""Versioned model registry: zero-downtime hot swap for the serving path.

Port of ``spark_languagedetector_tpu.serve.registry``. A swap is: load the
new model (``LanguageDetectorModel.load`` when given a path, so a model
saved by either package serves), build its runner off the serving path,
prewarm it (score probe documents and load the library of every CUDA
kernel its strategy can launch, so no request pays a kernel build), then
flip the serving pointer. In-flight dispatches finish on the version they
leased (:meth:`ModelRegistry.lease` counts leases per entry).

Every request is answered by exactly one version: the dispatcher leases
the active entry per dispatch, the flip happens between leases, and a
lease pins its entry until released.

Only the active version holds a runner. Each version that holds one takes a
hold on its model's cached runner (``LanguageDetectorModel.hold_runner``)
and a retired version gives it back once its last lease ends
(``release_runner``): the model drops its runner, so the device tables and
pinned staging can be freed, when no registry holds it any more. Registries
sharing one model (a fleet's replicas) thus build one runner per model, and
a rollback or activation rebuilds and prewarms it only when no other
registry still serves from it.

The swap decomposes into :meth:`ModelRegistry.prepare` (build + prewarm,
nothing serving-visible) and :meth:`ModelRegistry.commit` (the pointer
flip); :meth:`install` is the two together.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator

from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event
from .batcher import ServeClosed, ServeError

_log = get_logger("serve.registry")

# Prewarm probe: one short and one bucket-spanning document.
DEFAULT_PREWARM_DOCS = (b"serve warmup", b"x" * 300)


class ModelVersion:
    """One registered model: its runner (None once retired and released),
    language names and lease count."""

    __slots__ = (
        "version", "model", "runner", "languages", "source",
        "installed_at", "inflight", "retired", "metadata",
    )

    def __init__(self, version, model, runner, source, metadata=None):
        self.version = version
        self.model = model
        self.runner = runner
        self.languages = tuple(model.profile.languages)
        self.source = source
        self.installed_at = time.time()
        self.inflight = 0
        self.retired = False
        self.metadata = dict(metadata) if metadata else None

    def describe(self) -> dict:
        out = {
            "version": self.version,
            "uid": self.model.uid,
            "languages": len(self.languages),
            "grams": int(self.model.profile.num_grams),
            "source": self.source,
            "strategy": None if self.runner is None else self.runner.strategy,
            "device": None if self.runner is None else str(self.runner.device),
            "quantization": self.model.get("quantization"),
            "installed_at": self.installed_at,
            "inflight": self.inflight,
            "retired": self.retired,
        }
        if self.metadata:
            out["metadata"] = dict(self.metadata)
        return out


class PreparedVersion:
    """Phase 1 of a swap: a runner built and prewarmed off the serving
    path, not yet serving-visible. :meth:`ModelRegistry.commit` flips it
    in; dropping it aborts (nothing was installed)."""

    __slots__ = ("model", "runner", "version", "source", "metadata")

    def __init__(self, model, runner, version, source, metadata=None):
        self.model = model
        self.runner = runner
        self.version = version
        self.source = source
        self.metadata = metadata


class ModelRegistry:
    """Serving pointer + version history with atomic flips.

    ``device`` is where :meth:`load` puts the models it reads (None: the
    CUDA card, which raises without one). Swaps (``commit``, ``rollback``,
    ``activate``) are serialized among themselves; leases never wait for
    a runner build. A swap under way counts as :meth:`busy`; after
    :meth:`close`, a swap raises :class:`ServeClosed` and keeps no runner.
    """

    def __init__(
        self,
        *,
        device: str | None = None,
        drain_timeout_s: float = 10.0,
    ):
        self.device = device
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._swap_lock = threading.Lock()
        self._history: list[ModelVersion] = []
        self._active_idx: int | None = None
        self._counter = 0
        self._drain_timeout_s = drain_timeout_s
        self._swaps = 0  # install/rollback/activate calls under way
        self._closed = False

    @contextmanager
    def _swapping(self) -> Iterator[None]:
        with self._lock:
            self._swaps += 1
        try:
            yield
        finally:
            with self._lock:
                self._swaps -= 1

    def _refuse_closed_locked(self, model, runner) -> None:
        """A swap that reaches a closed registry gives its runner back (a
        hold taken and released, so a runner nothing else holds is
        dropped) and raises (caller holds the lock)."""
        if self._closed:
            model.hold_runner(runner)
            model.release_runner()
            raise ServeClosed("model registry is closed")

    # ------------------------------------------------------------ swaps -----
    @staticmethod
    def _warm_runner(model, prewarm: bool = True):
        """``model.runner``, built; with ``prewarm``, also the library of
        every kernel its strategy can launch loaded (a missing build
        happens here, never inside the dispatcher) and the probe documents
        scored."""
        runner = model.runner
        if prewarm:
            for kernel in runner.kernels():
                kernel.library()
            runner.score(list(DEFAULT_PREWARM_DOCS))
        return runner

    def prepare(
        self,
        model,
        *,
        version: str | None = None,
        prewarm: bool = True,
        source: str | None = None,
        metadata: dict | None = None,
    ) -> PreparedVersion:
        """Phase 1 of a swap: build ``model``'s runner and (``prewarm``)
        warm it, off the serving path. Raises on any build or prewarm
        failure, with nothing serving-visible changed. Version-name
        conflicts are checked at :meth:`commit`."""
        return PreparedVersion(
            model, self._warm_runner(model, prewarm), version, source, metadata
        )

    def install(
        self,
        model,
        *,
        version: str | None = None,
        prewarm: bool = True,
        source: str | None = None,
        metadata: dict | None = None,
    ) -> str:
        """Register ``model`` and atomically make it the serving version
        (:meth:`prepare`, then :meth:`commit`). Returns the version name
        (auto ``v1``, ``v2``, … when not given). The previously active
        version is drained (bounded by ``drain_timeout_s``) and retired,
        kept in history for :meth:`rollback`.

        ``metadata``: a provenance dict that ``describe()``/``versions()``
        report — ``AutoRefit`` stamps its refit token and the
        documents seen here, so an operator can tell which accumulated
        corpus a serving version was finalized from.
        """
        with self._swapping():
            return self.commit(self.prepare(
                model, version=version, prewarm=prewarm, source=source,
                metadata=metadata,
            ))

    def commit(self, prepared: PreparedVersion) -> str:
        """Phase 2 of a swap: atomically flip the serving pointer to a
        prepared runner. Returns the version name."""
        version = prepared.version
        with self._swap_lock:
            with self._cv:
                self._refuse_closed_locked(prepared.model, prepared.runner)
                if version is None:
                    # Auto names skip anything already registered (an
                    # explicit install may have claimed a future "vN").
                    self._counter += 1
                    while any(e.version == f"v{self._counter}" for e in self._history):
                        self._counter += 1
                    version = f"v{self._counter}"
                if any(e.version == version for e in self._history):
                    raise ServeError(f"version {version!r} already registered")
                entry = ModelVersion(
                    version, prepared.model, prepared.model.hold_runner(prepared.runner),
                    prepared.source, prepared.metadata,
                )
                old = None if self._active_idx is None else self._history[self._active_idx]
                self._history.append(entry)
                self._active_idx = idx = len(self._history) - 1
            REGISTRY.incr("serve/swaps")
            REGISTRY.set_gauge("langdetect_serve_model_version", float(idx), version=version)
            log_event(
                _log, "serve.swap", version=version, source=prepared.source,
                previous=old.version if old is not None else None,
            )
            if old is not None:
                self._retire(old)
        return version

    def load(
        self,
        path: str,
        *,
        version: str | None = None,
        device: str | None = None,
        artifact: str | None = None,
        prewarm: bool = True,
    ) -> str:
        """Load a saved model directory (this package's or the JAX
        package's layout) onto ``device`` (default: the registry's) and
        swap it in.

        Cold-start fast path: when a baked artifact exists for ``path``
        (``artifact``, else the ``.baked`` sibling or the ``artifact_dir``
        knob), the model is mapped from it instead of parsed from parquet,
        with bit-identical scores; a missing, torn or foreign artifact
        loads the parquet tree (``artifacts.maybe_load_baked``)."""
        from ..artifacts.bake import maybe_load_baked

        device = device or self.device
        model = maybe_load_baked(path, artifact, device=device)
        if model is None:
            from ..models.estimator import LanguageDetectorModel

            model = LanguageDetectorModel.load(path, device=device)
        return self.install(model, version=version, prewarm=prewarm, source=str(path))

    def _flip_to(self, pick, counter: str, event: str) -> str:
        """Flip the pointer to the entry ``pick(history, active_idx)``
        names (an index, or the active one for a no-op), building and
        prewarming its runner first if it was released."""
        with self._swapping(), self._swap_lock:
            with self._cv:
                idx = pick(self._history, self._active_idx)
                entry = self._history[idx]
                if idx == self._active_idx:
                    return entry.version
                runner = entry.runner
            if runner is None:
                runner = self._warm_runner(entry.model)
            with self._cv:
                self._refuse_closed_locked(entry.model, runner)
                # Runner, pointer and flag in one critical section: a lease
                # ending on this entry can no longer release the runner.
                if entry.runner is None:
                    entry.runner = entry.model.hold_runner(runner)
                old = None if self._active_idx is None else self._history[self._active_idx]
                self._active_idx = idx
                entry.retired = False
            REGISTRY.incr(counter)
            REGISTRY.set_gauge(
                "langdetect_serve_model_version", float(idx), version=entry.version
            )
            log_event(
                _log, event, version=entry.version,
                from_=old.version if old is not None else None,
            )
            if old is not None:
                self._retire(old)
        return entry.version

    def rollback(self) -> str:
        """Flip the serving pointer back to the version installed before
        the active one. The rolled-back version stays in history, so
        repeated rollbacks walk backwards."""

        def previous(history, active):
            if active is None or active == 0:
                raise ServeError("no previous version to roll back to")
            return active - 1

        return self._flip_to(previous, "serve/rollbacks", "serve.rollback")

    def activate(self, version: str) -> str:
        """Flip the serving pointer to a *named* version already in
        history."""

        def named(history, active):
            for i, e in enumerate(history):
                if e.version == version:
                    return i
            raise ServeError(f"version {version!r} not in history")

        return self._flip_to(named, "serve/activations", "serve.activate")

    def _retire(self, entry: ModelVersion) -> None:
        """Drain ``entry`` (wait for in-flight leases, bounded), mark it
        retired and release its runner if no lease holds it any more; a
        lease still held past the drain timeout releases it on exit."""
        deadline = time.monotonic() + self._drain_timeout_s
        with self._cv:
            while entry.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(min(remaining, 0.1))
            drained = entry.inflight == 0
            entry.retired = True
            self._release_locked(entry)
        log_event(_log, "serve.retired", version=entry.version, drained=drained)

    def _release_locked(self, entry: ModelVersion) -> None:
        """Drop a retired, unleased, inactive entry's runner (caller holds
        the lock)."""
        if (
            entry.retired
            and entry.inflight == 0
            and entry.runner is not None
            and (self._active_idx is None or self._history[self._active_idx] is not entry)
        ):
            entry.runner = None
            entry.model.release_runner()
            REGISTRY.incr("serve/released_runners")

    def close(self) -> None:
        """Give back every version's runner hold (the registry serves no
        more: a zoo tenant paged out). Call it with no lease held."""
        with self._cv:
            self._closed = True
            for entry in self._history:
                if entry.runner is not None:
                    entry.runner = None
                    entry.model.release_runner()

    # ----------------------------------------------------------- access -----
    def peek(self) -> ModelVersion:
        """The active entry without pinning it (shed checks, healthz)."""
        with self._lock:
            if self._active_idx is None:
                raise ServeError("no model installed in the serving registry")
            return self._history[self._active_idx]

    @contextmanager
    def lease(self) -> Iterator[ModelVersion]:
        """Pin the active version for one dispatch. The swap flips the
        pointer between leases; a held lease keeps its entry (and its
        runner) alive until released."""
        with self._cv:
            if self._active_idx is None:
                raise ServeError("no model installed in the serving registry")
            entry = self._history[self._active_idx]
            entry.inflight += 1
        try:
            yield entry
        finally:
            with self._cv:
                entry.inflight -= 1
                self._release_locked(entry)
                self._cv.notify_all()

    def current_version(self) -> str:
        return self.peek().version

    def busy(self) -> bool:
        """True while a swap is under way or any version in history holds
        an in-flight lease."""
        with self._lock:
            return self._swaps > 0 or any(e.inflight > 0 for e in self._history)

    def versions(self) -> list[dict]:
        with self._lock:
            active = self._active_idx
            return [
                {**e.describe(), "active": i == active}
                for i, e in enumerate(self._history)
            ]
