"""Auto-refit loop: streaming batches → count accumulator → hot swap.

Port of ``spark_languagedetector_tpu.stream.refit``. The continuous-learning
loop: a labeled micro-batch source feeds an incremental
:class:`~..models.refit.FitAccumulator` through the same pipelined count
path the from-scratch device fit uses; every committed batch checkpoints
the accumulator (crash-atomic, resume token inside the state); and on a
trigger — every N batches and/or every N docs — the loop re-runs only the
finalize and pushes the new model through
:class:`~..serve.registry.ModelRegistry` hot swap, so the serving path
picks up everything learned so far with the swap's provenance (refit token,
docs seen) stamped on the version.

Exactness contract: every refit model is bit-identical to a from-scratch
``LanguageDetector.fit`` over the concatenation of every batch consumed so
far. A restart with the same ``state_path`` fast-forwards the
(replayed-from-the-start) source past the ``committed`` batches already
inside the table — the same replayable-source contract ``run_stream``'s
checkpointing has — so a kill mid-stream neither loses nor double-counts a
batch. The accumulator lives on the estimator's device (the CUDA card
unless the estimator asks for the CPU).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("stream.refit")


@dataclass
class RefitProgress:
    """Progress handle for a running (or finished) auto-refit loop."""

    batches: int = 0
    rows: int = 0
    refits: int = 0
    # Source batches skipped on start because the restored accumulator's
    # resume token said their counts were already committed.
    resumed_from: int = 0
    last_version: str | None = None
    last_refit_docs: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)


class AutoRefit:
    """Drive incremental refits from a labeled micro-batch source.

    ``estimator`` supplies the fit configuration (and builds each refit
    model); ``registry`` (optional) receives every refit via hot-swap
    ``install``. ``state_path`` (optional) checkpoints the accumulator
    after every consumed batch and resumes from it on construction — the
    state must match the estimator's fit configuration exactly, or
    construction refuses (a refit under different fit params would not be
    the model the token promises).

    Triggers: ``refit_every_batches`` / ``refit_every_docs`` (either, both,
    or neither — with neither, refits happen only via :meth:`refit_now`
    and the end-of-run ``final_refit``). Synchronous use: :meth:`run`.
    Background use: :meth:`start` / :meth:`stop` — the loop runs on a
    daemon thread, checkpoints and swaps exactly as in the foreground, and
    :meth:`stop` (or a source that ends) finishes cleanly.
    """

    def __init__(
        self,
        estimator,
        registry=None,
        *,
        state_path: str | None = None,
        refit_every_batches: int | None = None,
        refit_every_docs: int | None = None,
        final_refit: bool = True,
        prewarm: bool = True,
        source_name: str = "auto-refit",
        tenant: str | None = None,
    ):
        from ..models.refit import FitAccumulator

        self.estimator = estimator
        self.registry = registry
        self.state_path = state_path
        self.refit_every_batches = refit_every_batches
        self.refit_every_docs = refit_every_docs
        self.final_refit = final_refit
        self.prewarm = prewarm
        self.source_name = source_name
        # Tenant-scoped refit: a model zoo hands this loop one tenant's
        # registry, so a refit can only ever move that tenant's serving
        # pointer; the tenant rides the swap metadata and log so /varz says
        # whose corpus a version was finalized from.
        self.tenant = tenant
        self.progress = RefitProgress()
        self.last_model = None
        self._since_refit_batches = 0
        self._since_refit_docs = 0
        self._dirty = False  # updates not yet reflected in a refit model
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

        if state_path is not None:
            # Finish a checkpoint swap a crash may have interrupted (the
            # state would otherwise look absent and silently restart the
            # accumulator from zero).
            from ..persist.io import recover_fit_state

            recover_fit_state(state_path)
        if state_path is not None and Path(state_path).exists():
            self.acc = FitAccumulator.load(state_path, device=estimator.get("device"))
            if not self.acc.matches_estimator(estimator):
                raise ValueError(
                    f"persisted fit state at {state_path} was accumulated "
                    "under a different fit configuration than this "
                    "estimator's (vocab spec / languages / weightMode / "
                    "languageProfileSize)"
                )
            self._dirty = self.acc.docs_seen > 0
        else:
            self.acc = estimator.accumulator()

    # -------------------------------------------------------------- loop ----
    def process_batch(self, table) -> int:
        """Consume one source batch: accumulate, checkpoint, maybe refit.
        Returns rows added."""
        added = self.acc.update(table)
        if self.state_path is not None:
            # The checkpoint carries the resume token INSIDE the counts
            # state, so commit is one atomic step — a kill between update
            # and save simply replays this batch into a pre-update state.
            self.acc.save(self.state_path)
        with self.progress._lock:
            self.progress.batches += 1
            self.progress.rows += added
        self._since_refit_batches += 1
        self._since_refit_docs += added
        if added:
            self._dirty = True
        REGISTRY.incr("refit/batches")
        REGISTRY.incr("refit/rows", added)
        REGISTRY.set_gauge(
            "langdetect_refit_committed", float(self.acc.committed)
        )
        if (
            self.refit_every_batches is not None
            and self._since_refit_batches >= self.refit_every_batches
        ) or (
            self.refit_every_docs is not None
            and self._since_refit_docs >= self.refit_every_docs
        ):
            self.refit_now()
        return added

    def refit_now(self) -> str | None:
        """Finalize the accumulator into a model and hot-swap it in.

        Returns the installed version name (None without a registry — the
        model is still built and kept as ``last_model``). Skips (returns
        None) while any supported language still has zero coverage: a
        refit that cannot validate is deferred, not fatal — the stream
        may simply not have reached that language yet.
        """
        if self.acc.coverage_gaps():
            log_event(
                _log, "refit.deferred",
                missing=self.acc.coverage_gaps(), batches=self.acc.committed,
            )
            return None
        # No wrapper span: fit_from_accumulator records the same "fit" /
        # "fit/finalize" / "fit/collect" stage paths as a from-scratch fit
        # (attr incremental=True distinguishes them), so the compare
        # guard's stage contract covers both without path forks.
        model = self.estimator.fit_from_accumulator(self.acc)
        self.last_model = model
        self._since_refit_batches = 0
        self._since_refit_docs = 0
        self._dirty = False
        REGISTRY.incr("refit/refits")
        version = None
        if self.registry is not None:
            metadata = {
                "refit_token": self.acc.committed,
                "docs_seen": self.acc.docs_seen,
            }
            if self.tenant is not None:
                metadata["tenant"] = self.tenant
            version = self.registry.install(
                model,
                prewarm=self.prewarm,
                source=f"{self.source_name}:{self.acc.committed}",
                metadata=metadata,
            )
        with self.progress._lock:
            self.progress.refits += 1
            self.progress.last_version = version
            self.progress.last_refit_docs = self.acc.docs_seen
        log_event(
            _log, "refit.swap", version=version, docs=self.acc.docs_seen,
            token=self.acc.committed, tenant=self.tenant,
        )
        return version

    def run(
        self, source: Iterable, max_batches: int | None = None
    ) -> RefitProgress:
        """Consume ``source`` (an ``Iterable[Table]`` replayed from the
        start, like ``run_stream``'s) until it ends, ``max_batches`` NEW
        batches were consumed, or :meth:`stop` is called; then run the
        final refit (when enabled and updates are pending)."""
        it = iter(source)
        skipped = 0
        while skipped < self.acc.committed:
            try:
                next(it)
            except StopIteration:
                # The replayed source ended before reaching the resume
                # token: this is NOT the source the state was built from
                # (rotated/truncated/wrong stream). Refusing loudly is
                # the only honest option — fast-forwarding less than
                # `committed` would desynchronize token and stream and
                # double-count every remaining batch.
                raise RuntimeError(
                    f"resume token says {self.acc.committed} batches are "
                    f"already committed, but the source replayed only "
                    f"{skipped} — the source does not match the "
                    "persisted accumulator state"
                )
            skipped += 1
        with self.progress._lock:
            self.progress.resumed_from = skipped
        if skipped:
            log_event(_log, "refit.resume", committed=skipped)
        consumed = 0
        while not self._stop.is_set():
            if max_batches is not None and consumed >= max_batches:
                break
            try:
                batch = next(it)
            except StopIteration:
                break
            self.process_batch(batch)
            consumed += 1
        if self.final_refit and (self._dirty or self.last_model is None):
            self.refit_now()
        return self.progress

    # -------------------------------------------------------- background ----
    def start(
        self, source: Iterable, max_batches: int | None = None
    ) -> "AutoRefit":
        """Run :meth:`run` on a background daemon thread (the auto-refit
        daemon: fits happen off the serving path; only the registry's
        pointer flip ever touches it)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("auto-refit loop already running")
        self._stop.clear()
        self._error = None

        def body():
            try:
                self.run(source, max_batches=max_batches)
            except BaseException as e:  # surfaced by wait()/stop()
                self._error = e

        self._thread = threading.Thread(
            target=body, name="auto-refit", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> RefitProgress:
        """Signal the background loop to finish after the current batch and
        wait for it; re-raises an error the loop died on."""
        self._stop.set()
        return self.wait(timeout)

    def wait(self, timeout: float | None = None) -> RefitProgress:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("auto-refit loop did not stop in time")
        if self._error is not None:
            raise self._error
        return self.progress
