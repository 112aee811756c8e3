"""Multi-tenant model zoo: many profiles behind one serving front.

Port of ``spark_languagedetector_tpu.zoo.zoo``. The serving core below is
single-model (one registry, one batcher); the zoo routes each request to
its tenant's:

  * **Tenant routing.** Tenant name → versioned registry and a batcher of
    its own; ``runtime(None)`` is the default tenant, so a call without a
    tenant behaves as on a single-model server.
  * **Bounded residency.** A tenant pages in on first use (cold load: the
    registry's ``prepare``/``commit``, so build and prewarm run off the
    serving path) and the least recently used tenants page out under the
    ``zoo_resident_bytes`` / ``zoo_resident_models`` budgets
    (:mod:`.residency`). A tenant's cost is the bytes of its runner's
    device tables (:func:`_table_bytes`). A page-out drops the tenant's
    runner and device tables (and, for a clean tenant saved on disk, the
    host model too), never while its registry holds a lease or its batcher
    has queued or in-flight rows.
  * **Isolation.** Each tenant's batcher is its own admission queue with
    its own :class:`TenantQuota`: a noisy tenant's burst sheds that queue
    (``zoo/shed/<tenant>``), never a neighbour's. The shared score cache is
    partitioned by tenant. A runtime that is not the named tenant's is
    refused and counted (``zoo/cross_tenant_rejects``).
  * **Tenant-scoped refit.** :meth:`ModelZoo.auto_refit` gives
    ``AutoRefit`` an installer bound to one tenant.

A failed cold load (an injected ``zoo/load`` fault included) is
:class:`TenantLoadShed`: 503 with Retry-After for that tenant only. A cold
load maps the tenant's baked artifact when one exists
(``artifacts.maybe_load_baked``: no parquet parse, no membership rebuild)
and otherwise reads its saved directory with ``LanguageDetectorModel.load``.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass

from ..exec import config as exec_config
from ..resilience import faults
from ..serve.batcher import ContinuousBatcher, ServeClosed, ServeError, ServeOverloaded
from ..serve.registry import ModelRegistry
from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event
from .residency import ResidencyManager

_log = get_logger("zoo.zoo")

# Tenant names ride metric names (``zoo/shed/<tenant>``), cache scopes and
# log fields: the telemetry's lowercase segment grammar.
_TENANT_RE = re.compile(r"[a-z0-9_]{1,64}")
_VERSION_RE = re.compile(r"v(\d+)")

DEFAULT_TENANT = "default"


class ZooError(ServeError):
    """A model-zoo control-plane failure."""


class UnknownTenant(ZooError, ValueError):
    """The request named a tenant the zoo does not know: a ``ValueError``,
    so HTTP 400 and never retried."""


class TenantLoadShed(ServeOverloaded):
    """A tenant's cold load failed: that tenant's request is shed (503 with
    Retry-After) and every other tenant keeps serving."""

    def __init__(self, tenant: str, *, retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} cold load failed; retry shortly",
            reason="cold_load", retry_after_s=retry_after_s,
        )
        self.tenant = tenant


@dataclass(frozen=True)
class TenantQuota:
    """A tenant's admission-queue overrides (its quota lane); None falls
    through to the zoo-wide batcher knobs."""

    max_rows: int | None = None
    max_wait_ms: float | None = None
    max_queue_rows: int | None = None
    slo_ms: float | None = None

    def describe(self) -> dict:
        return {
            "max_rows": self.max_rows,
            "max_wait_ms": self.max_wait_ms,
            "max_queue_rows": self.max_queue_rows,
            "slo_ms": self.slo_ms,
        }


class TenantRuntime:
    """A resident tenant's serving half: registry, batcher, table bytes."""

    __slots__ = ("tenant", "registry", "batcher", "table_bytes", "loaded_at")

    def __init__(self, tenant, registry, batcher, table_bytes):
        self.tenant = tenant
        self.registry = registry
        self.batcher = batcher
        self.table_bytes = int(table_bytes)
        self.loaded_at = time.time()


class TenantEntry:
    """A registered tenant: its model and version, quota and, while
    resident, its runtime."""

    __slots__ = (
        "name", "model", "version", "seq", "source", "quota", "dirty", "loads", "runtime",
        "_load_lock",
    )

    def __init__(self, name, model, version, seq, source, quota):
        self.name = name
        self.model = model
        self.version = version
        self.seq = seq
        self.source = source
        self.quota = quota or TenantQuota()
        # An in-memory install (refit, swap by object) leaves the on-disk
        # source behind: the host model must then survive a page-out.
        self.dirty = source is None
        self.loads = 0
        self.runtime: TenantRuntime | None = None
        self._load_lock = threading.Lock()

    def describe(self) -> dict:
        rt = self.runtime
        return {
            "tenant": self.name,
            "version": self.version,
            "resident": rt is not None,
            "loads": self.loads,
            "source": self.source,
            "dirty": self.dirty,
            "table_bytes": rt.table_bytes if rt is not None else None,
            "quota": self.quota.describe(),
        }


def _table_bytes(runner) -> int:
    """A tenant's resident cost: the bytes of every device table tensor its
    runner holds (``BatchRunner.device_tables``: the weight table in its
    stored dtype and scales, the LUT or cuckoo entries, the bigram and
    histogram operands), each storage counted once."""
    storages = {}
    for t in runner.device_tables():
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


class _TenantInstaller:
    """The registry surface ``AutoRefit`` needs, bound to one tenant: every
    refit goes through :meth:`ModelZoo.install` for that tenant only, across
    any page-out and reload."""

    def __init__(self, zoo: "ModelZoo", tenant: str):
        self._zoo = zoo
        self._tenant = tenant

    def install(self, model, **kw) -> str:
        return self._zoo.install(self._tenant, model, **kw)


class ModelZoo:
    """Named tenants in front of the serving core.

    ``device``: where tenants loaded from a directory go (None: the CUDA
    card). ``batcher_kw`` are the zoo-wide batcher knobs (a tenant's
    :class:`TenantQuota` overrides them). One score cache serves all
    tenants, partitioned by tenant.
    """

    def __init__(
        self,
        *,
        default_tenant: str = DEFAULT_TENANT,
        resident_bytes: int | None = None,
        resident_models: int | None = None,
        device: str | None = None,
        prewarm: bool = True,
        cache=None,
        cache_enable: bool | None = None,
        retry_after_s: float = 0.25,
        drain_timeout_s: float = 5.0,
        **batcher_kw,
    ):
        self.default_tenant = self._valid_name(default_tenant)
        self.device = device
        self.prewarm = prewarm
        self.retry_after_s = float(retry_after_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._batcher_kw = dict(batcher_kw)
        if cache is None and bool(exec_config.resolve("cache_enable", cache_enable)):
            from ..serve.cache import ScoreCache

            cache = ScoreCache()
        self.cache = cache
        self._entries: dict[str, TenantEntry] = {}
        self._residency = ResidencyManager(max_bytes=resident_bytes, max_models=resident_models)
        self._lock = threading.Lock()
        # Runtimes detached by an eviction, drained and torn down after the
        # control-plane lock drops, so a page-out never stalls routing.
        self._evicting: list[TenantRuntime] = []
        self._closed = False
        log_event(
            _log, "zoo.start", default_tenant=self.default_tenant,
            max_bytes=self._residency.max_bytes, max_models=self._residency.max_models,
        )

    # ------------------------------------------------------- registration ---
    @staticmethod
    def _valid_name(name) -> str:
        if not isinstance(name, str) or not _TENANT_RE.fullmatch(name):
            raise UnknownTenant(f"tenant names are [a-z0-9_]{{1,64}}, got {name!r}")
        return name

    def add_tenant(self, name: str, model=None, *, path: str | None = None,
                   version: str = "v1", quota: TenantQuota | None = None,
                   resident: bool = False) -> TenantEntry:
        """Register a tenant from a fitted model or a saved directory (a
        ``path`` tenant pages out fully, host model included). Nothing is
        built before its first request, or now with ``resident=True``."""
        name = self._valid_name(name)
        if (model is None) == (path is None):
            raise ValueError("pass exactly one of model or path")
        m = _VERSION_RE.fullmatch(version)
        entry = TenantEntry(name, model, version, int(m.group(1)) if m else 1, path, quota)
        with self._lock:
            if self._closed:
                raise ZooError("model zoo is closed")
            if name in self._entries:
                raise ValueError(f"tenant {name!r} already registered")
            self._entries[name] = entry
        REGISTRY.incr("zoo/tenants_added")
        log_event(_log, "zoo.tenant_added", tenant=name, version=version, source=path,
                  resident=resident)
        if resident:
            self._load(entry)
        return entry

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def version(self, tenant: str | None = None) -> str:
        return self._entry(tenant).version

    def _entry(self, tenant: str | None) -> TenantEntry:
        name = self.default_tenant if tenant is None else tenant
        if not isinstance(name, str):
            raise UnknownTenant(f'"tenant" must be a string, got {name!r}')
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise UnknownTenant(f"unknown tenant {name!r}")
        return entry

    # ------------------------------------------------------------ routing ---
    def runtime(self, tenant: str | None = None) -> tuple[TenantEntry, TenantRuntime]:
        """The live runtime of a request's tenant (None: the default),
        cold-loaded if paged out. It is the named tenant's or refused."""
        entry = self._entry(tenant)
        with self._lock:
            rt = entry.runtime
            if rt is not None:
                self._guard_tenant(entry, rt)
                self._residency.touch(entry.name)
                return entry, rt
        return entry, self._load(entry)

    @staticmethod
    def _guard_tenant(entry: TenantEntry, rt: TenantRuntime) -> None:
        if rt.tenant != entry.name:
            REGISTRY.incr("zoo/cross_tenant_rejects")
            log_event(_log, "zoo.cross_tenant_reject", tenant=entry.name, runtime=rt.tenant)
            raise ZooError(
                f"tenant {entry.name!r} resolved runtime {rt.tenant!r}; rejecting rather "
                "than answering from the wrong tenant"
            )

    # ---------------------------------------------------------- cold load ---
    def _load(self, entry: TenantEntry) -> TenantRuntime:
        with entry._load_lock:
            return self._load_locked(entry)

    def _load_locked(self, entry: TenantEntry) -> TenantRuntime:
        """Page one tenant in (caller holds its load lock): build and
        prewarm its runner off the serving path, publish the runtime, then
        page out tenants over budget."""
        with self._lock:
            if self._closed:
                # ServeClosed: a request racing shutdown gets the retryable
                # 503 of the rest of the serving stack.
                raise ServeClosed("model zoo is closed")
            rt = entry.runtime
            if rt is not None:  # another caller loaded it
                self._guard_tenant(entry, rt)
                self._residency.touch(entry.name)
                return rt
        t0 = time.perf_counter()
        try:
            faults.inject("zoo/load")
            model = entry.model
            if model is None:
                from ..artifacts.bake import maybe_load_baked

                model = maybe_load_baked(entry.source, device=self.device)
            if model is None:
                from ..models.estimator import LanguageDetectorModel

                model = LanguageDetectorModel.load(entry.source, device=self.device)
            registry = ModelRegistry(device=self.device, drain_timeout_s=self.drain_timeout_s)
            prepared = registry.prepare(
                model, version=entry.version, prewarm=self.prewarm, source=entry.source,
                metadata={"tenant": entry.name},
            )
            registry.commit(prepared)
        except Exception as e:
            REGISTRY.incr("zoo/load_errors")
            log_event(_log, "zoo.load_failed", tenant=entry.name, error=repr(e))
            raise TenantLoadShed(entry.name, retry_after_s=self.retry_after_s) from e
        rt = TenantRuntime(entry.name, registry, self._make_batcher(entry, registry),
                           _table_bytes(prepared.runner))
        with self._lock:
            entry.model = model
            entry.runtime = rt
            entry.loads += 1
            evicted = self._residency.admit(
                entry.name, rt.table_bytes, evictable=self._evictable_locked,
                evict=self._evict_locked,
            )
        self._finish_evictions()
        REGISTRY.incr("zoo/cold_loads")
        REGISTRY.observe("zoo/cold_load_s", time.perf_counter() - t0)
        log_event(
            _log, "zoo.cold_load", tenant=entry.name, version=entry.version,
            loads=entry.loads, table_bytes=rt.table_bytes, evicted=evicted,
            wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
        )
        return rt

    def _make_batcher(self, entry: TenantEntry, registry) -> ContinuousBatcher:
        kw = dict(self._batcher_kw)
        q = entry.quota
        for knob, value in (("max_rows", q.max_rows), ("max_wait_ms", q.max_wait_ms),
                            ("max_queue_rows", q.max_queue_rows), ("slo_ms", q.slo_ms)):
            if value is not None:
                kw[knob] = value
        # The shared cache goes in explicitly (tenant-scoped keys);
        # cache_enable=False keeps a cache-less zoo from growing one cache
        # per tenant.
        return ContinuousBatcher(registry, cache=self.cache, cache_enable=False,
                                 tenant=entry.name, name=f"zoo-{entry.name}", **kw)

    # ------------------------------------------------------------ paging ----
    def _evictable_locked(self, name: str) -> bool:
        entry = self._entries.get(name)
        rt = entry.runtime if entry is not None else None
        if rt is None:
            return False
        stats = rt.batcher.stats()
        if stats["queued_rows"] or stats["inflight_rows"]:
            return False
        return not rt.registry.busy()

    def _evict_locked(self, name: str) -> None:
        """Detach one tenant under the control-plane lock (pointer work
        only); :meth:`_finish_evictions` drains its batcher and gives back
        its runner after the lock drops."""
        entry = self._entries[name]
        rt, entry.runtime = entry.runtime, None
        if rt is None:
            return
        self._evicting.append(rt)
        if entry.source is not None and not entry.dirty:
            entry.model = None  # clean and on disk: page out fully

    def _finish_evictions(self) -> None:
        """Drain and tear down detached runtimes outside the zoo lock. The
        drain answers an admission that raced the detach; then the
        registry gives back its runner holds, and the device tables go when
        nothing else references them."""
        while True:
            with self._lock:
                if not self._evicting:
                    return
                rt = self._evicting.pop()
            rt.batcher.close(drain=True)
            rt.registry.close()

    def preload(self, tenants=None) -> list[str]:
        """Make the named tenants (default: all) resident ahead of traffic."""
        loaded = []
        for name in list(tenants) if tenants is not None else self.tenants():
            entry = self._entry(name)
            if entry.runtime is None:
                self._load(entry)
                loaded.append(name)
        return loaded

    def resident(self) -> dict[str, int]:
        with self._lock:
            return self._residency.resident()

    # ----------------------------------------------------------- installs ---
    def install(self, tenant: str | None, model, *, version: str | None = None,
                prewarm: bool | None = None, source: str | None = None,
                from_path: str | None = None, metadata: dict | None = None) -> str:
        """Install ``model`` as a tenant's new serving version: a resident
        tenant flips through its registry, a paged-out one loads the new
        version at its next cold load. No other tenant moves. ``from_path``
        says the model is that saved directory's (the tenant may page out
        fully); an in-memory install clears the tenant's source."""
        entry = self._entry(tenant)
        with entry._load_lock:
            seq = entry.seq + 1
            vname = version or f"v{seq}"
            meta = dict(metadata or {})
            meta.setdefault("tenant", entry.name)
            with self._lock:
                rt = entry.runtime
            if rt is not None:
                # The registry counts as busy while it swaps, so no page-out
                # lands under the swap; one that came first closed it, and
                # the tenant's next cold load serves the new version.
                try:
                    vname = rt.registry.install(
                        model, version=vname,
                        prewarm=self.prewarm if prewarm is None else prewarm,
                        source=source, metadata=meta,
                    )
                except ServeClosed:
                    rt = None
            with self._lock:
                entry.model = model
                entry.version = vname
                entry.source = from_path
                entry.dirty = from_path is None
                m = _VERSION_RE.fullmatch(vname)
                entry.seq = max(entry.seq, int(m.group(1))) if m else seq
                if rt is not None and entry.runtime is rt:
                    rt.table_bytes = _table_bytes(rt.registry.peek().runner)
                    self._residency.admit(
                        entry.name, rt.table_bytes, evictable=self._evictable_locked,
                        evict=self._evict_locked,
                    )
            self._finish_evictions()
        REGISTRY.incr("zoo/installs")
        log_event(_log, "zoo.install", tenant=entry.name, version=vname,
                  resident=rt is not None, source=source)
        return vname

    def load(self, tenant: str | None, path: str, *, version: str | None = None) -> str:
        """Install a saved directory as a tenant's new version (the zoo's
        ``/admin/swap``)."""
        from ..models.estimator import LanguageDetectorModel

        return self.install(
            tenant, LanguageDetectorModel.load(path, device=self.device), version=version,
            source=str(path), from_path=str(path),
        )

    def rollback(self, tenant: str | None = None) -> str:
        """A tenant's rollback through its registry (loading it if paged
        out: history does not survive a page-out). The tenant's paged state
        follows what the registry serves, so a page-out right after reloads
        the rolled-back model."""
        entry = self._entry(tenant)
        with entry._load_lock:
            with self._lock:
                rt = entry.runtime
            if rt is None:
                rt = self._load_locked(entry)
            version = rt.registry.rollback()
            served = rt.registry.peek()
            with self._lock:
                entry.version = version
                entry.model = served.model
                entry.source = None
                entry.dirty = True
                m = _VERSION_RE.fullmatch(version)
                if m:
                    entry.seq = max(entry.seq, int(m.group(1)))
        return version

    def auto_refit(self, tenant: str | None, estimator, **kw):
        """An :class:`~..stream.refit.AutoRefit` bound to one tenant: each of
        its refits installs into that tenant only."""
        from ..stream.refit import AutoRefit

        entry = self._entry(tenant)
        kw.setdefault("source_name", f"auto-refit:{entry.name}")
        return AutoRefit(estimator, _TenantInstaller(self, entry.name), tenant=entry.name, **kw)

    # ------------------------------------------------------------- status ---
    def healthz(self) -> dict:
        with self._lock:
            entries = list(self._entries.values())
            residency = self._residency.describe()
        tenants = {}
        for entry in entries:
            block = entry.describe()
            rt = entry.runtime
            block["batcher"] = rt.batcher.stats() if rt is not None else None
            tenants[entry.name] = block
        return {"default_tenant": self.default_tenant, "tenants": tenants,
                "residency": residency}

    def varz(self) -> dict:
        out = self.healthz()
        out["cache"] = None if self.cache is None else self.cache.stats()
        for name, block in out["tenants"].items():
            entry = self._entries.get(name)
            rt = entry.runtime if entry is not None else None
            block["versions"] = rt.registry.versions() if rt is not None else None
        return out

    # ---------------------------------------------------------- lifecycle ---
    def close(self, drain: bool = True) -> None:
        """Tear down every resident tenant: with ``drain`` no accepted
        request is dropped; without, queued requests fail with 503."""
        with self._lock:
            self._closed = True
            names = list(self._entries)
        for name in names:
            entry = self._entries[name]
            with entry._load_lock:
                with self._lock:
                    rt, entry.runtime = entry.runtime, None
                    self._residency.drop(name)
                if rt is not None:
                    rt.batcher.close(drain=drain)
                    rt.registry.close()
        log_event(_log, "zoo.close", tenants=len(names), drained=drain)
