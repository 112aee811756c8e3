"""Version-keyed content-addressed score cache in front of the serving runner.

Port of ``spark_languagedetector_tpu.serve.cache``. The runner's in-flight
dedup removes duplicate rows *within* one call; this cache removes them
*across* dispatches and requests: a bounded, sharded LRU keyed by
``(model version scope, result mode, score encoding, document bytes)``.
The batcher consults it per document under the registry lease it already
holds, so every answer, cached or computed, comes from exactly the leased
version:

  * **Parity**: a hit returns the stored result of the *same* version, bit
    for bit.
  * **Staleness** is impossible by construction: the version in the key is
    the leased entry's, and a hot swap moves the pointer *between* leases,
    so a post-swap dispatch can only read and write the new version's
    keys; the old entries age out of the LRU.
  * **Keys are the bytes themselves** (dict hashing + equality), so a
    "collision" is a true content match.

Bounded by entries (``LANGDETECT_CACHE_ROWS``) and bytes
(``LANGDETECT_CACHE_BYTES``, keys plus stored results), both resolved
through ``exec.config``. Sharded to keep lock hold times short under
concurrent front-end threads.

Chaos: every lookup and store passes the ``serve/cache`` fault site. An
injected failure degrades that operation to a miss (or skips the store),
never to a wrong answer.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from ..exec import config as exec_config
from ..resilience import faults
from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("serve.cache")

# Fixed per-entry accounting overhead (key tuple, OrderedDict node, numpy
# header) so a cache of tiny documents cannot grow unaccounted.
ENTRY_OVERHEAD_BYTES = 128


class ScoreCache:
    """Bounded, sharded, version-keyed LRU over per-document results.

    ``get``/``put`` take the leased version scope, the result mode
    (``"labels"`` / ``"scores"`` / a segment mode string), the runner's
    ``score_encoding`` and the raw document bytes; values are numpy
    results (an ``[L]`` float32 score row, a 0-d int32 argmax id, or a
    segment result's JSON bytes). Thread-safe; eviction is LRU per shard
    under the global row and byte bounds split evenly across shards.
    """

    def __init__(
        self,
        *,
        max_rows: int | None = None,
        max_bytes: int | None = None,
        shards: int = 8,
    ):
        self.max_rows = int(exec_config.resolve("cache_rows", max_rows))
        self.max_bytes = int(exec_config.resolve("cache_bytes", max_bytes))
        if self.max_rows < 1 or self.max_bytes < 1:
            raise ValueError("cache_rows and cache_bytes must be >= 1")
        n = max(1, int(shards))
        self._shards: list[OrderedDict] = [OrderedDict() for _ in range(n)]
        self._locks = [threading.Lock() for _ in range(n)]
        self._bytes = [0] * n
        self._shard_rows = max(1, self.max_rows // n)
        self._shard_bytes = max(1, self.max_bytes // n)
        # Lifetime tallies for stats(), per shard so every update happens
        # under the lock it already holds.
        self._hits = [0] * n
        self._misses = [0] * n
        self._evictions = [0] * n
        log_event(
            _log, "serve.cache.start", max_rows=self.max_rows,
            max_bytes=self.max_bytes, shards=n,
        )

    def _shard_of(self, key) -> int:
        return hash(key) % len(self._shards)

    def _gauges(self) -> None:
        REGISTRY.set_gauge("langdetect_cache_rows", float(self.rows))
        REGISTRY.set_gauge("langdetect_cache_bytes", float(self.bytes))

    @property
    def rows(self) -> int:
        return sum(len(s) for s in self._shards)

    @property
    def bytes(self) -> int:
        return sum(self._bytes)

    # ------------------------------------------------------------- lookup ---
    def get(self, version: str, mode: str, encoding: str, doc: bytes):
        """The cached result for ``doc`` under ``version``, or None. A hit
        refreshes LRU order; an injected ``serve/cache`` fault reads as a
        miss."""
        return self.get_many(version, mode, encoding, (doc,))[0]

    def get_many(self, version: str, mode: str, encoding: str, docs) -> list:
        """Batched :meth:`get`: one registry update per counter per call.
        Fault injection stays per document, so the ``serve/cache`` replay
        schedule equals a loop of ``get``."""
        out = []
        hits = misses = faulted = saved = 0
        for doc in docs:
            try:
                faults.inject("serve/cache")
            except faults.InjectedFault:
                faulted += 1
                misses += 1
                with self._locks[0]:
                    self._misses[0] += 1
                out.append(None)
                continue
            key = (version, mode, encoding, doc)
            i = self._shard_of(key)
            with self._locks[i]:
                shard = self._shards[i]
                hit = shard.get(key)
                if hit is None:
                    self._misses[i] += 1
                else:
                    shard.move_to_end(key)
                    self._hits[i] += 1
            if hit is None:
                misses += 1
                out.append(None)
            else:
                hits += 1
                saved += len(doc)
                out.append(hit[0])
        if faulted:
            REGISTRY.incr("cache/faults", faulted)
        if out:
            REGISTRY.incr("cache/lookups", len(out))
        if misses:
            REGISTRY.incr("cache/misses", misses)
        if hits:
            REGISTRY.incr("cache/hits", hits)
            REGISTRY.incr("cache/bytes_saved", saved)
        return out

    # -------------------------------------------------------------- store ---
    def put(self, version: str, mode: str, encoding: str, doc: bytes, value) -> None:
        """Store one document's result. An entry larger than a shard is
        refused rather than flushing the shard; injected faults skip the
        store."""
        self.put_many(version, mode, encoding, (doc,), (value,))

    def put_many(self, version: str, mode: str, encoding: str, docs, values) -> None:
        """Batched :meth:`put`: the eviction counter and the occupancy
        gauges update once per call. Fault injection stays per document."""
        evicted = 0
        for doc, value in zip(docs, values):
            try:
                faults.inject("serve/cache")
            except faults.InjectedFault:
                REGISTRY.incr("cache/faults")
                continue
            # A copy (a view would pin the dispatch's whole [B, L] result),
            # read-only (get hands back the stored array itself).
            value = np.array(value)
            value.setflags(write=False)
            cost = len(doc) + int(value.nbytes) + ENTRY_OVERHEAD_BYTES
            if cost > self._shard_bytes:
                continue
            key = (version, mode, encoding, doc)
            i = self._shard_of(key)
            with self._locks[i]:
                shard = self._shards[i]
                old = shard.pop(key, None)
                if old is not None:
                    self._bytes[i] -= old[1]
                shard[key] = (value, cost)
                self._bytes[i] += cost
                dropped = 0
                while len(shard) > self._shard_rows or (
                    self._bytes[i] > self._shard_bytes and shard
                ):
                    _, (_, old_cost) = shard.popitem(last=False)
                    self._bytes[i] -= old_cost
                    dropped += 1
                self._evictions[i] += dropped
            evicted += dropped
        if evicted:
            REGISTRY.incr("cache/evictions", evicted)
        self._gauges()

    # -------------------------------------------------------------- admin ---
    def stats(self) -> dict:
        """Point-in-time snapshot for /varz and /healthz."""
        hits, misses = sum(self._hits), sum(self._misses)
        lookups = hits + misses
        return {
            "rows": self.rows,
            "bytes": self.bytes,
            "max_rows": self.max_rows,
            "max_bytes": self.max_bytes,
            "hits": hits,
            "misses": misses,
            "evictions": sum(self._evictions),
            "hit_rate": round(hits / lookups, 6) if lookups else 0.0,
        }
