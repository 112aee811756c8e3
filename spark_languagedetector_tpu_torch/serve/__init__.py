"""Online serving: continuous batching, score cache, hot swap, HTTP.

Port of the serving core of ``spark_languagedetector_tpu.serve``; many
concurrent small requests go through the same runner (and its CUDA
kernels) as the offline transform:

  * :class:`~.batcher.ContinuousBatcher`: admission queue + coalescing
    dispatcher with priority lanes, per-request deadlines and SLO-aware
    load shedding;
  * :class:`~.cache.ScoreCache`: version-keyed LRU of per-document results;
  * :class:`~.registry.ModelRegistry`: versioned models with prewarmed
    zero-downtime hot swap and rollback;
  * :class:`~.server.ServingServer` / :class:`~.client.ServeClient`:
    stdlib JSON-over-HTTP front end and client, wire-compatible with the
    JAX package's.

The router, fleet, quarantine and model zoo are not ported yet.
"""

from __future__ import annotations

from .batcher import (
    BULK,
    INTERACTIVE,
    LANES,
    ContinuousBatcher,
    ServeClosed,
    ServeDeadlineExceeded,
    ServeError,
    ServeOverloaded,
    ServeResult,
)
from .cache import ScoreCache
from .client import ServeClient, ServeHTTPError
from .registry import ModelRegistry, ModelVersion, PreparedVersion
from .server import ServingServer

__all__ = [
    "BULK",
    "INTERACTIVE",
    "LANES",
    "ContinuousBatcher",
    "ModelRegistry",
    "ModelVersion",
    "PreparedVersion",
    "ScoreCache",
    "ServeClient",
    "ServeClosed",
    "ServeDeadlineExceeded",
    "ServeError",
    "ServeHTTPError",
    "ServeOverloaded",
    "ServeResult",
    "ServingServer",
]
