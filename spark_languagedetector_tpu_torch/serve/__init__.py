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
    JAX package's (a server may front a :class:`~..zoo.ModelZoo`);
  * :class:`~.router.FleetRouter` / :class:`~.router.RouterServer`: the
    health-checked router over replicas (failover, ejection, hedging,
    retry budget), and :class:`~.quarantine.QuarantineTable`, its
    query-of-death memory;
  * :class:`~.fleet.ServeFleet` / :class:`~.fleet.ServeReplica`: N
    in-process replicas behind a router, with the two-phase fleet swap.
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
from .fleet import ServeFleet, ServeReplica
from .quarantine import QuarantineTable, QueryQuarantined, signature_of
from .registry import ModelRegistry, ModelVersion, PreparedVersion
from .router import FleetRouter, FleetSaturated, FleetSwapError, NoReadyReplica, RouterServer
from .server import ServingServer

__all__ = [
    "BULK",
    "INTERACTIVE",
    "LANES",
    "ContinuousBatcher",
    "FleetRouter",
    "FleetSaturated",
    "FleetSwapError",
    "ModelRegistry",
    "ModelVersion",
    "NoReadyReplica",
    "PreparedVersion",
    "QuarantineTable",
    "QueryQuarantined",
    "RouterServer",
    "ScoreCache",
    "ServeClient",
    "ServeClosed",
    "ServeDeadlineExceeded",
    "ServeError",
    "ServeFleet",
    "ServeHTTPError",
    "ServeOverloaded",
    "ServeReplica",
    "ServeResult",
    "ServingServer",
    "signature_of",
]
