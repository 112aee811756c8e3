"""Elastic fleet: process replicas and telemetry-driven autoscaling.

Port of ``spark_languagedetector_tpu.scale``:

  * :mod:`.replica`: :class:`ProcessReplica`, a serving replica in its own
    OS process (its own model load, its card through
    ``CUDA_VISIBLE_DEVICES``, its own :class:`~..serve.server.
    ServingServer`), and :class:`ReplicaSupervisor`, which spawns, watches,
    restarts with backoff and reaps them.
  * :mod:`.autoscaler`: the control loop: arrival-rate EMA, queue depth,
    sheds and estimated-wait pressure in, replica count out, with
    hysteresis.
  * :mod:`.elastic`: :class:`ElasticFleet`, the supervisor and the
    dynamic-membership :class:`~..serve.router.FleetRouter` together, so
    routing, failover, ejection and re-admission work unchanged on a
    changing replica set.

Every replica runs the same kernels at every fleet size, so scaling is
control plane only: process lifecycle and router membership.
"""

from .autoscaler import Autoscaler, ScaleSignals
from .elastic import ElasticFleet
from .replica import ProcessReplica, ReplicaSupervisor, SpawnError

__all__ = [
    "Autoscaler",
    "ElasticFleet",
    "ProcessReplica",
    "ReplicaSupervisor",
    "ScaleSignals",
    "SpawnError",
]
