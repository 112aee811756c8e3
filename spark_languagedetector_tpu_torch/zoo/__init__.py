"""Multi-tenant model zoo: named tenants, bounded residency, isolation.

Port of ``spark_languagedetector_tpu.zoo``:

  * :class:`~.zoo.ModelZoo`: tenant → versioned registry and its own
    batcher, tenant-scoped installs, rollbacks and refits;
  * :class:`~.residency.ResidencyManager`: LRU page-out of the tenants'
    device tables under the ``LANGDETECT_ZOO_RESIDENT_BYTES`` /
    ``_MODELS`` budgets, never of a leased or busy tenant;
  * :class:`~.zoo.TenantQuota`: a tenant's own admission-queue knobs;
  * :class:`~.zoo.TenantLoadShed` / :class:`~.zoo.UnknownTenant`: the
    per-tenant failures (503 with Retry-After / 400).

Runners are built lazily, by each tenant's cold load.
"""

from __future__ import annotations

from .residency import ResidencyManager
from .zoo import (
    DEFAULT_TENANT,
    ModelZoo,
    TenantEntry,
    TenantLoadShed,
    TenantQuota,
    TenantRuntime,
    UnknownTenant,
    ZooError,
)

__all__ = [
    "DEFAULT_TENANT",
    "ModelZoo",
    "ResidencyManager",
    "TenantEntry",
    "TenantLoadShed",
    "TenantQuota",
    "TenantRuntime",
    "UnknownTenant",
    "ZooError",
]
