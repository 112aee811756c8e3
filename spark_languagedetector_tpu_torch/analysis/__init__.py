"""Static contract checker: prove the port's string-keyed contracts.

Port of ``spark_languagedetector_tpu.analysis``, pointed at this package:
every ``LANGDETECT_*`` knob resolves through :mod:`..exec.config`'s audited
table, every counter name :mod:`..telemetry.compare` and :mod:`..exec.tune`
consume is emitted somewhere, every ``faults.inject(site)`` literal is a row
in :data:`..resilience.faults.SITES`, and the doc tables (``docs/*.md`` and
``README.md``, read as they are) describe what the code does::

    python -m spark_languagedetector_tpu_torch.analysis.check [--json] [--root DIR]

No jax import, no device work: the checker parses the modules it audits,
never imports them (:mod:`.harvest`), and applies the rule families
(:mod:`.rules`):

  * **R1 knob discipline** — env reads of ``LANGDETECT_*`` outside
    ``exec/config.py``; knob literals without a ``KNOBS`` row; knobs the
    OBSERVABILITY.md env table doesn't cover.
  * **R2 telemetry name contract** — names ``telemetry/compare`` /
    ``exec/tune`` (and the fleet aggregate and SLO tables) consume but
    nothing emits; emitted names that break the ``area/name`` grammar;
    doc'd metrics nothing emits.
  * **R3 fault-site registry** — ``inject()`` literals vs ``SITES`` vs
    RESILIENCE.md §4, all three ways.
  * **R5 suppression audit** — ``# contract: ignore[R?] -- reason``
    pragmas and the checked-in :mod:`.allowlist`; stale suppressions are
    themselves violations.

R4 (trace purity) has no counterpart: the port traces nothing (see
:mod:`.rules`).
"""

from .check import Violation, run_checks  # noqa: F401
