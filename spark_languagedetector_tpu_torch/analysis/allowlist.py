"""The checked-in suppression allowlist for the port's shipped tree.

Port of ``spark_languagedetector_tpu.analysis.allowlist``. Two kinds of
entry, each with its reason and a bounded ``count``: the logging
bootstrap read the JAX allowlist excuses too, and the XLA-only ``jax/*``
metric names of ``docs/OBSERVABILITY.md`` (the docs describe the JAX
package and are read as they are; the port's kernel builder counts
``compile_cache/*`` instead).

Each entry names one *live* exception to a contract rule, with the reason
it is genuinely exceptional — the audited alternative to deleting the
rule or sprinkling pragmas. Staleness is itself a violation: an entry
that no longer matches a real violation fails R5, so a fixed exception
must be removed from this list in the same change (docs/ANALYSIS.md §4).

Prefer fixing over listing. The bar for an entry: the read/emission is
*structurally* unable to go through the audited path (bootstrap ordering,
the module the audited path itself depends on), not merely inconvenient.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Allow:
    """One allowlist row: rule + file suffix + message substring.

    An entry suppresses at most ``count`` matching violations (default
    one): a *second* read of an allowlisted knob in the same file is a
    new regression, not part of the documented exception, and must
    surface instead of being quietly absorbed.
    """

    rule: str
    file: str  # suffix-matched against the violation's relative path
    match: str  # substring of the violation message
    reason: str
    count: int = 1  # max violations this entry may suppress


ALLOWLIST: tuple[Allow, ...] = (
    Allow(
        "R1", "utils/logging.py", "LANGDETECT_TPU_LOGLEVEL",
        "pre-config bootstrap: exec/config imports this module's logger, "
        "so the root level must be readable before the knob table can "
        "exist. config.py re-syncs the level through the audited table "
        "(sync_level_from_config) the moment it finishes importing, and "
        "/varz reports the knob's live value.",
    ),
    Allow(
        "R2", "docs/OBSERVABILITY.md", "metric 'jax/",
        "XLA-only names of the JAX package's compile and donation hooks "
        "(jax/compile_events, jax/compile_s, jax/compile_cache_hits, "
        "jax/compile_cache_misses, jax/donated_copy, jax/donated_reuse; "
        "eight mentions in the doc's metric tables). The port compiles no "
        "XLA program and donates no buffer, so it can never emit them; its "
        "kernel build cache counts compile_cache/hits, /misses and /build_s.",
        count=8,
    ),
)
