"""Versioned tuning profiles: the autotuner's output, the config's input.

Port of ``spark_languagedetector_tpu.exec.profile``, whole: the file format
is shared, so a profile written by either package loads in the other.

A :class:`TuningProfile` is the durable artifact ``exec.tune`` (either
package's) emits after replaying a telemetry capture — the measured
defaults that replace the hand-set ``LANGDETECT_*`` knob zoo for one
deployment. The runner loads it at startup through :mod:`.config` (point
``LANGDETECT_TUNING_PROFILE`` at the JSON file); explicit env/ctor values
still win, so a profile can never override an operator's pinned choice.

The file is plain JSON with a schema version so a profile written by one
release refuses to half-load in another:

    {
      "schema": 1,
      "version": "tp1-<content hash>",       # deterministic over `tuned`
      "created": <capture end unix ts>,      # from the capture, not wall
      "source": {...capture stats...},       # provenance, never re-read
      "constraints": {...solver knobs...},   # provenance, never re-read
      "tuned": {"length_buckets": [...], "batch_bytes": ..., ...}
    }

Only ``tuned`` keys listed in :data:`TUNED_FIELDS` are honored; unknown
keys fail validation loudly (a typo'd field silently falling back to the
default is exactly the failure mode this module exists to end).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field

SCHEMA_VERSION = 1

# Every field a profile may tune, with its validator: the JAX package's
# list, so its profiles validate here. Config resolution falls back to
# ``profile.tuned[knob]`` for the tunable knobs of exec.config.KNOBS, the
# serve_* and cache_* ones included (read by serve/batcher.py and
# serve/cache.py).
TUNED_FIELDS: dict[str, callable] = {}


def _tuned(name):
    def register(fn):
        TUNED_FIELDS[name] = fn
        return fn

    return register


@_tuned("length_buckets")
def _check_buckets(v):
    if (
        not isinstance(v, (list, tuple))
        or not 1 <= len(v) <= 64
        or not all(isinstance(x, int) and x > 0 for x in v)
        or list(v) != sorted(set(v))
    ):
        raise ValueError(
            "length_buckets must be a strictly increasing list of positive "
            f"ints, got {v!r}"
        )
    if any(x % 128 for x in v):
        raise ValueError(
            f"length_buckets must be multiples of 128 (lane tile / "
            f"ragged chunk alignment), got {v!r}"
        )
    return tuple(int(x) for x in v)


def _positive_int(name):
    def check(v):
        if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
            raise ValueError(f"{name} must be a positive int, got {v!r}")
        return v

    return check


def _positive_float(name):
    def check(v):
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
            raise ValueError(f"{name} must be a positive number, got {v!r}")
        return float(v)

    return check


TUNED_FIELDS["batch_bytes"] = _positive_int("batch_bytes")
TUNED_FIELDS["fit_batch_bytes"] = _positive_int("fit_batch_bytes")
TUNED_FIELDS["serve_max_rows"] = _positive_int("serve_max_rows")
TUNED_FIELDS["serve_queue_rows"] = _positive_int("serve_queue_rows")
TUNED_FIELDS["serve_max_wait_ms"] = _positive_float("serve_max_wait_ms")
TUNED_FIELDS["cache_rows"] = _positive_int("cache_rows")
TUNED_FIELDS["cache_bytes"] = _positive_int("cache_bytes")


@_tuned("device_encode")
def _check_device_encode(v):
    if not isinstance(v, bool):
        raise ValueError(f"device_encode must be a bool, got {v!r}")
    return v


@dataclass(frozen=True)
class TuningProfile:
    """One deployment's measured execution defaults (validated)."""

    tuned: dict
    source: dict = field(default_factory=dict)
    constraints: dict = field(default_factory=dict)
    created: float = 0.0
    version: str = ""

    def __post_init__(self):
        clean = {}
        for key, value in dict(self.tuned).items():
            check = TUNED_FIELDS.get(key)
            if check is None:
                raise ValueError(
                    f"unknown tuned field {key!r}; expected a subset of "
                    f"{sorted(TUNED_FIELDS)}"
                )
            clean[key] = check(value)
        object.__setattr__(self, "tuned", clean)
        if not self.version:
            object.__setattr__(self, "version", content_version(clean))

    def get(self, name: str):
        return self.tuned.get(name)

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "version": self.version,
            "created": self.created,
            "source": self.source,
            "constraints": self.constraints,
            "tuned": {
                k: (list(v) if isinstance(v, tuple) else v)
                for k, v in self.tuned.items()
            },
        }

    def save(self, path: str) -> str:
        """Write atomically (temp + rename) so a half-written profile can
        never be loaded at startup."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(path: str) -> "TuningProfile":
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
        if not isinstance(raw, dict):
            raise ValueError(f"tuning profile {path!r} is not a JSON object")
        schema = raw.get("schema")
        if schema != SCHEMA_VERSION:
            raise ValueError(
                f"tuning profile {path!r} has schema {schema!r}; this "
                f"build reads schema {SCHEMA_VERSION}"
            )
        tuned = raw.get("tuned")
        if not isinstance(tuned, dict) or not tuned:
            raise ValueError(
                f"tuning profile {path!r} carries no tuned fields"
            )
        return TuningProfile(
            tuned=tuned,
            source=raw.get("source") or {},
            constraints=raw.get("constraints") or {},
            created=float(raw.get("created") or 0.0),
            version=str(raw.get("version") or ""),
        )


def content_version(tuned: dict) -> str:
    """Deterministic profile id over the tuned values: two captures that
    solve to the same parameters produce the same version string, so
    rollout diffs are content diffs."""
    blob = json.dumps(
        {k: (list(v) if isinstance(v, tuple) else v) for k, v in tuned.items()},
        sort_keys=True,
    ).encode("utf-8")
    return "tp1-" + hashlib.sha256(blob).hexdigest()[:12]
