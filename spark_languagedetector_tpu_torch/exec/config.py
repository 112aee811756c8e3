"""One audited config module for every ``LANGDETECT_*`` knob.

Port of ``spark_languagedetector_tpu.exec.config``. The table holds the
knobs a module of the port reads, under the JAX package's names, env
spellings, types and defaults, so one environment configures both packages
alike; ``parallel.distributed.initialize`` reads the multi-process ones.

Every knob resolves here, once, with type validation and a single
precedence rule:

    explicit ctor/param value  >  env var  >  tuning profile  >  default

The tuning profile (:mod:`.profile`, pointed at by
``LANGDETECT_TUNING_PROFILE``) supplies *measured* defaults for the knobs
marked tunable; the deprecation table below names the hand-set knobs it
supersedes. An env var still wins over a profile value (operators pin what
must not drift), and :func:`effective_config` reports every knob, its value
and where the value came from.

Resolution is cheap (one dict lookup + env read per knob) and un-cached on
purpose: tests flip env vars and expect the next construction to see them.
Only the profile file read is cached (per path + mtime);
:func:`reload_profile` drops the cache.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..ops.encoding import DEFAULT_LENGTH_BUCKETS
from ..utils.logging import get_logger, log_event
from .profile import TuningProfile

_log = get_logger("exec.config")

PROFILE_ENV = "LANGDETECT_TUNING_PROFILE"


@dataclass(frozen=True)
class Knob:
    """One config knob: canonical name, env spelling, type, default."""

    name: str
    env: str | None
    kind: str  # 'int' | 'float' | 'bool' | 'str' | 'int_tuple'
    default: object
    help: str
    # Resolvable from the active tuning profile's `tuned` dict (same name).
    tunable: bool = False
    positive: bool = False


def _knobs(*knobs: Knob) -> dict[str, Knob]:
    table = {}
    for k in knobs:
        if k.name in table:
            raise ValueError(f"duplicate knob {k.name}")
        table[k.name] = k
    return table


# One row per env var: the authority on names, types and defaults. The
# modules that read a knob resolve it through here.
KNOBS: dict[str, Knob] = _knobs(
    # --- execution core (tunable: a tuning profile may set these) --------
    Knob("length_buckets", "LANGDETECT_LENGTH_BUCKETS", "int_tuple",
         DEFAULT_LENGTH_BUCKETS,
         "padded-length bucket lattice (comma-separated, ascending, "
         "multiples of 128)", tunable=True),
    Knob("batch_bytes", "LANGDETECT_BATCH_BYTES", "int", 8 << 20,
         "byte budget per scoring micro-batch transfer", tunable=True,
         positive=True),
    Knob("fit_batch_bytes", "LANGDETECT_FIT_BATCH_BYTES", "int", 8 << 20,
         "byte budget per fit micro-batch transfer", tunable=True,
         positive=True),
    Knob("fit_batch_rows", "LANGDETECT_FIT_BATCH_ROWS", "int", None,
         "fixed fit micro-batch rows (unset: adaptive under the byte "
         "budget)", positive=True),
    Knob("dispatch_workers", "LANGDETECT_DISPATCH_WORKERS", "int", None,
         "concurrent dispatch threads for the batch path (unset: 1)",
         positive=True),
    Knob("stream_prefetch", "LANGDETECT_STREAM_PREFETCH", "int", 0,
         "streaming batches transformed ahead of the sink"),
    Knob("stream_workers", "LANGDETECT_STREAM_WORKERS", "int", None,
         "streaming transform concurrency (unset: min(2, prefetch))",
         positive=True),
    Knob("pack_threads", "LANGDETECT_PACK_THREADS", "int", None,
         "native packer thread count (unset: auto)", positive=True),
    Knob("device_encode", "LANGDETECT_DEVICE_ENCODE", "bool", False,
         "device-side batch encode: ship raw bytes + int32 offsets and "
         "rebuild the padded batch on the device instead of host-packing",
         tunable=True),
    # --- redundancy elimination -------------------------------------------
    Knob("dedup", "LANGDETECT_DEDUP", "bool", True,
         "in-flight content dedup: unique rows are copied and scored, "
         "duplicates scatter back from the fetched result"),
    # --- resilience -------------------------------------------------------
    Knob("retry_max_attempts", "LANGDETECT_RETRY_MAX_ATTEMPTS", "int", 2,
         "retry attempts incl. the first try"),
    Knob("retry_base_delay_s", "LANGDETECT_RETRY_BASE_DELAY_S", "float",
         0.05, "first backoff delay"),
    Knob("retry_max_delay_s", "LANGDETECT_RETRY_MAX_DELAY_S", "float", 2.0,
         "backoff ceiling"),
    Knob("retry_multiplier", "LANGDETECT_RETRY_MULTIPLIER", "float", 2.0,
         "backoff growth factor"),
    Knob("retry_jitter", "LANGDETECT_RETRY_JITTER", "float", 0.5,
         "downward jitter fraction per delay"),
    Knob("retry_seed", "LANGDETECT_RETRY_SEED", "int", 0,
         "deterministic jitter seed"),
    Knob("retry_attempt_deadline_s", "LANGDETECT_RETRY_ATTEMPT_DEADLINE_S",
         "float", None, "post-hoc per-attempt deadline"),
    Knob("breaker_threshold", "LANGDETECT_BREAKER_THRESHOLD", "int", 5,
         "consecutive retryable failures that open the breaker"),
    Knob("breaker_cooldown_s", "LANGDETECT_BREAKER_COOLDOWN_S", "float",
         5.0, "open -> half-open cooldown"),
    Knob("breaker_probes", "LANGDETECT_BREAKER_PROBES", "int", 1,
         "half-open probe successes required to close"),
    Knob("degraded", "LANGDETECT_DEGRADED", "bool", True,
         "degraded-ladder fallback on retryable exhaustion"),
    Knob("fault_plan", "LANGDETECT_FAULT_PLAN", "str", None,
         "chaos fault plan spec (tests/drills only)"),
    # --- serve score cache -------------------------------------------------
    Knob("cache_enable", "LANGDETECT_CACHE_ENABLE", "bool", True,
         "version-keyed serve score cache in front of the runner"),
    Knob("cache_rows", "LANGDETECT_CACHE_ROWS", "int", 1 << 16,
         "serve cache entry bound (documents)", tunable=True,
         positive=True),
    Knob("cache_bytes", "LANGDETECT_CACHE_BYTES", "int", 64 << 20,
         "serve cache byte bound (keys + stored results)", tunable=True,
         positive=True),
    # --- serving (tunable: flush window + shape bounds) -------------------
    Knob("serve_max_wait_ms", "LANGDETECT_SERVE_MAX_WAIT_MS", "float", 10.0,
         "serve coalescing window: max ms the oldest queued request "
         "waits before a flush", tunable=True, positive=True),
    Knob("serve_max_rows", "LANGDETECT_SERVE_MAX_ROWS", "int", 256,
         "serve coalescing bound: rows per dispatched batch",
         tunable=True, positive=True),
    Knob("serve_queue_rows", "LANGDETECT_SERVE_QUEUE_ROWS", "int", 4096,
         "serve admission bound: queued rows before shedding",
         tunable=True, positive=True),
    Knob("serve_slo_ms", "LANGDETECT_SERVE_SLO_MS", "float", 0.0,
         "estimated-wait shed threshold (0: off)"),
    # --- model zoo (multi-tenant serving: zoo/) --------------------------
    Knob("zoo_resident_bytes", "LANGDETECT_ZOO_RESIDENT_BYTES", "int", None,
         "resident weight-table byte budget for the model zoo (unset: "
         "unlimited)", positive=True),
    Knob("zoo_resident_models", "LANGDETECT_ZOO_RESIDENT_MODELS", "int", None,
         "resident model bound for the model zoo (unset: unlimited)",
         positive=True),
    # --- fleet (replicated serving: router + replicas) --------------------
    Knob("fleet_replicas", "LANGDETECT_FLEET_REPLICAS", "int", 3,
         "serve replicas behind the fleet router", positive=True),
    Knob("fleet_probe_interval_ms", "LANGDETECT_FLEET_PROBE_INTERVAL_MS",
         "float", 100.0, "router health-probe period per round",
         positive=True),
    Knob("fleet_probe_timeout_s", "LANGDETECT_FLEET_PROBE_TIMEOUT_S",
         "float", 2.0, "liveness/readiness probe HTTP timeout",
         positive=True),
    Knob("fleet_dispatch_attempts", "LANGDETECT_FLEET_DISPATCH_ATTEMPTS",
         "int", 3, "distinct replicas tried per request before the fleet "
         "sheds", positive=True),
    Knob("fleet_breaker_threshold", "LANGDETECT_FLEET_BREAKER_THRESHOLD",
         "int", 3, "consecutive probe/dispatch failures that eject a "
         "replica", positive=True),
    Knob("fleet_breaker_cooldown_s", "LANGDETECT_FLEET_BREAKER_COOLDOWN_S",
         "float", 1.0, "ejection -> half-open re-probe cooldown",
         positive=True),
    Knob("fleet_drain_timeout_s", "LANGDETECT_FLEET_DRAIN_TIMEOUT_S",
         "float", 10.0, "per-replica drain bound during the two-phase "
         "fleet swap", positive=True),
    # --- storm defense (retry budget, hedging, quarantine) ---------------
    Knob("fleet_deadline_floor_ms", "LANGDETECT_FLEET_DEADLINE_FLOOR_MS",
         "float", 5.0, "remaining-deadline floor below which the router "
         "504s instead of burning another replica", positive=True),
    Knob("retry_budget_fraction", "LANGDETECT_RETRY_BUDGET_FRACTION",
         "float", 0.2, "retry-budget tokens deposited per success "
         "(0: budget off, retries ungated)"),
    Knob("retry_budget_burst", "LANGDETECT_RETRY_BUDGET_BURST", "float",
         10.0, "retry-budget token cap and starting balance",
         positive=True),
    Knob("hedge_enable", "LANGDETECT_HEDGE_ENABLE", "bool", False,
         "hedged fleet dispatch: second replica tried after the observed "
         "latency-quantile delay"),
    Knob("hedge_quantile", "LANGDETECT_HEDGE_QUANTILE", "float", 0.95,
         "observed dispatch-latency quantile that arms the hedge timer",
         positive=True),
    Knob("hedge_min_ms", "LANGDETECT_HEDGE_MIN_MS", "float", 10.0,
         "hedge-delay floor (also the delay before latency history "
         "exists)", positive=True),
    Knob("quarantine_deaths", "LANGDETECT_QUARANTINE_DEATHS", "int", 2,
         "correlated replica deaths that quarantine a request signature",
         positive=True),
    Knob("quarantine_max_entries", "LANGDETECT_QUARANTINE_MAX_ENTRIES",
         "int", 4096, "suspect/quarantine signature-table bound (oldest "
         "evicted first)", positive=True),
    Knob("quarantine_dlq_path", "LANGDETECT_QUARANTINE_DLQ_PATH", "str",
         None, "serve-level dead-letter JSONL for quarantined "
         "query-of-death signatures"),
    # --- elastic scale (process replicas + autoscaler: scale/) ----------
    Knob("scale_min", "LANGDETECT_SCALE_MIN", "int", 1,
         "autoscaler floor: minimum live replicas", positive=True),
    Knob("scale_max", "LANGDETECT_SCALE_MAX", "int", 4,
         "autoscaler ceiling: maximum live replicas", positive=True),
    Knob("scale_interval_ms", "LANGDETECT_SCALE_INTERVAL_MS", "float",
         500.0, "autoscaler control-loop tick period", positive=True),
    Knob("scale_up_ticks", "LANGDETECT_SCALE_UP_TICKS", "int", 2,
         "consecutive pressure ticks before a scale-up", positive=True),
    Knob("scale_down_ticks", "LANGDETECT_SCALE_DOWN_TICKS", "int", 6,
         "consecutive idle ticks (the cooldown) before a scale-down",
         positive=True),
    Knob("scale_pressure_wait_ms", "LANGDETECT_SCALE_PRESSURE_WAIT_MS",
         "float", 50.0, "estimated fleet queue wait that counts as SLO "
         "pressure", positive=True),
    Knob("scale_idle_rows_per_s", "LANGDETECT_SCALE_IDLE_ROWS_PER_S",
         "float", 1.0, "arrival-rate EMA below which an empty-queue tick "
         "counts idle", positive=True),
    Knob("scale_spawn_timeout_s", "LANGDETECT_SCALE_SPAWN_TIMEOUT_S",
         "float", 120.0, "process replica spawn-to-READY bound",
         positive=True),
    Knob("scale_max_restarts", "LANGDETECT_SCALE_MAX_RESTARTS", "int", 3,
         "supervised restarts per replica incident before giving up",
         positive=True),
    Knob("scale_pidfile_dir", "LANGDETECT_SCALE_PIDFILE_DIR", "str", None,
         "pidfile directory for orphan reaping (unset: per-fleet-name "
         "tempdir)"),
    # --- cold-start plane (artifacts/) -----------------------------------
    Knob("compile_cache_dir", "LANGDETECT_COMPILE_CACHE_DIR", "str", None,
         "kernel build cache directory shared across replica spawns: the "
         "CUDA kernels' libraries and the lattice manifests (unset: the "
         "package's build directory, no manifest)"),
    Knob("artifact_dir", "LANGDETECT_ARTIFACT_DIR", "str", None,
         "baked-artifact directory consulted on model load (unset: look "
         "for a `.baked` sibling of the model tree)"),
    Knob("bake_on_save", "LANGDETECT_BAKE_ON_SAVE", "bool", False,
         "bake an mmap-ready artifact next to every successful model "
         "save so later cold loads page in instead of parsing parquet"),
    # --- telemetry --------------------------------------------------------
    Knob("metrics_sink", "LANGDETECT_METRICS_SINK", "str", None,
         "metrics sink spec (jsonl:<path> / prometheus:<path>)"),
    Knob("telemetry_fence", "LANGDETECT_TELEMETRY_FENCE", "bool", False,
         "fence spans on device completion"),
    Knob("flight_recorder", "LANGDETECT_FLIGHT_RECORDER", "str", None,
         "crash ring-buffer dump dir (1: tmpdir)"),
    Knob("flight_recorder_events", "LANGDETECT_FLIGHT_RECORDER_EVENTS",
         "int", 2048, "crash ring capacity", positive=True),
    Knob("trace_dir", "LANGDETECT_TRACE_DIR", "str", None,
         "XProf trace output dir"),
    Knob("peak_flops", "LANGDETECT_PEAK_FLOPS", "float", None,
         "roofline FLOP/s anchor override"),
    Knob("peak_bytes_per_s", "LANGDETECT_PEAK_BYTES_PER_S", "float", None,
         "roofline bytes/s anchor override"),
    Knob("loglevel", "LANGDETECT_TPU_LOGLEVEL", "str", None,
         "package log level"),
    # --- multi-process bring-up (parallel.distributed.initialize) ---------
    Knob("tpu_coordinator", "LANGDETECT_TPU_COORDINATOR", "str", None,
         "process-group address (tcp://host:port or file://path)"),
    Knob("tpu_num_processes", "LANGDETECT_TPU_NUM_PROCESSES", "int", None,
         "process-group world size", positive=True),
    Knob("tpu_process_id", "LANGDETECT_TPU_PROCESS_ID", "int", None,
         "this process's rank in the group"),
    # --- tuning profile ---------------------------------------------------
    Knob("tuning_profile", PROFILE_ENV, "str", None,
         "path to a tuning profile JSON (exec.profile)"),
)

# Deprecation table: hand-set env knobs the autotuner supersedes. The old
# spelling keeps working (and keeps winning over the profile — explicit
# beats measured), but deployments should drop it and ship a profile: the
# tuned default is measured per deployment instead of guessed once.
# old env name -> tuned profile field that replaces it
DEPRECATED_ENV: dict[str, str] = {
    "LANGDETECT_LENGTH_BUCKETS": "length_buckets",
    "LANGDETECT_BATCH_BYTES": "batch_bytes",
    "LANGDETECT_FIT_BATCH_BYTES": "fit_batch_bytes",
    "LANGDETECT_SERVE_MAX_WAIT_MS": "serve_max_wait_ms",
    "LANGDETECT_SERVE_MAX_ROWS": "serve_max_rows",
    "LANGDETECT_SERVE_QUEUE_ROWS": "serve_queue_rows",
}


# ------------------------------------------------------------- profile ------
_profile_cache: tuple[str, float, TuningProfile] | None = None
_profile_warned: set[str] = set()


def reload_profile() -> None:
    """Drop the cached profile (tests / the tuner's A-B smoke)."""
    global _profile_cache
    _profile_cache = None


def active_profile(env=os.environ) -> TuningProfile | None:
    """The tuning profile ``LANGDETECT_TUNING_PROFILE`` names, or None.

    Cached per (path, mtime). A missing or invalid profile file is a
    loud failure: startup with a half-rolled-out profile must not
    silently run untuned."""
    global _profile_cache
    path = (env.get(PROFILE_ENV) or "").strip()
    if not path:
        return None
    try:
        mtime = os.stat(path).st_mtime
    except OSError as e:
        raise ValueError(
            f"{PROFILE_ENV}={path!r} names an unreadable profile: {e}"
        ) from e
    cached = _profile_cache
    if cached is not None and cached[0] == path and cached[1] == mtime:
        return cached[2]
    prof = TuningProfile.load(path)
    _profile_cache = (path, mtime, prof)
    log_event(
        _log, "exec.config.profile_loaded", path=path,
        version=prof.version, fields=sorted(prof.tuned),
    )
    return prof


# ----------------------------------------------------------- resolution -----
def _parse(knob: Knob, raw: str):
    try:
        if knob.kind == "int":
            value = int(raw)
        elif knob.kind == "float":
            value = float(raw)
        elif knob.kind == "bool":
            low = raw.strip().lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
            raise ValueError(raw)
        elif knob.kind == "int_tuple":
            value = tuple(
                int(p) for p in raw.replace(" ", "").split(",") if p
            )
            if not value or list(value) != sorted(set(value)) or min(value) < 1:
                raise ValueError(raw)
            # Same constraint the tuning-profile validator enforces
            # (exec.profile): bucket widths are 128-aligned for the lane
            # tiling and the ragged-chunk transfer form. Env and profile
            # must not disagree on what a legal lattice is.
            if any(x % 128 for x in value):
                raise ValueError(
                    f"{knob.env} values must be multiples of 128, got {raw!r}"
                )
        else:  # str
            return raw
    except ValueError as e:
        kind = {"int": "an integer", "float": "a number",
                "bool": "a boolean", "int_tuple":
                "a comma-separated ascending list of positive integers"}[
                    knob.kind]
        raise ValueError(f"{knob.env} must be {kind}, got {raw!r}") from e
    if knob.positive and value is not None and value <= 0:
        raise ValueError(f"{knob.env} must be positive, got {value}")
    return value


def resolve_with_source(
    name: str, explicit=None, env=os.environ
) -> tuple[object, str]:
    """(value, source) for one knob; source is ``explicit`` / ``env`` /
    ``profile`` / ``default``. Precedence: explicit > env > tuning profile
    > built-in default. Raises ValueError on a malformed env value or an
    unknown knob — a typo must never silently mean "default"."""
    knob = KNOBS.get(name)
    if knob is None:
        raise ValueError(
            f"unknown config knob {name!r}; expected one of {sorted(KNOBS)}"
        )
    if explicit is not None:
        return explicit, "explicit"
    raw = env.get(knob.env) if knob.env else None
    if raw is not None and raw != "":
        value = _parse(knob, raw)
        if knob.env in DEPRECATED_ENV and knob.env not in _profile_warned:
            prof = active_profile(env)
            if prof is not None and prof.get(DEPRECATED_ENV[knob.env]) is not None:
                _profile_warned.add(knob.env)
                log_event(
                    _log, "exec.config.env_overrides_profile",
                    env=knob.env, value=raw,
                    tuned=DEPRECATED_ENV[knob.env],
                    profile=prof.version,
                )
        return value, "env"
    if knob.tunable:
        prof = active_profile(env)
        if prof is not None:
            tuned = prof.get(name)
            if tuned is not None:
                return tuned, "profile"
    return knob.default, "default"


def resolve(name: str, explicit=None, env=os.environ):
    """The knob's effective value (see :func:`resolve_with_source`)."""
    return resolve_with_source(name, explicit, env)[0]


def raw_env(name: str, env=os.environ) -> str | None:
    """The raw, unparsed env string behind a knob (diagnostics only).

    For error paths that want to *show* what the operator typed without
    re-spelling the env-var name at the call site — the one place a
    module outside this file may touch a knob's environment string.
    """
    knob = KNOBS.get(name)
    if knob is None:
        raise ValueError(
            f"unknown config knob {name!r}; expected one of {sorted(KNOBS)}"
        )
    return env.get(knob.env) if knob.env else None


def effective_config(env=os.environ) -> dict:
    """Every knob's live value + provenance — the ``/varz`` and bench
    audit block. Malformed env values surface as ``"error"`` entries
    instead of raising: an observability endpoint must render the
    misconfiguration, not 500 on it."""
    prof = None
    prof_error = None
    try:
        prof = active_profile(env)
    except ValueError as e:
        prof_error = str(e)
    out: dict = {
        "profile": None if prof is None else {
            "version": prof.version,
            "created": prof.created,
            "tuned": {
                k: (list(v) if isinstance(v, tuple) else v)
                for k, v in prof.tuned.items()
            },
        },
        "deprecated_env": dict(DEPRECATED_ENV),
        "knobs": {},
    }
    if prof_error:
        out["profile_error"] = prof_error
    for name in sorted(KNOBS):
        try:
            value, source = resolve_with_source(name, env=env)
        except ValueError as e:
            out["knobs"][name] = {"error": str(e), "env": KNOBS[name].env}
            continue
        entry: dict = {
            "value": list(value) if isinstance(value, tuple) else value,
            "source": source,
            "env": KNOBS[name].env,
        }
        out["knobs"][name] = entry
    return out


# The logging root's level was set pre-config (bootstrap: this module's
# own imports emit through it, so the knob table cannot exist yet when the
# root initializes). Re-resolve it through the table now that it exists, so
# the live level and effective_config() cannot disagree.
from ..utils.logging import sync_level_from_config as _sync_level  # noqa: E402

_sync_level(resolve)
