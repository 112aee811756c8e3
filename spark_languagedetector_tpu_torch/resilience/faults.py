"""Deterministic fault injection: a seeded chaos layer for the runner.

Port of ``spark_languagedetector_tpu.resilience.faults``: the same grammar,
seeds, site names and schedules, so the same plan fires on the same calls
in both packages.

Every recovery path of the runner must be exercisable on the CPU —
waiting for a real device failure to test the breaker is not a test
strategy. A :class:`FaultPlan` describes *exactly* which calls at which
named sites fail and how; the instrumented sites (see :data:`SITES`) ask
the active plan before doing real work. With no plan installed the hooks
are a single ``None`` check — the production hot path pays nothing.

Plan grammar (env ``LANGDETECT_FAULT_PLAN`` or :meth:`FaultPlan.parse`)::

    seed=42;score/dispatch:error@2,5;score/fetch:delay=0.01@1-3;
    stream/batch:poison=2@4;shard_step:error%0.1

``;``-separated entries. ``seed=N`` seeds the deterministic jitter/row
choices. Every other entry is ``site:kind[=value][@calls][%prob]``:

  * ``kind`` — ``error`` (raise an :class:`InjectedFault`, a
    ``RuntimeError`` the retry classifier treats as transient), ``delay`` (sleep ``value`` seconds — a latency
    spike), or ``poison`` (corrupt ``value`` rows — default 1 — of a
    streaming batch so they fail *deterministically*, exercising the
    DLQ/bisect path).
  * ``@calls`` — 1-based call indices at that site: a comma list of
    numbers and ``lo-hi`` ranges. ``error``/``delay`` count *execution
    attempts* (a retried dispatch advances the counter, so ``@2`` fails
    one attempt and its replay passes); ``poison`` counts *source
    batches*.
  * ``%prob`` — instead of explicit calls, fire with probability ``prob``
    per call, decided by a hash of (seed, site, call) — still fully
    deterministic for a given seed.
  * neither ``@`` nor ``%`` — fire on every call.

Sites: the table :data:`SITES` is the JAX package's, whole, so a plan that
parses in one package parses in the other and fires on the same calls.
Every site has an ``inject()`` call in the port (the contract checker,
:mod:`..analysis`, holds the two to each other). Among them:

  * ``score/dispatch`` — each padded or ragged batch's dispatch, each segment
    dispatch, and the degradation ladder's device-gather rung (it is still
    a device dispatch);
  * ``score/fetch``    — each batch's result fetch;
  * ``score/pack``     — each wire build of the device-encode path: a firing
    ``error`` fails the wire form before anything ships, so the ladder
    falls to the host-pack rung — scores stay bit-identical;
  * ``serve/admit``, ``serve/cache`` — the serving batcher and score cache;
  * ``stream/batch``   — each streamed batch's transform attempt
    (``error``/``delay``) and each pulled source batch (``poison``, through
    :func:`corrupt_batch`), in :mod:`..stream.microbatch`;
  * ``fit/count``      — each count step of the device fit's pass
    (:func:`..ops.fit_tpu.accumulate_counts`);
  * ``shard_step``     — each step of the mesh fit, before any collective,
    so every rank fails the same step together
    (:func:`..parallel.sharded.make_sharded_fit_step`).
"""

from __future__ import annotations

import os
import re
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("resilience.faults")

FAULT_PLAN_ENV = "LANGDETECT_FAULT_PLAN"

SITES = (
    "score/dispatch",
    "score/fetch",
    "score/pack",
    "stream/batch",
    "fit/count",
    "shard_step",
    "serve/admit",
    "serve/cache",
    "fleet/probe",
    "fleet/dispatch",
    "fleet/swap",
    "zoo/load",
    "scale/spawn",
    "scale/decision",
    "fleet/scrape",
    "fleet/hedge",
    "fleet/quarantine",
)

KINDS = ("error", "delay", "poison")

_U64 = (1 << 64) - 1


class InjectedFault(RuntimeError):
    """Injected failure (a RuntimeError subclass, so the retry classifier
    treats it as a transient device fault)."""


class PoisonRowError(ValueError):
    """Deterministic failure a poison row raises when encoded for scoring.

    A ``ValueError`` on purpose: the classifier must route it to the
    DLQ/raise path, never to a futile replay.
    """


class PoisonText(str):
    """A poisoned document: equal to the original text (str subclass, so
    schema checks and comparisons pass) but impossible to encode — every
    scoring path goes through ``text_to_bytes``, which calls ``encode``.
    """

    def encode(self, *args, **kwargs):  # noqa: D102 - poison contract
        raise PoisonRowError(
            f"injected poison row ({len(self)} chars): cannot encode"
        )


def _mix(*parts: int) -> float:
    """Deterministic uniform [0, 1) from integer parts (splitmix64-ish)."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = ((x ^ (p & _U64)) * 0xBF58476D1CE4E5B9) & _U64
        x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & _U64
    x ^= x >> 29
    return x / float(1 << 64)


def _fnv1a(text: str) -> int:
    """Process-independent string hash (FNV-1a). The builtin ``hash()`` is
    salted per process (PYTHONHASHSEED), which would give every process of
    a multi-host mesh — and every rerun — a different %prob schedule."""
    h = 0xCBF29CE484222325
    for b in text.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & _U64
    return h


@dataclass(frozen=True)
class FaultSpec:
    """One parsed plan entry."""

    site: str
    kind: str
    value: float = 0.0  # delay seconds, or poison row count
    calls: tuple[tuple[int, int], ...] = ()  # inclusive (lo, hi) ranges
    prob: float | None = None

    def fires(self, call: int, seed: int) -> bool:
        if self.calls:
            return any(lo <= call <= hi for lo, hi in self.calls)
        if self.prob is not None:
            # site hashed in so two sites with the same %p don't fire in
            # lockstep; call hashed in so the schedule varies per call.
            h = _mix(seed, _fnv1a(self.site), call)
            return h < self.prob
        return True  # no selector: every call


_ENTRY_RE = re.compile(
    r"^(?P<site>[a-z_/]+):(?P<kind>[a-z]+)"
    r"(?:=(?P<value>[0-9.]+))?"
    r"(?:@(?P<calls>[0-9,\-]+))?"
    r"(?:%(?P<prob>[0-9.]+))?$"
)


def _parse_calls(text: str) -> tuple[tuple[int, int], ...]:
    out: list[tuple[int, int]] = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        lo, sep, hi = part.partition("-")
        a = int(lo)
        b = int(hi) if sep else a
        if a < 1 or b < a:
            raise ValueError(f"bad call range {part!r} (1-based, lo <= hi)")
        out.append((a, b))
    if not out:
        raise ValueError("empty @calls selector")
    return tuple(out)


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic chaos schedule over the named sites."""

    specs: tuple[FaultSpec, ...] = ()
    seed: int = 0

    @staticmethod
    def parse(text: str) -> "FaultPlan":
        specs: list[FaultSpec] = []
        seed = 0
        for raw in text.split(";"):
            entry = raw.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                seed = int(entry[len("seed="):])
                continue
            m = _ENTRY_RE.match(entry)
            if m is None:
                raise ValueError(
                    f"bad {FAULT_PLAN_ENV} entry {entry!r}; expected "
                    "site:kind[=value][@calls][%prob]"
                )
            site, kind = m.group("site"), m.group("kind")
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; expected one of {SITES}"
                )
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; expected one of {KINDS}"
                )
            if m.group("calls") and m.group("prob"):
                raise ValueError(
                    f"entry {entry!r}: @calls and %prob are exclusive"
                )
            value = float(m.group("value") or 0.0)
            if kind == "poison" and value <= 0:
                value = 1.0
            specs.append(
                FaultSpec(
                    site=site,
                    kind=kind,
                    value=value,
                    calls=_parse_calls(m.group("calls"))
                    if m.group("calls")
                    else (),
                    prob=float(m.group("prob"))
                    if m.group("prob") is not None
                    else None,
                )
            )
        return FaultPlan(specs=tuple(specs), seed=seed)

    def poison_rows(self, call: int, num_rows: int) -> list[int]:
        """Row indices to poison in source batch number ``call`` (sorted,
        deterministic in (seed, call))."""
        rows: set[int] = set()
        for spec in self.specs:
            if spec.kind != "poison" or not spec.fires(call, self.seed):
                continue
            want = min(num_rows, max(1, int(spec.value)))
            i = 0
            while len(rows) < want and i < 64 * want:
                rows.add(int(_mix(self.seed, call, i) * num_rows) % num_rows)
                i += 1
        return sorted(rows)


# --- process-global active plan ----------------------------------------------
_plan: FaultPlan | None = None
_counters: dict[tuple[str, str], int] = {}
_lock = threading.Lock()


def active() -> FaultPlan | None:
    return _plan


def install(plan: FaultPlan) -> FaultPlan:
    """Arm ``plan`` process-wide (call counters restart at zero)."""
    global _plan
    with _lock:
        _plan = plan
        _counters.clear()
    log_event(_log, "faults.installed", specs=len(plan.specs), seed=plan.seed)
    return plan


def uninstall() -> None:
    global _plan
    with _lock:
        _plan = None
        _counters.clear()


@contextmanager
def plan_scope(plan: FaultPlan):
    """Arm ``plan`` for the duration of a with-block (tests, bench smoke)."""
    prev = _plan
    install(plan)
    try:
        yield plan
    finally:
        with _lock:
            globals()["_plan"] = prev
            _counters.clear()


def install_from_env(env=os.environ) -> FaultPlan | None:
    """Arm the env-declared plan; None when unset. Raises on a bad spec —
    a typo'd chaos schedule must be loud, not a silently clean run. The
    knob resolves through exec/config's audited table (imported lazily:
    this runs at package-import time, before the exec package is up)."""
    from ..exec import config as exec_config

    spec = (exec_config.resolve("fault_plan", env=env) or "").strip()
    if not spec:
        return None
    return install(FaultPlan.parse(spec))


def _next_call(site: str, channel: str) -> int:
    with _lock:
        key = (site, channel)
        _counters[key] = _counters.get(key, 0) + 1
        return _counters[key]


_shield = threading.local()


@contextmanager
def shield():
    """Suppress fault injection on this thread for the with-block.

    For diagnostic side paths, such as the runner's cost-gauge thread, that
    run instrumented code without serving anything: a plan firing there
    would spend a call number in a thread that swallows the fault, and the
    fault aimed at a serving attempt would never land. Shielded calls
    advance no counter.
    """
    prev = getattr(_shield, "on", False)
    _shield.on = True
    try:
        yield
    finally:
        _shield.on = prev


def inject(site: str) -> None:
    """Chaos hook for ``error``/``delay`` faults at one execution attempt.

    No-op without an active plan. A firing ``delay`` sleeps, a firing
    ``error`` raises :class:`InjectedFault`; both are counted
    (``resilience/faults_injected``) and logged with the site and call
    number so a chaos run's timeline is reconstructible from the JSONL.
    """
    plan = _plan
    if plan is None or getattr(_shield, "on", False):
        return
    call = _next_call(site, "exec")
    for spec in plan.specs:
        if spec.site != site or spec.kind == "poison":
            continue
        if not spec.fires(call, plan.seed):
            continue
        REGISTRY.incr("resilience/faults_injected")
        log_event(
            _log, "faults.fired", site=site, call=call, kind=spec.kind,
            value=spec.value,
        )
        if spec.kind == "delay":
            time.sleep(spec.value)
        else:
            raise InjectedFault(
                f"INTERNAL: injected fault at {site} (call {call})"
            )


def corrupt_batch(table, column: str | None, site: str = "stream/batch"):
    """Chaos hook for ``poison`` faults on one pulled source batch.

    Returns ``(table, poisoned_row_indices)`` — the table unchanged when
    nothing fires. Poisoned rows keep their text value (:class:`PoisonText`
    is a str subclass) but fail deterministically when the scoring path
    encodes them, which is what drives the engine's bisect → DLQ flow. The
    call counter advances once per pulled batch (whatever the column), as
    in the JAX package, so one plan poisons the same batches in both.
    """
    plan = _plan
    if plan is None:
        return table, []
    call = _next_call(site, "poison")
    if column is None or column not in table.schema:
        return table, []
    rows = plan.poison_rows(call, table.num_rows)
    if not rows:
        return table, []
    values = list(table.column(column))
    for i in rows:
        values[i] = PoisonText(values[i])
    REGISTRY.incr("resilience/faults_injected")
    log_event(_log, "faults.poisoned", site=site, call=call, rows=rows)
    return table.replace_column(column, values), rows


# Env-armed at import, like the telemetry sinks: every instrumented module
# imports this package, so setting LANGDETECT_FAULT_PLAN needs no code
# change. A bad plan degrades to a loud warning rather than an
# ImportError; calling install_from_env directly still raises.
try:
    install_from_env()
except Exception as _e:
    import warnings as _warnings

    _warnings.warn(
        f"{FAULT_PLAN_ENV} ignored — could not arm the fault plan: {_e}",
        RuntimeWarning,
        stacklevel=2,
    )
