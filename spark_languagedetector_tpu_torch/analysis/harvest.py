"""AST/text harvesters for the contract checker (pure stdlib, no imports
of the audited modules — a module with an import-time side effect or a
torch dependency must still be checkable from a cold CI host).

Port of ``spark_languagedetector_tpu.analysis.harvest`` without the
trace-purity harvest (the port traces nothing; see :mod:`.rules`). One
:class:`PyFile` per scanned source file carries everything the rule
families in :mod:`.rules` need: resolved ``LANGDETECT_*`` env reads, knob
literals, telemetry emit sites (counter/histogram/gauge/span names,
f-string heads kept as prefixes), ``faults.inject`` call sites, and
suppression pragmas.

The harvesters are deliberately *syntactic*: a name is an env read when
it is a ``.get``/``getenv``/subscript whose key resolves to a
``LANGDETECT_*`` string (literal or module-level constant), an emit site
when the receiver's terminal name is ``REGISTRY``/``reg``/``registry``.
Reads threaded through helper parameters (``_env_int(env, name, ...)``)
are out of reach by design — but their *name constants* still hit the
knob-literal rule, so a knob can't exist outside the audited table
either way. docs/ANALYSIS.md §2 spells out the boundary.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

# One token per knob mention; a trailing ``*`` (docs) or ``_`` marks a
# wildcard family reference (``LANGDETECT_RETRY_*``) rather than a row.
KNOB_TOKEN_RE = re.compile(r"LANGDETECT_[A-Z0-9_]*\*?")

# Inline suppression (hash sign, then): ``contract: ignore[R1] -- reason``
# — comma list of rule ids; the reason is mandatory, an unexplained
# suppression is noise for the next reader. Honored on the violating line
# or alone on the line directly above it.
PRAGMA_RE = re.compile(
    r"#\s*contract:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*--\s*(\S.*?)\s*$"
)

_EMIT_RECEIVERS = ("REGISTRY", "reg", "registry")
_EMIT_METHODS = ("incr", "observe", "set_gauge", "record_span")


@dataclass
class EmitSites:
    """Telemetry names one file emits; values are first-seen lines."""

    counters: dict[str, int] = field(default_factory=dict)
    counter_prefixes: dict[str, int] = field(default_factory=dict)
    hists: dict[str, int] = field(default_factory=dict)
    hist_prefixes: dict[str, int] = field(default_factory=dict)
    gauges: dict[str, int] = field(default_factory=dict)
    gauge_prefixes: dict[str, int] = field(default_factory=dict)
    spans: dict[str, int] = field(default_factory=dict)
    span_prefixes: dict[str, int] = field(default_factory=dict)


@dataclass
class PyFile:
    """One parsed source file's harvest."""

    rel: str
    text: str
    tree: ast.Module | None
    parse_error: str | None = None
    consts: dict[str, str] = field(default_factory=dict)
    env_reads: list[tuple[int, str]] = field(default_factory=list)
    knob_tokens: list[tuple[int, str, bool]] = field(default_factory=list)
    emits: EmitSites = field(default_factory=EmitSites)
    injects: list[tuple[int, str]] = field(default_factory=list)
    pragmas: dict[int, tuple[frozenset[str], str]] = field(
        default_factory=dict
    )


# ------------------------------------------------------------ helpers -------
def _terminal_name(node: ast.expr) -> str | None:
    """The last dotted component of a receiver expression."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _str_of(node: ast.expr, consts: dict[str, str]) -> str | None:
    """A string literal, or a module-level string constant by name."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _emit_names(node: ast.expr) -> tuple[list[str], list[str]]:
    """(full literal names, prefix heads) a name argument can produce."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value], []
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return [], [head.value]
    if isinstance(node, ast.IfExp):
        full: list[str] = []
        pref: list[str] = []
        for branch in (node.body, node.orelse):
            f, p = _emit_names(branch)
            full += f
            pref += p
        return full, pref
    return [], []


# --------------------------------------------------------- file harvest -----
def harvest_file(path: Path, rel: str) -> PyFile:
    text = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return PyFile(rel=rel, text=text, tree=None, parse_error=str(e))
    pf = PyFile(rel=rel, text=text, tree=tree)
    _harvest_consts(pf)
    _harvest_knob_tokens(pf)
    _harvest_pragmas(pf)
    _harvest_calls(pf)
    return pf


def _harvest_consts(pf: PyFile) -> None:
    for node in pf.tree.body:
        # Both spellings of a module-level string constant — a missed
        # form here is an R1 bypass (env reads resolve keys through
        # these), so keep this in sync with what _str_of can be handed.
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            target, value = node.target.id, node.value
        else:
            continue
        if isinstance(value, ast.Constant) and isinstance(value.value, str):
            pf.consts[target] = value.value


def _harvest_knob_tokens(pf: PyFile) -> None:
    for lineno, line in enumerate(pf.text.splitlines(), start=1):
        for m in KNOB_TOKEN_RE.finditer(line):
            token = m.group(0)
            wildcard = token.endswith(("*", "_"))
            token = token.rstrip("*")
            if token == "LANGDETECT_":
                continue  # generic family mention ("every LANGDETECT_* knob")
            pf.knob_tokens.append((lineno, token, wildcard))


def _harvest_pragmas(pf: PyFile) -> None:
    for lineno, line in enumerate(pf.text.splitlines(), start=1):
        m = PRAGMA_RE.search(line)
        if m is None:
            continue
        rules = frozenset(
            r.strip() for r in m.group(1).split(",") if r.strip()
        )
        pf.pragmas[lineno] = (rules, m.group(2))


def _record(table: dict[str, int], name: str, line: int) -> None:
    table.setdefault(name, line)


def _harvest_calls(pf: PyFile) -> None:
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Load
        ):
            key = _str_of(node.slice, pf.consts)
            if (
                key
                and key.startswith("LANGDETECT_")
                and _terminal_name(node.value) in ("environ",)
            ):
                pf.env_reads.append((node.lineno, key))
            continue
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        # --- env reads: <x>.get("LANGDETECT_…") / os.getenv(…) ----------
        if node.args:
            key = _str_of(node.args[0], pf.consts)
            if key and key.startswith("LANGDETECT_"):
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in ("get", "getenv")
                ) or (isinstance(func, ast.Name) and func.id == "getenv"):
                    pf.env_reads.append((node.lineno, key))
        # --- telemetry emits --------------------------------------------
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _EMIT_METHODS
            and _terminal_name(func.value) in _EMIT_RECEIVERS
            and node.args
        ):
            full, prefixes = _emit_names(node.args[0])
            emits = pf.emits
            kind = {
                "incr": (emits.counters, emits.counter_prefixes),
                "observe": (emits.hists, emits.hist_prefixes),
                "set_gauge": (emits.gauges, emits.gauge_prefixes),
                "record_span": (emits.spans, emits.span_prefixes),
            }[func.attr]
            for name in full:
                _record(kind[0], name, node.lineno)
            for prefix in prefixes:
                _record(kind[1], prefix, node.lineno)
        # --- span("name") ------------------------------------------------
        if isinstance(func, ast.Name) and func.id == "span" and node.args:
            full, prefixes = _emit_names(node.args[0])
            for name in full:
                _record(pf.emits.spans, name, node.lineno)
            for prefix in prefixes:
                _record(pf.emits.span_prefixes, prefix, node.lineno)
        # --- fault injection sites --------------------------------------
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "inject"
            and _terminal_name(func.value) == "faults"
        ) or (isinstance(func, ast.Name) and func.id == "inject"):
            if node.args:
                site = _str_of(node.args[0], pf.consts)
                if site:
                    pf.injects.append((node.lineno, site))
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "corrupt_batch"
        ):
            site = "stream/batch"  # the signature's default site
            for kw in node.keywords:
                if kw.arg == "site":
                    site = _str_of(kw.value, pf.consts) or site
            if len(node.args) >= 3:
                site = _str_of(node.args[2], pf.consts) or site
            pf.injects.append((node.lineno, site))


# ------------------------------------------- contract-module extraction -----
def knob_table(config: PyFile | None) -> dict[str, tuple[str | None, int]]:
    """``{knob name: (env spelling, line)}`` from ``Knob(...)`` rows."""
    out: dict[str, tuple[str | None, int]] = {}
    if config is None or config.tree is None:
        return out
    for node in ast.walk(config.tree):
        if (
            isinstance(node, ast.Call)
            and _terminal_name(node.func) == "Knob"
            and node.args
        ):
            name = _str_of(node.args[0], config.consts)
            env = None
            if len(node.args) > 1:
                env = _str_of(node.args[1], config.consts)
            if name:
                out[name] = (env, node.lineno)
    return out


def _module_assign(pf: PyFile, name: str) -> ast.expr | None:
    for node in pf.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == name
        ):
            return node.value
        if (
            isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and node.target.id == name
            and node.value is not None
        ):
            return node.value
    return None


def _str_elements(node: ast.expr | None, consts: dict[str, str]) -> list[str]:
    if node is None or not isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return []
    out = []
    for el in node.elts:
        s = _str_of(el, consts)
        if s:
            out.append(s)
    return out


def fault_sites(faults: PyFile | None) -> dict[str, int]:
    """``SITES`` rows (name -> declaration line)."""
    if faults is None or faults.tree is None:
        return {}
    node = _module_assign(faults, "SITES")
    if node is None:
        return {}
    return {s: node.lineno for s in _str_elements(node, faults.consts)}


@dataclass
class CompareContracts:
    """Names ``telemetry/compare`` consumes from a capture."""

    tracked_gauges: dict[str, int] = field(default_factory=dict)
    tracked_ratio_counters: dict[str, int] = field(default_factory=dict)
    tracked_ratio_names: dict[str, int] = field(default_factory=dict)
    reliability_counters: dict[str, int] = field(default_factory=dict)
    reliability_prefixes: dict[str, int] = field(default_factory=dict)
    informational_counters: dict[str, int] = field(default_factory=dict)
    cold_start_histograms: dict[str, int] = field(default_factory=dict)


def compare_contracts(compare: PyFile | None) -> CompareContracts:
    out = CompareContracts()
    if compare is None or compare.tree is None:
        return out
    node = _module_assign(compare, "_TRACKED_GAUGES")
    if isinstance(node, ast.Dict):
        for key in node.keys:
            s = _str_of(key, compare.consts)
            if s:
                out.tracked_gauges[s] = node.lineno
    node = _module_assign(compare, "_TRACKED_RATIOS")
    if isinstance(node, ast.Dict):
        for key, value in zip(node.keys, node.values):
            name = _str_of(key, compare.consts)
            if name:
                out.tracked_ratio_names[name] = node.lineno
            for counter in _str_elements(value, compare.consts):
                out.tracked_ratio_counters[counter] = node.lineno
    for const, table in (
        ("_RELIABILITY_COUNTERS", out.reliability_counters),
        ("_RELIABILITY_COUNTER_PREFIXES", out.reliability_prefixes),
        ("_INFORMATIONAL_COUNTERS", out.informational_counters),
        ("_COLD_START_HISTOGRAMS", out.cold_start_histograms),
    ):
        node = _module_assign(compare, const)
        for s in _str_elements(node, compare.consts):
            table[s] = node.lineno
    return out


@dataclass
class FleetContracts:
    """Names the fleet observability plane consumes (docs/OBSERVABILITY.md
    §14): counters the aggregate's pressure readers sum, the collector's
    own guard counters (which must stay pinned in ``telemetry/compare``'s
    tables), and the SLO layer's burn-rate inputs."""

    consumed_counters: dict[str, int] = field(default_factory=dict)
    guard_counters: dict[str, int] = field(default_factory=dict)
    slo_counters: dict[str, int] = field(default_factory=dict)
    slo_histograms: dict[str, int] = field(default_factory=dict)
    slo_gauges: dict[str, int] = field(default_factory=dict)


def fleet_contracts(
    aggregate: PyFile | None, slo: PyFile | None
) -> FleetContracts:
    """Contract tables from ``telemetry/aggregate`` + ``telemetry/slo``."""
    out = FleetContracts()

    def pull(pf: PyFile | None, const: str, table: dict[str, int]) -> None:
        if pf is None or pf.tree is None:
            return
        node = _module_assign(pf, const)
        if node is None:
            return
        for s in _str_elements(node, pf.consts):
            table[s] = node.lineno

    pull(aggregate, "CONSUMED_COUNTERS", out.consumed_counters)
    pull(aggregate, "GUARD_COUNTERS", out.guard_counters)
    pull(slo, "SLO_INPUT_COUNTERS", out.slo_counters)
    pull(slo, "SLO_INPUT_HISTOGRAMS", out.slo_histograms)
    pull(slo, "SLO_INPUT_GAUGES", out.slo_gauges)
    return out


def tune_consumed(tune: PyFile | None) -> dict[str, tuple[int, str, bool]]:
    """Capture names ``exec/tune`` replays: ``{name: (line, kind, prefix)}``.

    Everything read off the last snapshot via ``counters.get("…")`` /
    ``hists.get("…")`` (kind follows the receiver), plus the
    ``LEN_BIN_PREFIX`` counter family.
    """
    out: dict[str, tuple[int, str, bool]] = {}
    if tune is None or tune.tree is None:
        return out
    for node in ast.walk(tune.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in ("counters", "hists")
            and node.args
        ):
            name = _str_of(node.args[0], tune.consts)
            if name:
                kind = (
                    "counter"
                    if node.func.value.id == "counters"
                    else "histogram"
                )
                out.setdefault(name, (node.lineno, kind, False))
    prefix = tune.consts.get("LEN_BIN_PREFIX")
    if prefix:
        out.setdefault(prefix, (1, "counter", True))
    return out
