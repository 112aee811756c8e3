"""The contract rule families R1, R2, R3 and R5 over a harvested scan.

Port of ``spark_languagedetector_tpu.analysis.rules``, pointed at the
port's own tables. R4 (trace purity: host-impure calls inside
``jit``/``pjit``/``shard_map``/``pallas_call``-traced functions) has no
counterpart: the port traces nothing — it has no ``jit``, no
``torch.compile`` and no CUDA graph capture; every kernel is a
hand-written CUDA launch called from ordinary host code. A pragma that
names R4 is an unknown rule id under R5.

Every rule yields :class:`Violation` rows with ``file:line``, the rule
id, and a fix hint — the checker in :mod:`.check` applies suppressions
(R5) and renders them. The rules never import the audited modules; all
contract tables (``KNOBS``, ``SITES``, the compare/tune consumption
sets) come from :mod:`.harvest`'s static extraction, so a module whose
import would pull torch (or crash) is still fully checkable.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import PurePosixPath

from . import harvest
from .harvest import KNOB_TOKEN_RE, PyFile

CONFIG_REL = "exec/config.py"
COMPARE_REL = "telemetry/compare.py"
TUNE_REL = "exec/tune.py"
FAULTS_REL = "resilience/faults.py"
AGGREGATE_REL = "telemetry/aggregate.py"
SLO_REL = "telemetry/slo.py"
OBSERVABILITY_DOC = "docs/OBSERVABILITY.md"
RESILIENCE_DOC = "docs/RESILIENCE.md"

# area/name slash-path grammar for counter and histogram names: lowercase
# [a-z0-9_] segments, at least area + one name segment. Gauges and spans
# may be single-segment (gauge convention is `langdetect_*`; spans nest
# under an ambient parent, so a bare segment is a legal relative name).
_METRIC_NAME_RE = re.compile(r"[a-z0-9_]+(/[a-z0-9_]+)+")
_METRIC_PREFIX_RE = re.compile(r"[a-z0-9_]+/[a-z0-9_/]*")
_LOOSE_NAME_RE = re.compile(r"[a-z0-9_]+(/[a-z0-9_]+)*")

_BACKTICK_RE = re.compile(r"`([^`]+)`")


@dataclass(frozen=True)
class Violation:
    """One contract violation, anchored to a file:line."""

    rule: str
    file: str
    line: int
    message: str
    hint: str = ""


@dataclass
class Scan:
    """Everything harvested from one tree, keyed by package-relative path.

    ``files`` holds the package's own modules; ``extra_files`` sources
    scanned for violations but outside the package namespace
    (chip_smoke.py).
    ``docs`` maps repo-relative doc names to their text.
    """

    files: dict[str, PyFile] = field(default_factory=dict)
    extra_files: dict[str, PyFile] = field(default_factory=dict)
    docs: dict[str, str] = field(default_factory=dict)

    def all_files(self) -> dict[str, PyFile]:
        return {**self.files, **self.extra_files}

    def module_paths(self) -> set[str]:
        """Module-ish tokens (``serve/cache``, ``exec``) that must not be
        mistaken for metric names when they appear in doc prose."""
        out: set[str] = set()
        for rel in self.files:
            p = PurePosixPath(rel)
            stem = p.with_suffix("")
            out.add(str(stem))
            out.update(str(par) for par in stem.parents if str(par) != ".")
        return out


# ------------------------------------------------------------ doc slicing ---
def _doc_section(text: str, title_words: str) -> tuple[str, int]:
    """(section body, 1-based header line) of the ``## … <title words>``
    section; ("", 0) when the doc has no such section."""
    lines = text.splitlines()
    start = None
    for i, line in enumerate(lines):
        if line.startswith("##") and title_words.lower() in line.lower():
            start = i
            break
    if start is None:
        return "", 0
    end = len(lines)
    for j in range(start + 1, len(lines)):
        if lines[j].startswith("## "):
            end = j
            break
    return "\n".join(lines[start:end]), start + 1


# ------------------------------------------------------------------- R1 -----
def check_knob_discipline(scan: Scan) -> list[Violation]:
    """R1: every LANGDETECT_* read goes through exec/config; every knob
    literal has a KNOBS row; the OBSERVABILITY.md env table covers every
    knob."""
    out: list[Violation] = []
    knobs = harvest.knob_table(scan.files.get(CONFIG_REL))
    envs = {env for env, _line in knobs.values() if env}

    for rel, pf in scan.all_files().items():
        if rel == CONFIG_REL:
            continue  # the audited table itself — the one legal reader
        for line, env_name in pf.env_reads:
            out.append(Violation(
                "R1", rel, line,
                f"direct env read of {env_name} outside {CONFIG_REL}",
                "resolve the knob through exec.config.resolve(...) so "
                "/varz effective_config reports it; a genuinely "
                "pre-config read needs an allowlist entry with a reason",
            ))

    def check_tokens(rel: str, tokens) -> None:
        seen: set[tuple[int, str]] = set()
        for line, token, wildcard in tokens:
            if (line, token) in seen:
                continue
            seen.add((line, token))
            if wildcard:
                if not any(e.startswith(token) for e in envs):
                    out.append(Violation(
                        "R1", rel, line,
                        f"knob family {token}* matches no KNOBS row",
                        "fix the family spelling or add the knobs to "
                        "exec/config.KNOBS",
                    ))
            elif token not in envs:
                out.append(Violation(
                    "R1", rel, line,
                    f"knob literal {token} has no exec/config.KNOBS row",
                    "add a Knob(...) row (name, env, type, default) or "
                    "fix the spelling — a knob outside the table is "
                    "invisible to /varz and the tuner",
                ))

    for rel, pf in scan.all_files().items():
        check_tokens(rel, pf.knob_tokens)
    for rel, text in scan.docs.items():
        tokens = []
        for lineno, line in enumerate(text.splitlines(), start=1):
            for m in KNOB_TOKEN_RE.finditer(line):
                token = m.group(0)
                wildcard = token.endswith(("*", "_"))
                token = token.rstrip("*")
                if token == "LANGDETECT_":
                    continue
                tokens.append((lineno, token, wildcard))
        check_tokens(rel, tokens)

    obs = scan.docs.get(OBSERVABILITY_DOC)
    if obs is not None and envs:
        section, header_line = _doc_section(obs, "environment variables")
        covered_exact: set[str] = set()
        covered_prefix: set[str] = set()
        for m in KNOB_TOKEN_RE.finditer(section):
            token = m.group(0)
            if token.endswith(("*", "_")):
                prefix = token.rstrip("*")
                # A generic "every LANGDETECT_* knob" mention documents
                # nothing — only a named family narrows coverage.
                if prefix != "LANGDETECT_":
                    covered_prefix.add(prefix)
            else:
                covered_exact.add(token)
        for env in sorted(envs):
            if env in covered_exact:
                continue
            if any(env.startswith(p) for p in covered_prefix):
                continue
            out.append(Violation(
                "R1", OBSERVABILITY_DOC, header_line or 1,
                f"knob {env} missing from the environment-variable table",
                "add a row (or extend a family row) documenting the knob "
                "— the env table is the operator-facing contract for "
                "exec/config.KNOBS",
            ))
    return out


# ------------------------------------------------------------------- R2 -----
@dataclass
class _Emitted:
    counters: dict[str, tuple[str, int]] = field(default_factory=dict)
    counter_prefixes: dict[str, tuple[str, int]] = field(default_factory=dict)
    hists: dict[str, tuple[str, int]] = field(default_factory=dict)
    hist_prefixes: dict[str, tuple[str, int]] = field(default_factory=dict)
    gauges: dict[str, tuple[str, int]] = field(default_factory=dict)
    gauge_prefixes: dict[str, tuple[str, int]] = field(default_factory=dict)
    spans: dict[str, tuple[str, int]] = field(default_factory=dict)
    span_prefixes: dict[str, tuple[str, int]] = field(default_factory=dict)

    @staticmethod
    def collect(scan: Scan) -> "_Emitted":
        em = _Emitted()
        for rel, pf in scan.all_files().items():
            for attr in (
                "counters", "counter_prefixes", "hists", "hist_prefixes",
                "gauges", "gauge_prefixes", "spans", "span_prefixes",
            ):
                table = getattr(em, attr)
                for name, line in getattr(pf.emits, attr).items():
                    table.setdefault(name, (rel, line))
        return em

    def _known(self, names, prefixes, name: str) -> bool:
        if name in names:
            return True
        return any(name.startswith(p) for p in prefixes)

    def counter(self, name: str) -> bool:
        return self._known(self.counters, self.counter_prefixes, name)

    def hist(self, name: str) -> bool:
        return self._known(self.hists, self.hist_prefixes, name)

    def gauge(self, name: str) -> bool:
        return self._known(self.gauges, self.gauge_prefixes, name)

    def span(self, name: str) -> bool:
        """Spans nest under an ambient parent, so a doc'd full path
        (``score/dispatch``) matches an emitted *relative* name
        (``dispatch``) only as a whole-segment suffix — matching on the
        last segment alone would let any doc'd ghost sharing a leaf name
        with a real span slip through."""
        if self._known(self.spans, self.span_prefixes, name):
            return True
        return any(name.endswith("/" + s) for s in self.spans)

    def any_prefix_overlap(self, prefix: str) -> bool:
        """≥1 emitted name (any kind) under ``prefix``."""
        for table in (self.counters, self.hists, self.gauges, self.spans):
            if any(n.startswith(prefix) for n in table):
                return True
        for table in (
            self.counter_prefixes, self.hist_prefixes,
            self.gauge_prefixes, self.span_prefixes,
        ):
            if any(
                p.startswith(prefix) or prefix.startswith(p) for p in table
            ):
                return True
        return False


def check_telemetry_names(scan: Scan) -> list[Violation]:
    """R2: consumed names are emitted; emitted names parse; doc'd metric
    names exist."""
    out: list[Violation] = []
    em = _Emitted.collect(scan)
    cc = harvest.compare_contracts(scan.files.get(COMPARE_REL))
    tune = harvest.tune_consumed(scan.files.get(TUNE_REL))
    sites = harvest.fault_sites(scan.files.get(FAULTS_REL))

    # --- consumed-but-never-emitted --------------------------------------
    for name, line in sorted(cc.tracked_gauges.items()):
        if not em.gauge(name):
            out.append(Violation(
                "R2", COMPARE_REL, line,
                f"_TRACKED_GAUGES consumes gauge {name!r} no code emits",
                "emit it via REGISTRY.set_gauge or drop the tracked row — "
                "a tracked metric that never appears can't guard anything",
            ))
    for name, line in sorted(cc.tracked_ratio_counters.items()):
        if not em.counter(name):
            out.append(Violation(
                "R2", COMPARE_REL, line,
                f"_TRACKED_RATIOS consumes counter {name!r} no code emits",
                "emit it via REGISTRY.incr or fix the ratio definition",
            ))
    for name, line in sorted(cc.reliability_counters.items()):
        if not em.counter(name):
            out.append(Violation(
                "R2", COMPARE_REL, line,
                f"reliability counter {name!r} is diffed but never emitted",
                "emit it via REGISTRY.incr or drop it from "
                "_RELIABILITY_COUNTERS",
            ))
    for name, line in sorted(cc.informational_counters.items()):
        if not em.counter(name):
            out.append(Violation(
                "R2", COMPARE_REL, line,
                f"informational counter {name!r} is diffed but never "
                "emitted",
                "emit it via REGISTRY.incr or drop it from "
                "_INFORMATIONAL_COUNTERS",
            ))
    for prefix, line in sorted(cc.reliability_prefixes.items()):
        if not em.any_prefix_overlap(prefix):
            out.append(Violation(
                "R2", COMPARE_REL, line,
                f"reliability prefix {prefix!r} matches no emitted counter",
                "emit at least one counter under the prefix or drop it "
                "from _RELIABILITY_COUNTER_PREFIXES",
            ))
    for name, line in sorted(cc.cold_start_histograms.items()):
        if not em.hist(name):
            out.append(Violation(
                "R2", COMPARE_REL, line,
                f"cold-start histogram {name!r} is diffed but never "
                "emitted",
                "emit it via REGISTRY.observe or drop it from "
                "_COLD_START_HISTOGRAMS",
            ))
    for name, (line, kind, is_prefix) in sorted(tune.items()):
        if is_prefix:
            ok = em.any_prefix_overlap(name)
        elif kind == "histogram":
            ok = em.hist(name)
        else:
            ok = em.counter(name)
        if not ok:
            out.append(Violation(
                "R2", TUNE_REL, line,
                f"tune replays {kind} {name!r} no code emits",
                "the autotuner's input signal must be recorded somewhere "
                "— emit it or stop consuming it",
            ))

    # --- fleet observability plane (aggregate + slo) ----------------------
    # The cross-process surface: names the collector's pressure readers
    # sum and the SLO layer differentiates live in other processes, so a
    # rename at the emit site would silently zero the autoscaler's
    # pressure signal rather than crash anything. Same treatment as the
    # compare/tune tables above — consumed names must be emitted — plus
    # one extra bolt: the collector's guard counters must stay pinned in
    # compare's tables, or a scrape-failure regression stops gating.
    fc = harvest.fleet_contracts(
        scan.files.get(AGGREGATE_REL), scan.files.get(SLO_REL)
    )
    for name, line in sorted(fc.consumed_counters.items()):
        if not em.counter(name):
            out.append(Violation(
                "R2", AGGREGATE_REL, line,
                f"fleet aggregate consumes counter {name!r} no code emits",
                "the collector sums this across scraped replicas and the "
                "autoscaler sheds-pressure reads it — emit it via "
                "REGISTRY.incr or drop it from CONSUMED_COUNTERS",
            ))
    for name, line in sorted(fc.slo_counters.items()):
        if not em.counter(name):
            out.append(Violation(
                "R2", SLO_REL, line,
                f"SLO objective consumes counter {name!r} no code emits",
                "a burn rate over a never-emitted counter is identically "
                "zero — emit it or drop it from SLO_INPUT_COUNTERS",
            ))
    for name, line in sorted(fc.slo_histograms.items()):
        if not em.hist(name):
            out.append(Violation(
                "R2", SLO_REL, line,
                f"SLO objective consumes histogram {name!r} no code emits",
                "emit it via REGISTRY.observe or drop it from "
                "SLO_INPUT_HISTOGRAMS",
            ))
    for name, line in sorted(fc.slo_gauges.items()):
        if not em.gauge(name):
            out.append(Violation(
                "R2", SLO_REL, line,
                f"SLO objective consumes gauge {name!r} no code emits",
                "emit it via REGISTRY.set_gauge or drop it from "
                "SLO_INPUT_GAUGES",
            ))
    compare_tracked = set(cc.reliability_counters) | set(
        cc.informational_counters
    )
    for name, line in sorted(fc.guard_counters.items()):
        if not em.counter(name):
            out.append(Violation(
                "R2", AGGREGATE_REL, line,
                f"collector guard counter {name!r} is never emitted",
                "emit it via REGISTRY.incr or drop it from GUARD_COUNTERS",
            ))
        if name not in compare_tracked and not any(
            name.startswith(p) for p in cc.reliability_prefixes
        ):
            out.append(Violation(
                "R2", AGGREGATE_REL, line,
                f"collector guard counter {name!r} is not tracked by "
                f"{COMPARE_REL}",
                "pin it in _RELIABILITY_COUNTERS (gates regressions) or "
                "_INFORMATIONAL_COUNTERS (operator signal) — an untracked "
                "guard counter can appear against a clean baseline "
                "without compare noticing",
            ))

    # --- grammar ----------------------------------------------------------
    for name, (rel, line) in sorted(em.counters.items()):
        if not _METRIC_NAME_RE.fullmatch(name):
            out.append(Violation(
                "R2", rel, line,
                f"counter name {name!r} breaks the area/name slash-path "
                "grammar",
                "use lowercase [a-z0-9_] segments with at least area/name",
            ))
    for name, (rel, line) in sorted(em.hists.items()):
        if not _METRIC_NAME_RE.fullmatch(name):
            out.append(Violation(
                "R2", rel, line,
                f"histogram name {name!r} breaks the area/name slash-path "
                "grammar",
                "use lowercase [a-z0-9_] segments with at least area/name",
            ))
    for table in (em.counter_prefixes, em.hist_prefixes):
        for prefix, (rel, line) in sorted(table.items()):
            if not _METRIC_PREFIX_RE.fullmatch(prefix):
                out.append(Violation(
                    "R2", rel, line,
                    f"dynamic metric name head {prefix!r} breaks the "
                    "area/name grammar",
                    "f-string metric names must start with a literal "
                    "area/ head so consumers can match the family",
                ))
    for table in (em.gauges, em.spans):
        for name, (rel, line) in sorted(table.items()):
            if not _LOOSE_NAME_RE.fullmatch(name):
                out.append(Violation(
                    "R2", rel, line,
                    f"telemetry name {name!r} breaks the naming grammar",
                    "lowercase [a-z0-9_] segments, optionally slash-nested",
                ))

    # --- docs reference only names that exist -----------------------------
    obs = scan.docs.get(OBSERVABILITY_DOC)
    if obs is not None:
        derived = set(cc.tracked_ratio_names)
        skip = scan.module_paths() | set(sites)
        for title in ("span naming", "histograms and counters"):
            section, header_line = _doc_section(obs, title)
            if not section:
                continue
            offset = header_line - 1
            for lineno, line in enumerate(section.splitlines(), start=1):
                for m in _BACKTICK_RE.finditer(line):
                    token = m.group(1)
                    v = _check_doc_metric(
                        token, em, derived, skip,
                        OBSERVABILITY_DOC, offset + lineno,
                    )
                    if v is not None:
                        out.append(v)
    return out


def _check_doc_metric(
    token: str,
    em: _Emitted,
    derived: set[str],
    skip: set[str],
    doc: str,
    line: int,
) -> Violation | None:
    if any(c in token for c in "[]= ,\"'"):
        return None
    token = token.split("{")[0]
    prefix_mode = False
    if "<" in token:
        token, prefix_mode = token.split("<")[0], True
    if token.endswith("*"):
        token, prefix_mode = token.rstrip("*"), True
    if token in skip or token.rstrip("/") in skip:
        return None
    if prefix_mode:
        if not re.fullmatch(r"[a-z0-9_]+/[a-z0-9_/]*", token):
            return None
        if not em.any_prefix_overlap(token):
            return Violation(
                "R2", doc, line,
                f"doc references metric family {token!r}* no code emits",
                "fix the doc row or emit the family",
            )
        return None
    is_gauge_name = re.fullmatch(r"langdetect_[a-z0-9_]+", token)
    is_slash_name = _METRIC_NAME_RE.fullmatch(token)
    if not is_gauge_name and not is_slash_name:
        return None
    if token in derived:
        return None  # compare-derived contract metric (cache/hit_rate)
    if is_gauge_name:
        if em.gauge(token):
            return None
    elif (
        em.counter(token) or em.hist(token)
        or em.gauge(token) or em.span(token)
    ):
        return None
    return Violation(
        "R2", doc, line,
        f"doc references metric {token!r} that no code emits",
        "fix or remove the doc row — the metric tables must describe "
        "what the registry actually carries",
    )


# ------------------------------------------------------------------- R3 -----
def check_fault_sites(scan: Scan) -> list[Violation]:
    """R3: inject literals ∈ SITES; SITES all injected; SITES all in
    RESILIENCE.md §4."""
    out: list[Violation] = []
    sites = harvest.fault_sites(scan.files.get(FAULTS_REL))
    if not sites:
        return out
    used: set[str] = set()
    for rel, pf in scan.all_files().items():
        for line, site in pf.injects:
            used.add(site)
            if site not in sites:
                out.append(Violation(
                    "R3", rel, line,
                    f"faults.inject site {site!r} is not in "
                    "resilience/faults.SITES",
                    "add the site to SITES (and RESILIENCE.md §4) or fix "
                    "the literal — an unregistered site can never fire, "
                    "so its chaos coverage silently vanishes",
                ))
    for site, line in sorted(sites.items()):
        if site not in used:
            out.append(Violation(
                "R3", FAULTS_REL, line,
                f"SITES entry {site!r} has no inject() call site",
                "hook the site or retire the row — a dead registry entry "
                "lets chaos plans 'pass' without testing anything",
            ))
    res = scan.docs.get(RESILIENCE_DOC)
    if res is not None:
        section, header_line = _doc_section(res, "fault injection")
        for site, _line in sorted(sites.items()):
            if site not in section:
                out.append(Violation(
                    "R3", RESILIENCE_DOC, header_line or 1,
                    f"fault site {site!r} is undocumented in the fault-"
                    "injection section",
                    "describe the site (where it hooks, what a firing "
                    "error means) in RESILIENCE.md §4",
                ))
    return out


# ------------------------------------------------------------- assembly -----
def run_rules(scan: Scan) -> list[Violation]:
    out: list[Violation] = []
    out += check_knob_discipline(scan)
    out += check_telemetry_names(scan)
    out += check_fault_sites(scan)
    for rel, pf in scan.all_files().items():
        if pf.parse_error:
            out.append(Violation(
                "R5", rel, 1,
                f"unparseable source: {pf.parse_error}",
                "the checker cannot prove contracts it cannot parse",
            ))
    out.sort(key=lambda v: (v.file, v.line, v.rule, v.message))
    return out
