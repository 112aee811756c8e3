"""Contract checker CLI + orchestration.

    python -m spark_languagedetector_tpu_torch.analysis.check [--json] [--root DIR]

Port of ``spark_languagedetector_tpu.analysis.check`` over the port's tree.
Scans the package source (plus ``chip_smoke.py`` and the ``docs/`` tables
and ``README.md`` as they are, when run from a repo checkout), applies the
R1, R2 and R3 rule families from :mod:`.rules`, then the R5 suppression
pass: inline
``# contract: ignore[R?] -- reason`` pragmas and the checked-in
:mod:`.allowlist`, where a suppression that no longer suppresses anything
is itself a violation. Exit 0 = clean, 1 = unsuppressed violations,
2 = usage error. ``--json`` emits the machine-readable report (schema
pinned by tests/test_analysis.py) for external CI.

The report's JSON schema and the exit codes are the JAX checker's, so
either package's tools read the other's report; ``counts`` keeps a zero R4
entry (:data:`SCHEMA_RULE_IDS`), the rule the port has no counterpart of.

Pure stdlib and purely static: the rules parse the modules they audit and
never import them, never import jax, and do no device work.
"""

from __future__ import annotations

import json
import sys
from dataclasses import asdict, dataclass, field
from pathlib import Path

from . import harvest, rules
from .allowlist import ALLOWLIST, Allow
from .rules import Scan, Violation

# The rules that run here (and that a pragma may name), and the rule ids of
# the JSON schema, the JAX checker's.
RULE_IDS = ("R1", "R2", "R3", "R5")
SCHEMA_RULE_IDS = ("R1", "R2", "R3", "R4", "R5")
REPO_EXTRA = "chip_smoke.py"
PACKAGE_NAME = "spark_languagedetector_tpu_torch"
JSON_SCHEMA_VERSION = 1

# Doc files whose tables are part of the contract surface. Anything
# matching docs/*.md and README.md is scanned for knob literals; these
# two additionally carry table-sync rules (R1 env table, R2 metric
# tables, R3 site table).
_DOC_GLOBS = ("docs/*.md", "README.md")


@dataclass
class Report:
    """One checker run's outcome."""

    package: str
    violations: list[Violation] = field(default_factory=list)
    suppressed: list[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def counts(self) -> dict[str, int]:
        out = {r: 0 for r in SCHEMA_RULE_IDS}
        for v in self.violations:
            out[v.rule] = out.get(v.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "schema": JSON_SCHEMA_VERSION,
            "package": self.package,
            "ok": self.ok,
            "total": len(self.violations),
            "counts": self.counts(),
            "violations": [asdict(v) for v in self.violations],
            "suppressed": list(self.suppressed),
        }

    def render(self) -> str:
        lines = []
        for v in self.violations:
            lines.append(f"{v.rule} {v.file}:{v.line}  {v.message}")
            if v.hint:
                lines.append(f"     hint: {v.hint}")
        counts = ", ".join(
            f"{r}={n}" for r, n in self.counts().items() if n
        )
        if self.violations:
            lines.append(
                f"{len(self.violations)} unsuppressed violation(s) "
                f"({counts}); {len(self.suppressed)} suppressed"
            )
        else:
            lines.append(
                f"contracts hold: 0 unsuppressed violations "
                f"({len(self.suppressed)} suppressed)"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------- scan ------
def build_scan(
    package_dir: Path,
    repo_root: Path | None = None,
) -> Scan:
    """Harvest a package tree (+ the repo-level extras when present)."""
    scan = Scan()
    for path in sorted(package_dir.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(package_dir).as_posix()
        scan.files[rel] = harvest.harvest_file(path, rel)
    if repo_root is not None:
        extra = repo_root / REPO_EXTRA
        if extra.is_file():
            scan.extra_files[REPO_EXTRA] = harvest.harvest_file(
                extra, REPO_EXTRA
            )
        for glob in _DOC_GLOBS:
            for path in sorted(repo_root.glob(glob)):
                rel = path.relative_to(repo_root).as_posix()
                scan.docs[rel] = path.read_text(encoding="utf-8")
    return scan


# --------------------------------------------------------- suppression ------
def _apply_suppressions(
    scan: Scan,
    violations: list[Violation],
    allowlist: tuple[Allow, ...],
) -> tuple[list[Violation], list[dict]]:
    """(surviving violations, suppressed records) + R5 staleness rows.

    A pragma suppresses a violation of a named rule on its own line or
    the line directly below (pragma-above style). Every pragma and every
    allowlist entry must suppress at least one raw violation — a stale
    suppression hides nothing and therefore *is* a violation (R5), which
    is what keeps the suppression surface honest as code moves. An
    allowlist entry suppresses at most ``count`` matches (default one),
    so a NEW violation that happens to match an existing entry's pattern
    still surfaces instead of riding the documented exception.
    """
    files = scan.all_files()
    used_pragmas: set[tuple[str, int]] = set()
    used_allows: dict[int, int] = {}
    remaining: list[Violation] = []
    suppressed: list[dict] = []

    for v in violations:
        pf = files.get(v.file)
        handled = False
        if pf is not None:
            for pline in (v.line, v.line - 1):
                pragma = pf.pragmas.get(pline)
                if pragma and v.rule in pragma[0]:
                    used_pragmas.add((v.file, pline))
                    suppressed.append({
                        **asdict(v), "via": "pragma", "reason": pragma[1],
                    })
                    handled = True
                    break
        if not handled:
            for i, allow in enumerate(allowlist):
                if (
                    allow.rule == v.rule
                    and v.file.endswith(allow.file)
                    and allow.match in v.message
                    and used_allows.get(i, 0) < allow.count
                ):
                    used_allows[i] = used_allows.get(i, 0) + 1
                    suppressed.append({
                        **asdict(v), "via": "allowlist",
                        "reason": allow.reason,
                    })
                    handled = True
                    break
        if not handled:
            remaining.append(v)

    for rel, pf in files.items():
        for line, (rule_ids, _reason) in sorted(pf.pragmas.items()):
            bogus = [r for r in rule_ids if r not in RULE_IDS]
            if bogus:
                remaining.append(Violation(
                    "R5", rel, line,
                    f"pragma names unknown rule id(s) {bogus}",
                    f"rule ids are {', '.join(RULE_IDS)}",
                ))
            elif (rel, line) not in used_pragmas:
                remaining.append(Violation(
                    "R5", rel, line,
                    "stale suppression pragma: it suppresses nothing",
                    "the violation it covered is gone — delete the pragma "
                    "so the suppression surface tracks reality",
                ))
    for i, allow in enumerate(allowlist):
        if allow.rule not in RULE_IDS:
            remaining.append(Violation(
                "R5", "analysis/allowlist.py", 1,
                f"allowlist entry names unknown rule id {allow.rule!r}",
                f"rule ids are {', '.join(RULE_IDS)}",
            ))
        elif i not in used_allows:
            remaining.append(Violation(
                "R5", "analysis/allowlist.py", 1,
                f"stale allowlist entry ({allow.rule} {allow.file!r} "
                f"matching {allow.match!r}) suppresses nothing",
                "the exception it documented is gone — remove the entry",
            ))
    remaining.sort(key=lambda v: (v.file, v.line, v.rule, v.message))
    return remaining, suppressed


# ----------------------------------------------------------- entry points ---
def run_checks(
    package_dir: Path | None = None,
    repo_root: Path | None = None,
    allowlist: tuple[Allow, ...] | None = None,
) -> Report:
    """Run every rule family over ``package_dir`` and return the report.

    Defaults audit this installed package itself, with the repo-checkout
    extras (chip_smoke.py, docs tables) when the package sits inside one.
    """
    if package_dir is None:
        package_dir = Path(__file__).resolve().parent.parent
    if repo_root is None:
        candidate = package_dir.parent
        if (candidate / "docs").is_dir():
            repo_root = candidate
    if allowlist is None:
        allowlist = ALLOWLIST
    scan = build_scan(package_dir, repo_root)
    raw = rules.run_rules(scan)
    remaining, suppressed = _apply_suppressions(scan, raw, allowlist)
    return Report(
        package=str(package_dir), violations=remaining,
        suppressed=suppressed,
    )


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    as_json = False
    root: Path | None = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--json":
            as_json = True
            i += 1
        elif a == "--root":
            if i + 1 >= len(argv):
                print("error: --root needs a directory", file=sys.stderr)
                return 2
            root = Path(argv[i + 1])
            i += 2
        elif a in ("-h", "--help"):
            print(
                "usage: python -m spark_languagedetector_tpu_torch.analysis."
                "check [--json] [--root DIR]\n\n"
                "Static contract checker of the PyTorch port: knob "
                "discipline, telemetry name contract, fault-site "
                "registry, suppression audit.",
            )
            return 0
        else:
            print(f"error: unknown option {a!r}", file=sys.stderr)
            return 2
    if root is not None:
        package_dir = root / PACKAGE_NAME
        if not package_dir.is_dir():
            print(
                f"error: {package_dir} is not a package checkout",
                file=sys.stderr,
            )
            return 2
        report = run_checks(package_dir, root)
    else:
        report = run_checks()
    if as_json:
        print(json.dumps(report.to_json(), indent=2, sort_keys=True))
    else:
        print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
