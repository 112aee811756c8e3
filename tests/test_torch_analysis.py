"""The port's contract checker (``spark_languagedetector_tpu_torch.analysis``)
against the JAX package's (``tests/test_analysis.py``).

* The gate: the checker is clean on the shipped port tree (the port's
  package, ``chip_smoke.py``, and ``docs/*.md`` and ``README.md`` as they
  are), and every allowlist entry is live; the allowlist holds the two
  kinds of entry it is allowed: the logging bootstrap read and the XLA-only
  ``jax/*`` doc names.
* On the analysis fixture tree (``tests/fixtures/analysis``, read only) the
  port's checker and the JAX checker report the same R1, R2, R3 and R5
  violations; R4 has no counterpart in the port (it traces nothing), so a
  pragma naming it is an unknown rule under R5.
* Suppression semantics, the JSON schema (the JAX checker's) and the CLI,
  in a subprocess where ``jax`` cannot be imported.
* The router's two fault sites are literal ``inject()`` calls the checker
  sees, and the fleet drills still fire each.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import pytest

from spark_languagedetector_tpu.analysis import run_checks as jax_run_checks
from spark_languagedetector_tpu.analysis.check import RULE_IDS as JAX_RULE_IDS
from spark_languagedetector_tpu_torch.analysis import run_checks
from spark_languagedetector_tpu_torch.analysis import harvest
from spark_languagedetector_tpu_torch.analysis.allowlist import ALLOWLIST, Allow
from spark_languagedetector_tpu_torch.analysis.check import (
    JSON_SCHEMA_VERSION,
    RULE_IDS,
    SCHEMA_RULE_IDS,
    main as check_main,
)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "spark_languagedetector_tpu_torch"
FIXTURE_ROOT = Path(__file__).resolve().parent / "fixtures" / "analysis" / "repo"
FIXTURE_PKG = FIXTURE_ROOT / "fixture_pkg"
BLOCK_JAX = (
    "import sys\n"
    "for name in ('jax', 'jaxlib', 'spark_languagedetector_tpu'):\n"
    "    sys.modules[name] = None\n"
)


@pytest.fixture(scope="module")
def fixture_report():
    return run_checks(package_dir=FIXTURE_PKG, repo_root=FIXTURE_ROOT, allowlist=())


def _find(report, rule, file_part, message_part):
    return [v for v in report.violations
            if v.rule == rule and file_part in v.file and message_part in v.message]


def _rows(report, rules):
    return sorted((v.rule, v.file, v.line, v.message) for v in report.violations
                  if v.rule in rules)


# ---------------------------------------------------------------- the gate --
def test_shipped_tree_is_clean():
    report = run_checks(package_dir=PACKAGE, repo_root=REPO)
    rendered = "\n".join(f"{v.rule} {v.file}:{v.line}  {v.message}" for v in report.violations)
    assert report.ok, f"contract violations in the shipped port tree:\n{rendered}"


def test_shipped_tree_suppressions_are_live_and_only_the_two_kinds():
    report = run_checks(package_dir=PACKAGE, repo_root=REPO)
    used = {s["reason"] for s in report.suppressed if s["via"] == "allowlist"}
    assert {a.reason for a in ALLOWLIST} == used
    assert [(a.rule, a.file) for a in ALLOWLIST] == [
        ("R1", "utils/logging.py"), ("R2", "docs/OBSERVABILITY.md")]
    jax_names = [s for s in report.suppressed if s["via"] == "allowlist" and s["rule"] == "R2"]
    assert jax_names and all("'jax/" in s["message"] for s in jax_names)
    assert len(jax_names) <= ALLOWLIST[1].count
    assert not [s for s in report.suppressed if s["via"] == "pragma"]


def test_the_jax_checker_finds_the_same_over_the_port_tree():
    """The JAX checker's rules over the port's tree report exactly what the
    port's allowlist suppresses (and the JAX allowlist's own logging entry
    hides its one R1)."""
    from spark_languagedetector_tpu.analysis import check as jcheck
    from spark_languagedetector_tpu.analysis import rules as jrules

    raw = jrules.run_rules(jcheck.build_scan(PACKAGE, REPO))
    mine = run_checks(package_dir=PACKAGE, repo_root=REPO)
    assert sorted((v.rule, v.file, v.line, v.message) for v in raw) == sorted(
        (s["rule"], s["file"], s["line"], s["message"]) for s in mine.suppressed)


def test_gate_catches_a_raw_env_read(tmp_path):
    pkg = tmp_path / "spark_languagedetector_tpu_torch"
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    target = pkg / "parallel" / "distributed.py"
    target.write_text(target.read_text() + "\nimport os\n_RAW = "
                      "os.environ.get('LANGDETECT_TPU_COORDINATOR')\n")
    report = run_checks(package_dir=pkg, repo_root=None)
    assert _find(report, "R1", "parallel/distributed.py", "direct env read")


# ------------------------------------------------- parity with the JAX one --
def test_fixture_tree_reports_what_the_jax_checker_reports(fixture_report):
    jax_report = jax_run_checks(package_dir=FIXTURE_PKG, repo_root=FIXTURE_ROOT, allowlist=())
    shared = ("R1", "R2", "R3", "R5")
    assert _rows(fixture_report, shared) == _rows(jax_report, shared)
    assert [s["line"] for s in fixture_report.suppressed] == [
        s["line"] for s in jax_report.suppressed]
    # Every rule family fires on the fixture, in both.
    assert {v.rule for v in fixture_report.violations} == set(shared)
    assert not [v for v in fixture_report.violations if v.rule == "R4"]
    assert [v for v in jax_report.violations if v.rule == "R4"]


@pytest.mark.parametrize("rule,file_part,message_part", [
    ("R1", "r1_env.py", "direct env read of LANGDETECT_GHOST_KNOB"),
    ("R1", "r1_env.py", "direct env read of LANGDETECT_BETA"),
    ("R1", "r1_env.py", "knob literal LANGDETECT_GHOST_KNOB has no exec/config.KNOBS row"),
    ("R1", "docs/OBSERVABILITY.md", "LANGDETECT_BETA missing from the environment-variable"),
    ("R2", "telemetry/compare.py", "langdetect_ghost_gauge"),
    ("R2", "telemetry/compare.py", "ghost/ratio_counter"),
    ("R2", "telemetry/compare.py", "ghostarea/"),
    ("R2", "exec/tune.py", "ghost/tuner_counter"),
    ("R2", "r2_names.py", "BadGrammarName"),
    ("R2", "docs/OBSERVABILITY.md", "'ghost/pack'"),
    ("R3", "r3_sites.py", "site 'not/a_site' is not in resilience/faults.SITES"),
    ("R3", "resilience/faults.py", "SITES entry 'ghost/site' has no inject() call site"),
    ("R3", "docs/RESILIENCE.md", "fault site 'ghost/site' is undocumented"),
    ("R5", "r5_pragmas.py", "stale suppression pragma"),
    ("R5", "r5_pragmas.py", "unknown rule id"),
])
def test_each_rule_fires_on_the_fixture(fixture_report, rule, file_part, message_part):
    assert _find(fixture_report, rule, file_part, message_part)


def test_a_pragma_naming_r4_is_an_unknown_rule(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text("import os\nX = os.getenv('LANGDETECT_X')  "
                              "# contract: ignore[R4] -- the port has no R4\n")
    report = run_checks(package_dir=pkg, repo_root=None, allowlist=())
    assert _find(report, "R5", "m.py", "unknown rule id(s) ['R4']")
    assert _find(report, "R1", "m.py", "direct env read of LANGDETECT_X")
    assert "R4" in JAX_RULE_IDS and "R4" not in RULE_IDS


def test_suppression_is_bounded_and_staleness_is_a_violation():
    live = Allow("R1", "r1_env.py", "LANGDETECT_ALPHA", "fixture: live entry")
    stale = Allow("R1", "no_such_file.py", "never matches", "fixture: stale entry")
    report = run_checks(package_dir=FIXTURE_PKG, repo_root=FIXTURE_ROOT,
                        allowlist=(live, stale))
    assert any(s["via"] == "allowlist" and s["reason"] == live.reason
               for s in report.suppressed)
    assert _find(report, "R5", "analysis/allowlist.py", "stale allowlist")
    broad = Allow("R1", "r1_env.py", "direct env read", "fixture: broad")
    report = run_checks(package_dir=FIXTURE_PKG, repo_root=FIXTURE_ROOT, allowlist=(broad,))
    assert len([s for s in report.suppressed if s["via"] == "allowlist"]) == 1
    assert _find(report, "R1", "r1_env.py", "direct env read")
    pragmas = [s for s in report.suppressed if s["via"] == "pragma"]
    assert len(pragmas) == 2  # same-line and pragma-above forms


# -------------------------------------------------------------- JSON + CLI --
def test_json_schema_is_the_jax_checkers(fixture_report):
    doc = fixture_report.to_json()
    jdoc = jax_run_checks(package_dir=FIXTURE_PKG, repo_root=FIXTURE_ROOT,
                          allowlist=()).to_json()
    assert set(doc) == set(jdoc)
    assert doc["schema"] == jdoc["schema"] == JSON_SCHEMA_VERSION
    assert set(doc["counts"]) == set(jdoc["counts"]) == set(SCHEMA_RULE_IDS)
    assert doc["counts"]["R4"] == 0
    assert sum(doc["counts"].values()) == doc["total"] == len(doc["violations"]) > 0
    for v in doc["violations"]:
        assert set(v) == {"rule", "file", "line", "message", "hint"}
    json.dumps(doc)


def _cli(args, cwd, tmp_path):
    blocker = tmp_path / "blocker"
    blocker.mkdir(exist_ok=True)
    (blocker / "sitecustomize.py").write_text(BLOCK_JAX)
    import os

    path = [str(blocker), str(REPO), os.environ.get("PYTHONPATH", "")]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in path if p)}
    return subprocess.run(
        [sys.executable, "-m", "spark_languagedetector_tpu_torch.analysis.check", *args],
        cwd=cwd, capture_output=True, text=True, timeout=60, env=env,
    )


def test_cli_exit_codes_without_jax(tmp_path):
    res = _cli(["--json"], REPO, tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(res.stdout)
    assert doc["ok"] is True and doc["schema"] == JSON_SCHEMA_VERSION
    bad = tmp_path / "tree"
    (bad / "spark_languagedetector_tpu_torch").mkdir(parents=True)
    (bad / "spark_languagedetector_tpu_torch" / "bad.py").write_text(
        "import os\nX = os.environ.get('LANGDETECT_WHATEVER')\n")
    res = _cli(["--root", str(bad), "--json"], tmp_path, tmp_path)
    assert res.returncode == 1, res.stdout + res.stderr
    assert any(v["rule"] == "R1" and v["file"] == "bad.py"
               for v in json.loads(res.stdout)["violations"])
    assert check_main(["--root", str(FIXTURE_ROOT)]) == 2
    assert check_main(["--no-such-flag"]) == 2


# ------------------------------------------------------ the router's sites --
def test_router_injects_both_fleet_sites_literally():
    pf = harvest.harvest_file(PACKAGE / "serve" / "router.py", "serve/router.py")
    assert {"fleet/dispatch", "fleet/hedge"} <= {site for _, site in pf.injects}


@pytest.mark.parametrize("site", ["fleet/dispatch", "fleet/hedge"])
def test_fleet_drills_still_fire_each_router_site(site):
    """A plan on each site fails exactly its kind of attempt: a dispatch
    fault fails the first attempt and the request fails over; a hedge
    fault fails the hedge and the primary answers."""
    from spark_languagedetector_tpu_torch.resilience import faults
    from spark_languagedetector_tpu_torch.serve.router import FleetRouter

    calls = []

    class Client:
        def __init__(self, name):
            self.name = name

        def detect(self, texts, **kw):
            calls.append(self.name)
            return ["en"] * len(texts), {"replica": self.name}

    router = FleetRouter.__new__(FleetRouter)
    handle = type("H", (), {"name": "r0", "client": Client("r0")})()
    released = []
    router._lock = __import__("threading").Lock()
    router._lat = []
    router._release = lambda h, rows: released.append(h.name)
    plan = faults.FaultPlan.parse(f"seed=1;{site}:error@1")
    with faults.plan_scope(plan):
        with pytest.raises(faults.InjectedFault):
            router._call_one(handle, ["x"], rows=1, attempt=0, hedge=site == "fleet/hedge",
                             want_labels=True, segment_kw=None, priority="interactive",
                             deadline_ms=None, trace_id="t", tenant=None)
        out, _ = router._call_one(handle, ["x"], rows=1, attempt=1,
                                  hedge=site == "fleet/hedge", want_labels=True,
                                  segment_kw=None, priority="interactive", deadline_ms=None,
                                  trace_id="t", tenant=None)
    assert out == ["en"] and calls == ["r0"] and released == ["r0", "r0"]
