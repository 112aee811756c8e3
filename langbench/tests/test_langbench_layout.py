"""BENCHMARK.json resolves by name, and the harness keeps its imports."""

import ast
import json
from pathlib import Path

import pytest

from langbench import harness

ROOT = harness.CHECKOUT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PKG = ROOT / "langbench"


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def _harness_files():
    return [p for p in PKG.rglob("*.py") if "tests" not in p.relative_to(PKG).parts]


def test_nothing_imports_jax_or_the_jax_package():
    for path in _harness_files():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "spark_languagedetector_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "numpy", "torch"}, (path, tops)


def test_only_program_py_imports_the_program():
    for path in _harness_files():
        tops = {m.split(".")[0] for m in _imports(path)}
        if "spark_languagedetector_tpu_torch" in tops:
            assert path.name == "program.py", path


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_resolves_by_name(cell):
    plan = harness.cell_plan(BENCH, cell)
    assert (PKG / "entries" / f"{plan['mix']['entry']}.py").is_file()
    assert (PKG / "limits" / f"{cell}.json").is_file()
    for m in plan["end_to_end"] + plan["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    names = {m["name"] for m in plan["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and plan["per_layer"]


def test_each_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_config_files_state_their_sizes():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for key in ("languages", "gramLengths", "vocabMode", "languageProfileSize", "dtype",
                    "training", "fitBackend", "assumed"):
            assert key in cfg, (c["name"], key)
