"""Fixtures of the benchmark's own tests: a cell's plan shrunk to a size the
CPU runs in seconds (the same entry points, reference and comparisons as a
measured run; only the sizes differ)."""

import copy
import json

import pytest

from langbench import harness

BENCH = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def cells_of(entry: str) -> list[str]:
    """The workloads whose mix drives ``entry``."""
    return [c for c in CELLS if harness.cell_plan(BENCH, c)["mix"]["entry"] == entry]


def shrink(plan: dict) -> dict:
    plan = copy.deepcopy(plan)
    c = plan["config"]
    c.update(languages=8, languageProfileSize=60,
             training={"docs_per_language": 6, "lengths": {"mean": 400, "sd": 100, "min": 30}})
    if c["vocabMode"] == "hashed":
        c["hashBits"] = 18
    m = plan["mix"]
    if m["entry"] == "transform":
        m.update(docs_per_call=64, pool_docs=128)
        if "long" in m:
            m["long"] = dict(m["long"], every=16, mean=5000, sd=1000)
    else:
        m.update(docs_per_language=10)
    return plan


@pytest.fixture
def tiny_plan():
    """``tiny_plan(workload)``: the workload's plan at a CPU size."""
    return lambda workload: shrink(harness.cell_plan(BENCH, workload))


@pytest.fixture
def tiny_run(tiny_plan):
    """``tiny_run(workload, trace=False)``: one run on the CPU, the result."""

    def run(workload, trace=False, seconds=0.3):
        return harness.run_cell(tiny_plan(workload), 2**33 + 7, seconds, trace, "cpu")

    return run
