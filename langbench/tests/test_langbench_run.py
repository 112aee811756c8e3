"""Runs of the harness on the CPU at a tiny size: sound runs are correct,
and every fault a cell can have, and the control, make ``correct`` false.

Each fault is planted in the program underneath the timed path (the runs
skip the harness's look for a card, and nothing else)."""

import contextlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from langbench import harness, readings
from langbench.tests.conftest import BENCH, CELLS, cells_of

LABEL_CELLS = cells_of("transform")


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    got = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", "lid176-label-web",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.CHECKOUT,
    )
    assert got.returncode != 0 and got.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(tiny_run, cell, trace):
    r = tiny_run(cell, trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and all(t["value"] == 0 for t in r["checks"].values())
    kind = "per_layer" if trace else "end_to_end"
    # CPU runs carry no device metric; every other one of the cell is there.
    want = {m["name"] for m in harness.cell_plan(BENCH, cell)[kind] if m["source"] != "device_trace"}
    assert set(r["metrics"]) == want


@contextlib.contextmanager
def patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _execute_fault(kind):
    def make(old):
        last = {}

        def execute(self, byte_docs, *, want_labels):
            if kind == "half":  # half of the batch left out
                half = old(self, byte_docs[: len(byte_docs) // 2], want_labels=want_labels)
                out = np.zeros(len(byte_docs), half.dtype)
                out[: len(half)] = half
                return out
            out = old(self, byte_docs, want_labels=want_labels)
            if kind == "altered":  # one answer altered where it is produced
                out = out.copy()
                out[1] = (out[1] + 1) % self.num_langs
            elif kind == "stale":  # the previous call's answers returned again
                prev = last.get("out")
                last["out"] = out
                if prev is not None and len(prev) == len(out):
                    return prev
            return out

        return execute

    return make


@pytest.mark.parametrize("cell", LABEL_CELLS)
@pytest.mark.parametrize("kind", ["half", "altered", "stale"])
def test_transform_faults_are_not_correct(tiny_run, cell, kind):
    from spark_languagedetector_tpu_torch.api.runner import BatchRunner

    with patched(BatchRunner, "_execute_traced", _execute_fault(kind)):
        r = tiny_run(cell)
    assert not r["correct"] and r["checks"]["label_gap"]["value"] > r["checks"]["label_gap"]["limit"]


def _fit_step_fault(kind):
    def make(old):
        def step(batch, lengths, lang_ids, counts_acc, mult=None, **kw):
            if kind == "unchanged":  # the step returns its state unchanged
                return counts_acc
            n = batch.shape[0] // 2  # half of the batch left out
            return old(batch[:n], lengths[:n], lang_ids[:n], counts_acc,
                       None if mult is None else mult[:n], **kw)

        return step

    return make


def _finalize_fault(old):
    def finalize(*a, **kw):  # one weight altered where it is produced
        ids, w = old(*a, **kw)
        w = w.copy()
        w[0, 0] += 1e-9
        return ids, w

    return finalize


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fit_faults_are_not_correct(tiny_run, cell, kind):
    from spark_languagedetector_tpu_torch.ops import fit_tpu

    fault = (("finalize_counts", _finalize_fault) if kind == "altered"
             else ("fit_dense_step", _fit_step_fault(kind)))
    with patched(fit_tpu, *fault):
        r = tiny_run(cell)
    assert not r["correct"]
    assert (r["checks"]["profile_grams_differing"]["value"] > 0
            or r["checks"]["profile_weight_gap"]["value"] > 0)


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(tiny_plan, cell):
    """The control and the entry's faults at a tiny size: the reference one
    precision down, or with a fault planted, in the program's place fails a
    limit (on the chip they run at the cell's size through
    ``readings.py``)."""
    from langbench import checks

    row = readings.read_seed(tiny_plan(cell), 2**33 + 5, 0.2, "cpu")
    limits = checks.limits_of(cell)
    assert checks.judge(row["program"], limits)[0]
    assert not checks.judge(row["control"], limits)[0]
    for name, got in row["faults"].items():
        assert not checks.judge(got, limits)[0], name


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """A short run of each cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cell runs only on the card")
    plan = harness.cell_plan(BENCH, cell)
    assert harness.run_cell(plan, 2**33 + 17, 2.0, False, "cuda:0")["correct"]
