"""The readers of the program's stage spans: nothing to read gives None (a
program without the spans, or the other entry's window), and a synthetic
window gives the exact value."""

import pytest

from langbench import harness

# metric -> (entry, the span paths it sums)
READERS = {
    "transform_encode_ms_per_kdoc": ("transform", ["transform/encode"]),
    "runner_prepare_ms_per_kdoc": ("transform", ["runner/prepare"]),
    "transform_result_ms_per_kdoc": ("transform", ["runner/finish", "transform/result"]),
    "fit_encode_ms": ("fit", ["fit/encode"]),
    "fit_plan_ms": ("fit", ["fit/plan"]),
    "fit_wait_ms": ("fit", ["fit/winners"]),
    "fit_collect_copy_ms": ("fit", ["fit/collect/copy"]),
    "fit_collect_weigh_ms": ("fit", ["fit/collect/weigh"]),
    "fit_profile_ms": ("fit", ["fit/profile"]),
}
# Spans every window of the parent has: none of them is a new reader's.
OLD_SPANS = ["score", "score/pack", "score/dispatch", "score/fetch", "fit", "fit/count",
             "fit/finalize", "fit/collect", "fit/pack", "fit/put"]


def _read(name, rec):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(rec)


def _rec(entry, paths, wall_s=0.004):
    calls = [{"t0": 0.0, "t1": 1.0, "docs": 2_000, "ok": True},
             {"t0": 1.0, "t1": 2.0, "docs": 2_000, "ok": True},
             {"t0": 2.0, "t1": 2.5, "docs": 2_000, "ok": False}]
    spans = [{"path": p, "wall_s": wall_s, "end": 0.5} for p in OLD_SPANS]
    spans += [{"path": p, "wall_s": wall_s, "end": 0.5} for p in paths for _ in range(2)]
    return {"entry": entry, "calls": calls, "spans": spans, "window_s": 2.5, "setup_s": 1.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_its_spans(name):
    entry, _ = READERS[name]
    assert _read(name, _rec(entry, [])) is None
    other = "fit" if entry == "transform" else "transform"
    everything = [p for _, paths in READERS.values() for p in paths]
    assert _read(name, _rec(other, everything)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_sums_its_spans_per_unit(name):
    entry, paths = READERS[name]
    # Two spans of 4 ms for each path over two ok calls of 2,000 docs each.
    total_ms = 2 * 4.0 * len(paths)
    want = total_ms / 4.0 if entry == "transform" else total_ms / 2
    assert _read(name, _rec(entry, paths)) == pytest.approx(want, rel=1e-12)
