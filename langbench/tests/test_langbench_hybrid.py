"""The ``wili235-exact5`` cells' own pieces: the count of the hybrid route's
histogram kernels (:mod:`langbench.count_hybrid`), the readers of the
split fit's and the hybrid route's spans, and the configuration's
statement of its cut."""

import json

import numpy as np
import pytest

from langbench import count_hybrid, harness
from langbench.reference.vocab import Vocab

BENCH = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
VOCAB = Vocab("exact", (1, 2, 3, 4, 5))


def _read(name, rec):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(rec)


def test_hist_work_by_hand():
    docs = [b"abcab", b"ab", b"x"]
    # n >= 3: "abcab" has 3 + 2 + 1 windows; "ab" and "x" one partial window
    # each for n = 3, 4, 5.
    profile = [VOCAB.gram_id(g) for g in (b"abc", b"bca", b"abcab", b"ab", b"zz")]
    w = count_hybrid.hist_work(VOCAB, docs, profile, "row_hist", "cpu")
    # Pairs: (0, abc), (0, bca), (0, abcab), (1, ab); "x" is no profile gram.
    assert w == {"ops": 6.0 + 3 + 3, "bytes": 8.0 + 4 * 4}
    w = count_hybrid.hist_work(VOCAB, docs, profile, "bigram_hist", "cpu")
    # n <= 2: 5 + 4, 2 + 1 and 1 windows, "x" with a partial n = 2 window;
    # pairs (0, ab) and (1, ab).
    assert w == {"ops": 9.0 + 3 + 2, "bytes": 8.0 + 4 * 2}


@pytest.mark.parametrize("kernel", ["row_hist", "bigram_hist"])
def test_hist_work_does_not_depend_on_the_batching(kernel):
    rng = np.random.default_rng(7)
    docs = [bytes(rng.integers(97, 101, size=int(n)).tolist()) for n in rng.integers(0, 40, 64)]
    grams = {d[s : s + 3] for d in docs for s in range(len(d) - 2)}
    profile = sorted(VOCAB.gram_id(g) for g in list(grams)[::2])
    whole = count_hybrid.hist_work(VOCAB, docs, profile, kernel, "cpu")
    for cut in (1, 17, 50):
        a = count_hybrid.hist_work(VOCAB, docs[:cut], profile, kernel, "cpu")
        b = count_hybrid.hist_work(VOCAB, docs[cut:], profile, kernel, "cpu")
        assert {k: a[k] + b[k] for k in whole} == whole


# metric -> (entry, the span paths it sums)
SPAN_READERS = {
    "fit_long_count_ms": ("fit", ["fit/long/count"]),
    "fit_long_select_ms": ("fit", ["fit/long/select", "fit/merge"]),
    "hybrid_short_dispatch_ms_per_kdoc": ("transform", ["score/dispatch/hybrid/short"]),
    "hybrid_long_dispatch_ms_per_kdoc": ("transform", ["score/dispatch/hybrid/long"]),
}


def _rec(entry, paths, wall_s=0.004):
    calls = [{"t0": 0.0, "t1": 1.0, "docs": 2_000, "ok": True},
             {"t0": 1.0, "t1": 2.0, "docs": 2_000, "ok": True},
             {"t0": 2.0, "t1": 2.5, "docs": 2_000, "ok": False}]
    old = ["score", "score/pack", "score/dispatch", "fit", "fit/count", "fit/collect"]
    spans = [{"path": p, "wall_s": wall_s, "end": 0.5} for p in old]
    spans += [{"path": p, "wall_s": wall_s, "end": 0.5} for p in paths for _ in range(2)]
    return {"entry": entry, "calls": calls, "spans": spans, "window_s": 2.5, "setup_s": 1.0}


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_finds_nothing_without_its_spans(name):
    entry, _ = SPAN_READERS[name]
    assert _read(name, _rec(entry, [])) is None
    other = "fit" if entry == "transform" else "transform"
    everything = [p for _, paths in SPAN_READERS.values() for p in paths]
    assert _read(name, _rec(other, everything)) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_sums_its_spans_per_unit(name):
    entry, paths = SPAN_READERS[name]
    total_ms = 2 * 4.0 * len(paths)  # two spans of 4 ms a path, two ok calls
    want = total_ms / 4.0 if entry == "transform" else total_ms / 2
    assert _read(name, _rec(entry, paths)) == pytest.approx(want, rel=1e-12)


def test_exact_config_states_its_source_and_its_cut():
    (entry,) = [c for c in BENCH["configs"] if c["name"] == "wili235-exact5"]
    cfg = json.loads((harness.CHECKOUT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and "1801.07779" in cfg["source"]
    assert cfg["languages"] == 235 and cfg["gramLengths"] == [1, 2, 3, 4, 5]
    assert cfg["vocabMode"] == "exact" and cfg["languageProfileSize"] == 400
    assert cfg["assumed"] and set(cfg["reduced"]) == set(cfg["reduced_from"]) == {"training"}
    cells = {w["name"]: w for w in BENCH["workloads"] if w["config"] == "wili235-exact5"}
    assert set(cells) <= {"wili235-label", "wili235-fit"} and "wili235-fit" in cells
    assert all(w["chips"] == 1 for w in cells.values())
