"""The traced window's arithmetic on made-up events: busy time is the union
of the device's intervals, idle gaps are labelled by the host's innermost
span, and kernels leave copies out."""

import pytest

from langbench import devtrace


class FakeTrace:
    offset_ns = 0

    def __init__(self, events):
        self.events = events


def test_summary_of_a_small_window():
    s = 1e9  # the window is [1 s, 2 s] on the host's wall clock
    calls = [{"epoch0": 1.0, "epoch1": 2.0}]
    spans = [{"path": "score", "wall_s": 0.6, "end": 1.8},
             {"path": "score/dispatch", "wall_s": 0.2, "end": 1.5}]
    events = [("k1", int(1.1 * s), int(0.2 * s)),  # 1.1-1.3
              ("Memcpy HtoD", int(1.2 * s), int(0.2 * s)),  # 1.2-1.4, overlaps k1
              ("k2", int(1.7 * s), int(0.5 * s))]  # 1.7-2.2, cut at 2.0
    got = devtrace.summarize(FakeTrace(events), spans, calls, "transform")
    assert got["window_s"] == pytest.approx(1.0)
    assert got["busy_s"] == pytest.approx(0.3 + 0.3)
    assert got["kernel_s"] == pytest.approx(0.2 + 0.3)
    gaps = dict(got["idle_gaps"])
    # Idle 1.0-1.1 outside any span; 1.4-1.5 inside score/dispatch
    # (1.3-1.5), 1.5-1.7 inside score (1.2-1.8) alone.
    assert gaps["transform (outside the program's spans)"] == pytest.approx(0.1)
    assert gaps["score/dispatch"] == pytest.approx(0.1)
    assert gaps["score"] == pytest.approx(0.2)
    assert sum(gaps.values()) == pytest.approx(got["window_s"] - got["busy_s"])
    assert [n for n, _ in got["device_ops"]] == ["k2", "k1", "Memcpy HtoD"]
