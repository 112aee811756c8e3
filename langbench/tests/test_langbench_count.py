"""The count of compulsory work, against a case worked by hand."""

from langbench import count
from langbench.peaks import peaks_of
from langbench.reference.vocab import Vocab


def test_transform_and_fit_counts_by_hand():
    v = Vocab("exact", (1, 2, 3))
    # Lengths 5, 2, 0: windows 5+4+3, 2+1+0 and one partial (n = 3 > 2).
    assert count.windows(v, [5, 2, 0]) == 12 + 3 + 1
    w = count.transform_work(v, [5, 2, 0], distinct_rows=7, n_langs=4, weight_bytes=4)
    assert w == {"ops": 16 * 4 + 3 * 4, "bytes": 7 + 7 * 4 * 4 + 3 * 4}
    f = count.fit_work(v, [5, 2, 0], distinct_pairs=9, profile_grams=6, n_langs=4)
    assert f == {"ops": 16, "bytes": 7 + 9 * 4 + 6 * (8 + 32)}


def test_least_time_is_the_larger_bound():
    p = peaks_of("NVIDIA H100 80GB HBM3")
    assert count.least_seconds({"ops": 67e12, "bytes": 0}, p) == 1.0
    assert count.least_seconds({"ops": 1.0, "bytes": 3.35e12 * 2}, p) == 2.0
    assert peaks_of("NVIDIA A100") is None
