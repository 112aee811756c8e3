"""The device fit's weighing of its winners (``ops/fit_tpu.py``
``finalize_counts``) against the host fit (``ops/fit.py``), bit for bit.

The card finds the winners' non-zero (row, language, count) cells, and
the host weighs them with the host fit's own ``compute_weights``, in both
weight modes. Each case runs with the table on the CPU, and again on a CUDA
card where one is present (the ``cuda`` cases). The CPU cases also hold the
device fit against the JAX package's host fit, loaded only there, so the
module runs on a machine without JAX (``pytest --noconftest``).
"""

import functools

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu_torch.ops import fit as tfit
from spark_languagedetector_tpu_torch.ops import fit_tpu as ft
from spark_languagedetector_tpu_torch.ops.fit import COUNTS, PARITY
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, HASHED, VocabSpec
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
SPECS = {
    "exact_n1_2": (EXACT, (1, 2)),
    "hashed_fnv1a_n1_5": (HASHED, (1, 2, 3, 4, 5), 12),
}


def _on(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the count table lives there")
    return torch.device(device)


def _host_fits(device):
    """(host fit module, its VocabSpec) to hold the device fit against: the
    port's, and on the CPU the JAX package's too."""
    if device != "cpu":
        return [(tfit, VocabSpec)]
    jfit = pytest.importorskip("spark_languagedetector_tpu.ops.fit")
    jvocab = pytest.importorskip("spark_languagedetector_tpu.ops.vocab")
    return [(tfit, VocabSpec), (jfit, jvocab.VocabSpec)]


def _corpus(seed, n_docs=90, n_langs=3):
    """Random documents over a small alphabet (many shared grams), with
    the edges: empty, shorter than every n > 1, 0x00/0xFF."""
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(97, 104, int(rng.integers(0, 150))).tolist())
            for _ in range(n_docs)]
    docs += [b"", b"a", b"ab", b"abc", b"\x00\xff\x00\xff"]
    return docs, np.arange(len(docs)) % n_langs


def _presence_table(num_langs, seed, zero_rows=4):
    """int32 [V, L] count table: a row whose gram occurs in k languages for
    every k in 1..L, more rows up to an occurred-row count of 3 mod 8 (not
    a multiple of any SIMD width), and ``zero_rows`` rows no language saw,
    all in random order."""
    rng = np.random.default_rng(seed)
    ks = np.concatenate([np.arange(1, num_langs + 1),
                         rng.integers(1, num_langs + 1, 8 + (3 - num_langs) % 8)])
    counts = np.zeros((ks.size + zero_rows, num_langs), np.int32)
    for row, k in zip(rng.permutation(counts.shape[0])[: ks.size], ks):
        counts[row, rng.choice(num_langs, k, replace=False)] = rng.integers(1, 6, k)
    return counts


def _host_finalize(fit, counts, mode, profile_size):
    """The weighting and top-k of host fit module ``fit`` over a dense
    count table."""
    rows, langs = np.nonzero(counts)
    gc = fit.GramCounts(ids=rows.astype(np.int64), langs=langs.astype(np.int32),
                        counts=counts[rows, langs].astype(np.int64), num_langs=counts.shape[1])
    return fit.select_top_grams(*fit.compute_weights(gc, mode), profile_size)


def _per_cell(counts_rows, mode):
    """Weights computed cell by cell in float64 over whole rows: present /
    #langs (parity) or count / row total (counts), through ``log1p``."""
    counts_rows = counts_rows.astype(np.int64)
    if mode == PARITY:
        present = counts_rows > 0
        nlangs = present.sum(axis=1, keepdims=True)
        return np.log1p(np.where(present, 1.0 / np.maximum(nlangs, 1), 0.0))
    return np.log1p(counts_rows / np.maximum(counts_rows.sum(axis=1, keepdims=True), 1))


def _same_bits(a, b):
    return a.dtype == b.dtype == np.float64 and a.shape == b.shape and np.array_equal(
        a.view(np.int64), b.view(np.int64))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("mode", [PARITY, COUNTS])
@pytest.mark.parametrize("route", ["sort", "blocked"])
@pytest.mark.parametrize("profile", ["every_row", "few"])
@pytest.mark.parametrize("num_langs", [1, 2, 3, 10, 176, 257])
def test_finalize_weights_equal_the_per_cell_formula_and_the_host_fits(
    num_langs, profile, route, mode, device, monkeypatch
):
    """The winners' weights, weighed from the non-zero cells that cross,
    equal the per-cell float64 formula over whole rows and the host fits
    bit for bit, for every k in 1..L; rows no language saw are dropped, and
    so are the blocked walk's sentinels (ids >= V). ``fit/collect_bytes``
    counts what crosses: the winner ids, then 12 bytes a non-zero cell."""
    dev = _on(device)
    counts = _presence_table(num_langs, seed=num_langs)
    V = counts.shape[0]
    assert set(range(1, num_langs + 1)) <= set((counts > 0).sum(axis=1).tolist())
    size = V if profile == "every_row" else 7
    tc = torch.from_numpy(counts).to(dev)
    sentinels = []
    if route == "blocked":
        # An 8-row block leaves a sliding tail block (V % 8 != 0). The walk
        # gives its re-read lanes the sentinel id V, and they can take only
        # -inf slots, so every unseen winner is put there as one.
        walk = functools.partial(ft.finalize_topk_blocked, block=8)

        def walk_with_sentinels(table, **kw):
            top = walk(table, **kw)
            top = torch.where((table.sum(dim=1) == 0)[top], V, top)
            sentinels.append(int((top == V).sum()))
            return top

        assert V % 8
        monkeypatch.setattr(ft, "TOPK_SORT_BUDGET_ELEMS", 1)
        monkeypatch.setattr(ft, "finalize_topk_blocked", walk_with_sentinels)
    REGISTRY.reset()
    ids, w = ft.finalize_counts(tc, num_langs=num_langs, profile_size=size, weight_mode=mode)
    for fit, _ in _host_fits(device):
        want_ids, want_w = _host_finalize(fit, counts, mode, size)
        np.testing.assert_array_equal(ids, want_ids)
        assert _same_bits(w, want_w)
    assert _same_bits(w, _per_cell(counts[ids], mode))
    if profile == "every_row":
        np.testing.assert_array_equal(ids, np.flatnonzero(counts.sum(axis=1) > 0))
        assert len(ids) % 8 == 3
        assert sentinels == ([num_langs * 4] if route == "blocked" else [])
    top_bytes = num_langs * min(size, V) * 8  # the [L, k] int64 winner ids
    crossed = REGISTRY.snapshot()["counters"]["fit/collect_bytes"] - top_bytes
    assert crossed == 3 * 4 * int((counts[ids] > 0).sum())


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("mode", [PARITY, COUNTS])
@pytest.mark.parametrize("name", list(SPECS))
def test_fit_profile_device_weighs_like_the_host_fit(name, mode, device):
    """The whole device fit (count table, finalize, the non-zero cells
    weighed on the host) gives the host fits' profile bit for bit."""
    dev = _on(device)
    docs, langs = _corpus(7)
    got = ft.fit_profile_device(docs, langs, 3, VocabSpec(*SPECS[name]), 30, mode, device=dev)
    for fit, spec in _host_fits(device):
        want = fit.fit_profile_numpy(docs, langs, 3, spec(*SPECS[name]), 30, mode)
        np.testing.assert_array_equal(got[0], want[0])
        assert _same_bits(got[1], want[1])
