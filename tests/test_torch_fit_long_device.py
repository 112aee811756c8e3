"""The split fit's long half on the device (``ops/fit_tpu.py``:
``count_long_grams``, ``select_long_grams``, ``merge_top_k``) against the
host fits (the port's ``ops/fit.py`` and, on the CPU, the JAX package's)
and the benchmark's plain reference (``langbench/reference``), bit for bit.

The long half counts every n = 4..5 window as a sorted 64-bit (gram,
language) key, ranks each language's top k on the device with the dense
half's top-k over a table of the distinct grams, and sends only the
winners' cells to the host; the merge ranks each language's candidates
from both halves. The corpora carry the edges: documents of exactly 4 bytes
(their partial n = 5 window), of fewer bytes (the dense half's extras),
empty ones, a language with fewer than k long grams (the zero-weight fill),
and in counts mode a plateau of equal weights across the k-th place. In
counts mode a float32 top-k can misrank near ties, so counts cases also
round the float32 weights to a few mantissa bits before the top-k: the long
half must still give the host's ranking, and the merge the concatenation's
(a mutation of either widening fails them). The
``cuda`` cases run the long half on the card against the port's host fit.
This module imports neither JAX nor the JAX package at module level, so it
runs on a machine without them (``pytest --noconftest``); its CPU cases
load the JAX package's host fit through ``pytest.importorskip``.
"""

import numpy as np
import pytest
import torch

from langbench.reference import fit as ref_fit
from spark_languagedetector_tpu_torch.ops import fit as tfit
from spark_languagedetector_tpu_torch.ops import fit_tpu as ft
from spark_languagedetector_tpu_torch.ops.fit import COUNTS, PARITY
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, VocabSpec

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
LENGTHS = (1, 2, 3, 4, 5)
SPEC = VocabSpec(EXACT, LENGTHS)
LONG = (4, 5)
EDGES = [b"", b"", b"a", b"ab", b"abc", b"abcd", b"abcd", b"wxyz", b"\x00\xff\x00\xff", b"abcde"]


def _on(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the long half runs there")
    return torch.device(device)


def _host_fits(device):
    """(host fit module, its VocabSpec) to hold the device fit against: the
    port's, and on the CPU the JAX package's too."""
    if device != "cpu":
        return [(tfit, VocabSpec)]
    jfit = pytest.importorskip("spark_languagedetector_tpu.ops.fit")
    jvocab = pytest.importorskip("spark_languagedetector_tpu.ops.vocab")
    return [(tfit, VocabSpec), (jfit, jvocab.VocabSpec)]


def _coarse_ranks(monkeypatch, bits):
    """Round the device's float32 weights to ``bits`` mantissa bits before
    every top-k (both halves'): distinct float64 weights tie there, as near
    ties do in float32 at larger counts. Zero stays zero, a positive weight
    positive, and the order is kept."""
    real = ft.weights_from_counts

    def coarse(counts, *, weight_mode="parity"):
        m, e = torch.frexp(real(counts, weight_mode=weight_mode))
        return torch.ldexp(torch.round(m * 2**bits) / 2**bits, e)

    monkeypatch.setattr(ft, "weights_from_counts", coarse)


def _corpus(seed, n_langs, n_docs, alphabet=8, max_len=160):
    """Random documents over a small alphabet (many shared grams), the
    edges spread over the languages, and one more language whose documents
    are all 4 to 6 bytes long, so it holds few long grams."""
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(97, 97 + alphabet, int(rng.integers(0, max_len))).tolist())
            for _ in range(n_docs)]
    docs += EDGES
    langs = list(np.arange(len(docs)) % n_langs)
    sparse = [bytes(rng.integers(97, 97 + alphabet, int(rng.integers(4, 7))).tolist())
              for _ in range(3)]
    return docs + sparse, np.asarray(langs + [n_langs] * len(sparse)), n_langs + 1


def _host_long(fit, spec, docs, langs, num_langs, mode, size):
    """Host fit module ``fit``'s long half: its counts, every long gram's
    weights, its profile, each language's top ids in order."""
    gc = fit.extract_gram_counts(docs, langs, num_langs, spec(EXACT, LENGTHS),
                                 gram_lengths_subset=LONG, min_partial_gram_len=4)
    uids, w = fit.compute_weights(gc, mode)
    k = min(size, uids.size)
    top = np.stack([uids[np.lexsort((uids, -w[:, l]))[:k]] for l in range(num_langs)])
    return gc, w, fit.select_top_grams(uids, w, size), top


def _plateau(w, size):
    """Whether some language's weights hold more grams at its k-th place
    (a non-zero weight) than its top k has room for."""
    k = min(size, w.shape[0])
    cols = -np.sort(-w, axis=0)
    return k < w.shape[0] and bool(((cols[k - 1] > 0) & (cols[k] == cols[k - 1])).any())


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("mode", [PARITY, COUNTS, "coarse"])
@pytest.mark.parametrize("size", [40, 300])
@pytest.mark.parametrize("seed", [0, 1])
def test_long_half_is_the_host_long_half(device, mode, size, seed, monkeypatch):
    """Keys and counts, winner ids and weights, and each language's top
    list (as a set: the device lists ties in any order) equal the host
    fits'; ``coarse`` is counts mode under 1-bit ranks, where the
    float32 top-k misranks and the float64 band must mend it."""
    dev = _on(device)
    docs, langs, L = _corpus(seed, 4, 60 + 40 * seed)
    if mode == "coarse":
        _coarse_ranks(monkeypatch, 1)
        mode = COUNTS
    keys, counts = ft.count_long_grams(docs, langs, L, SPEC, LONG, dev)
    assert keys.device.type == dev.type
    ids, w, top = ft.select_long_grams(keys, counts, L, size, mode)
    for fit, spec in _host_fits(device):
        gc, all_w, (want_ids, want_w), want_top = _host_long(fit, spec, docs, langs, L, mode,
                                                             size)
        np.testing.assert_array_equal(keys.cpu().numpy(), gc.ids * L + gc.langs)
        np.testing.assert_array_equal(counts.cpu().numpy(), gc.counts)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(w.view(np.int64), want_w.view(np.int64))
        np.testing.assert_array_equal(np.sort(top, axis=1), np.sort(want_top, axis=1))
    # The sparse language has fewer than k long grams: zero-weight fill.
    assert (gc.langs == L - 1).sum() < top.shape[1]
    if mode == COUNTS and size == 40:
        assert _plateau(all_w, size)


@pytest.mark.parametrize("device", DEVICES)
def test_counts_ratios_that_round_to_one_weight_rank_by_id(device):
    """Two grams whose count ratios in language 0 are distinct doubles but
    whose log1p weights are one double: the host ranks them by id, so the
    lower id takes the one place though its ratio is the lower. The float32
    top-k ranks the higher ratio first; the band and the host's float64
    rank put the lower id back."""
    dev = _on(device)
    c, t, c2, t2 = 1_839_310_073, 2_010_101_057, 1_262_628_345, 1_379_870_968
    assert c / t < c2 / t2 and np.log1p(c / t) == np.log1p(c2 / t2)
    f32 = torch.log1p(torch.tensor([c, c2]).float() / torch.tensor([t, t2]).float())
    assert f32[1] > f32[0]  # the float32 top-k picks gram 2000 in language 0
    ids, langs = np.array([1000, 1000, 2000, 2000]), np.array([0, 1, 0, 1])
    counts = np.array([c, t - c, c2, t2 - c2])
    ids_t, counts_t = (torch.as_tensor(a, device=dev) for a in (ids * 2 + langs, counts))
    got_ids, got_w, top = ft.select_long_grams(ids_t, counts_t, 2, 1, COUNTS)
    np.testing.assert_array_equal(top, [[1000], [1000]])
    for fit, _ in _host_fits(device):
        gc = fit.GramCounts(ids=ids, langs=langs, counts=counts, num_langs=2)
        want_ids, want_w = fit.select_top_grams(*fit.compute_weights(gc, COUNTS), 1)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_w, want_w)


@pytest.mark.parametrize("device", DEVICES)
def test_long_half_of_a_corpus_without_long_windows(device):
    dev = _on(device)
    docs, langs = [b"", b"ab", b"abc", b"xy"], np.array([0, 1, 0, 1])
    keys, counts = ft.count_long_grams(docs, langs, 2, SPEC, LONG, dev)
    assert keys.numel() == 0 and counts.numel() == 0
    ids, w, top = ft.select_long_grams(keys, counts, 2, 40, PARITY)
    assert ids.size == 0 and w.shape == (0, 2) and top.shape == (2, 0)


@pytest.fixture(scope="module")
def corpus():
    docs, langs, L = _corpus(7, 3, 50)
    uids, w = tfit.compute_weights(tfit.extract_gram_counts(docs, langs, L, SPEC), COUNTS)
    assert _plateau(w, 40)
    return docs, langs, L


@pytest.mark.parametrize("mode", [PARITY, COUNTS])
@pytest.mark.parametrize("size", [40, 300])
def test_split_fit_is_the_host_fit_and_the_reference(corpus, mode, size):
    docs, langs, L = corpus
    ids, w = ft.fit_profile_device_split(docs, langs, L, SPEC, size, mode, device="cpu")
    for fit, spec in _host_fits("cpu"):
        want_ids, want_w = fit.fit_profile_numpy(docs, langs, L, spec(EXACT, LENGTHS), size, mode)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(w.view(np.int64), want_w.view(np.int64))
    assert w.flags.c_contiguous and ids.dtype == np.int64
    if mode == PARITY:  # the reference implements the parity weighting only
        cfg = {"languages": L, "gramLengths": list(LENGTHS), "vocabMode": "exact",
               "languageProfileSize": size, "weightMode": "parity"}
        ref_ids, ref_w = ref_fit.fit(cfg, docs, langs, "cpu")
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(w, ref_w)
    lengths = np.searchsorted(np.cumsum([256**n for n in range(1, 5)]), ids, side="right") + 1
    if size == 300:  # both halves reach the profile
        assert {3, 4, 5} <= set(lengths.tolist())


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("size", [40, 300])
def test_counts_split_fit_under_coarse_ranks_is_the_concatenation_s_top_k(
    device, size, monkeypatch
):
    """Counts mode with 3-bit ranks on the device: the dense half's winners
    are its coarse top-k's, so some language's list misses a row of those
    winners that the float64 order puts ahead, and the profile must still
    be ``select_top_grams`` over the concatenation of the dense half's
    winners and the host's exact long half, as a merge over every row gives
    it. One more language holds only documents of 1 to 3 bytes: no long
    gram of its own outranks its dense boundary, so on the CPU at k = 40 a
    merge of the coarse lists alone loses a row there."""
    dev = _on(device)
    docs, langs, L = _corpus(1, 3, 50)
    rng = np.random.default_rng(101)
    docs += [bytes(rng.integers(97, 105, int(rng.integers(1, 4))).tolist()) for _ in range(200)]
    langs, L = np.concatenate([langs, np.full(200, L)]), L + 1
    _coarse_ranks(monkeypatch, 3)
    parts = []
    for name in ("fit_profile_device", "select_long_grams"):
        def keep(*a, _fn=getattr(ft, name), **kw):
            out = _fn(*a, **kw)
            parts.append((*out[:2], kw["winners_out"][0] if "winners_out" in kw else out[2]))
            return out

        monkeypatch.setattr(ft, name, keep)
    ids, w = ft.fit_profile_device_split(docs, langs, L, SPEC, size, COUNTS, device=dev)
    (low_ids, low_w, low_top), high = parts
    k = min(size, low_ids.size)
    exact = [set(low_ids[np.lexsort((low_ids, -low_w[:, l]))[:k]].tolist()) for l in range(L)]
    assert any(exact[l] - set(low_top[l].tolist()) for l in range(L))  # the coarse ranks bite
    for fit, spec in _host_fits(device):
        _, _, (high_ids, high_w), _ = _host_long(fit, spec, docs, langs, L, COUNTS, size)
        want_ids, want_w = fit.select_top_grams(
            np.concatenate([low_ids, high_ids]), np.concatenate([low_w, high_w]), size)
        order = np.argsort(want_ids)
        np.testing.assert_array_equal(ids, want_ids[order])
        np.testing.assert_array_equal(w.view(np.int64), want_w[order].view(np.int64))
    if device == "cpu" and size == 40:
        narrow_ids, _ = ft.merge_top_k([(*parts[0], True), (*high, True)], size)
        assert not np.array_equal(narrow_ids, ids)


def _merge_case(rng, exact_first):
    """Two profiles with disjoint ids and weights from a few values, their
    neighbours a few float64 ulps off (one float32 value, distinct float64
    ones) and exact ties; each profile's rows are the union of its
    per-language top lists, which carry foreign ids too. The first part's
    lists are ranked at float32 precision unless ``exact_first``."""
    L = int(rng.integers(1, 6))
    size = int(rng.integers(1, 13))
    base = np.array([np.log1p(1.0), np.log1p(0.5), np.log1p(1 / 3), 0.25])
    values = np.concatenate([[0.0, 0.0], base, np.nextafter(base, 1), base * (1 + 2.0**-30)])
    pool = rng.permutation(200)[: int(rng.integers(0, 61))]
    cut = int(rng.integers(0, pool.size + 1))
    parts = []
    for gids, exact in ((np.sort(pool[:cut]), exact_first), (np.sort(pool[cut:]), True)):
        w = values[rng.integers(0, values.size, (gids.size, L))]
        rank_w = w if exact else w.astype(np.float32)
        k = min(size, gids.size)
        top = np.stack([gids[np.lexsort((gids, -rank_w[:, l]))[:k]] for l in range(L)])
        rows = np.flatnonzero(np.isin(gids, top))
        foreign = rng.integers(1000, 1100, (L, int(rng.integers(0, 4))))
        parts.append((gids[rows], w[rows], np.concatenate([top, foreign], axis=1), exact))
    return parts, size


@pytest.mark.parametrize("exact_first", [True, False])
def test_merge_of_candidates_is_select_top_grams_of_the_concatenation(exact_first):
    """300 seeded cases: the merge over each language's candidates equals
    the host fits' ``select_top_grams`` over the concatenated rows, sorted
    by id, with exact lists and with a float32-ranked first list."""
    rng = np.random.default_rng(19 + exact_first)
    for _ in range(300):
        parts, size = _merge_case(rng, exact_first)
        ids, w = ft.merge_top_k(parts, size)
        for fit, _ in _host_fits("cpu"):
            want_ids, want_w = fit.select_top_grams(
                np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
                size)
            order = np.argsort(want_ids)
            np.testing.assert_array_equal(ids, want_ids[order])
            np.testing.assert_array_equal(w.view(np.int64), want_w[order].view(np.int64))
