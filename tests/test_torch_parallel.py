"""The port's ``parallel/`` on gloo ranks, held against the JAX package's
mesh on the 8-virtual-device CPU backend in the same geometry.

Four ranks of one gloo group (``tests/_torch_mesh_worker.RankPool``, one
pool for the module) stand in for four of JAX's devices: the port's
``build_mesh(data=4)`` against JAX's ``build_mesh(data=4)`` over the first
four devices, ``(data=2, vocab=2)`` against its 2x2 grid. Inputs are made
with numpy from a seed. Tolerance classes (docs/ARCHITECTURE.md): counts,
ids and fitted profiles bit-exact; f32 scores in the reduction-order class
(``atol=1e-4, rtol=1e-5``).
"""

import numpy as np
import pytest

from spark_languagedetector_tpu.models.profile import GramProfile as JaxProfile
from spark_languagedetector_tpu.ops import fit_tpu as jfit
from spark_languagedetector_tpu.ops.encoding import pad_batch as jax_pad_batch
from spark_languagedetector_tpu.ops.encoding import texts_to_bytes as jax_texts_to_bytes
from spark_languagedetector_tpu.ops.fit import fit_profile_numpy as jax_host_fit
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxSpec
from spark_languagedetector_tpu.parallel import mesh as jmesh
from spark_languagedetector_tpu.parallel import sequence as jseq
from spark_languagedetector_tpu.parallel import sharded as jsharded
from spark_languagedetector_tpu_torch.parallel import distributed, mesh as pmesh
from spark_languagedetector_tpu_torch.parallel.sequence import chunk_grid

from ._torch_mesh_worker import RankPool
from .oracle import scores_oracle

ATOL, RTOL = 1e-4, 1e-5
LANGS = ("de", "en")
GRAM_MAP = {b"ab": [1.0, 0.0], b"bc": [0.5, 0.5], b"abc": [0.0, 2.0]}
HASHED8 = ("hashed", (1, 2), {"hash_bits": 8})
EXACT23 = ("exact", (2, 3), {})
# The ranks build this profile themselves (its exact trigram id space is too
# large to send to each): the LUT form.
PROFILE = {"gram_map": GRAM_MAP, "languages": LANGS, "gram_lengths": (2, 3)}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _jmesh(devices, data, vocab=1):
    return jmesh.build_mesh(data=data, vocab=vocab, devices=devices[: data * vocab])


def _jspec(args):
    return JaxSpec(args[0], args[1], **args[2])


def _batch8():
    texts = ["abab", "bcbc", "xyxy", "zz", "a", "", "abc", "bca"]
    batch, lengths = jax_pad_batch(jax_texts_to_bytes(texts), pad_to=8)
    return np.asarray(batch), np.asarray(lengths), np.asarray([0, 0, 1, 1, 0, 1, 0, 1], np.int32)


# ------------------------------------------------------------------ mesh ----
def test_build_mesh_shapes(pool, eight_devices):
    got = pool.run("mesh_info")
    assert [g["shape"] for g in got] == [{"data": 4, "vocab": 1}] * 4
    assert [g["coords"]["data"] for g in got] == [0, 1, 2, 3]
    assert {g["backend"] for g in got} == {"gloo"}
    grid = pool.run("mesh_info", 2, 2)
    assert grid[3]["shape"] == dict(_jmesh(eight_devices, 2, 2).shape) == {"data": 2, "vocab": 2}
    assert [(g["coords"]["data"], g["coords"]["vocab"]) for g in grid] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    # More ranks than the group has raises, as JAX does for devices.
    assert all("needs 8 ranks, have 4" in e for e in pool.run("mesh_request_raises", 8))
    with pytest.raises(ValueError):
        jmesh.build_mesh(data=16, vocab=1)
    assert all("not divisible by vocab=3" in e for e in pool.run("mesh_request_raises", None, 3))


def test_one_rank_mesh_without_a_group_is_valid():
    m = pmesh.build_mesh(device="cpu")
    assert dict(m.shape) == {"data": 1, "vocab": 1} and m.backend is None
    import torch

    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(m.psum(t), t) and m.all_gather(t) is t
    assert torch.equal(m.reduce_scatter(t, "data"), t) and m.ring_shift(t) is t
    assert pmesh.build_mesh(device="cpu") is m
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        pmesh.build_mesh(data=2, device="cpu")


def test_collectives_on_both_axes(pool):
    got = pool.run("collectives", 2, 2)
    for rank, g in enumerate(got):
        d, v = divmod(rank, 2)
        base = np.arange(6, dtype=np.float32).reshape(2, 3)
        data_line = [v, 2 + v]
        vocab_line = [2 * d, 2 * d + 1]
        np.testing.assert_array_equal(g["psum_data"], sum(base + 10 * r for r in data_line))
        np.testing.assert_array_equal(g["psum_vocab"], sum(base + 10 * r for r in vocab_line))
        np.testing.assert_array_equal(
            g["gather_data"], np.concatenate([base + 10 * r for r in data_line]))
        big = np.arange(12, dtype=np.int32).reshape(4, 3)
        np.testing.assert_array_equal(
            g["rs_data"], sum(big + r for r in data_line)[2 * d : 2 * d + 2])
        np.testing.assert_array_equal(
            g["rs_vocab"], sum(big + r for r in vocab_line)[2 * v : 2 * v + 2])
        # One ring hop brings the previous coordinate.
        assert g["ring_data"][0] == (d - 1) % 2 and g["ring_vocab"][0] == (v - 1) % 2


# --------------------------------------------------------------- scoring ----
@pytest.mark.parametrize("geometry", [(4, 1), (2, 2)])
def test_sharded_scorer_matches_single_device(pool, eight_devices, geometry):
    texts = ["abcabc", "bcbc", "zzz", "", "ab", "abcbcab", "b", "cab"]
    batch, lengths = jax_pad_batch(jax_texts_to_bytes(texts), pad_to=16)
    got = pool.run("sharded_score", *geometry, EXACT23, np.asarray(batch),
                   np.asarray(lengths), PROFILE, None, False)
    jprofile = JaxProfile.from_gram_map(GRAM_MAP, LANGS, (2, 3))
    jw, jids = jprofile.device_arrays()
    want = np.asarray(jsharded.make_sharded_scorer(_jmesh(eight_devices, *geometry),
                                                   jprofile.spec)(batch, lengths, jw, jids))
    for g in got:
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=RTOL)
    for t, row in zip(texts, got[0]):
        np.testing.assert_allclose(row, scores_oracle(t, GRAM_MAP, 2, [2, 3]),
                                   rtol=1e-5, atol=1e-7)


def test_vocab_striped_scorer_matches_replicated(pool, eight_devices):
    rng = np.random.default_rng(5)
    spec_args = ("hashed", (1, 2, 3), {"hash_bits": 10})
    L = 5
    weights = rng.normal(size=(1 << 10, L)).astype(np.float32)
    docs = [bytes(rng.integers(97, 122, int(rng.integers(0, 60))).tolist()) for _ in range(7)]
    batch, lengths = jax_pad_batch(docs + [b""], pad_to=64)
    batch, lengths = np.asarray(batch), np.asarray(lengths)
    striped = pool.run("sharded_score", 2, 2, spec_args, batch, lengths, weights, None, True)
    rep = pool.run("sharded_score", 4, 1, spec_args, batch, lengths, weights, None, False)
    jm = _jmesh(eight_devices, 2, 2)
    want = np.asarray(jsharded.make_sharded_scorer(jm, _jspec(spec_args), shard_vocab=True)(
        batch, lengths, weights, None))
    for s, r in zip(striped, rep):
        np.testing.assert_allclose(s, r, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(s, want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------- fit ----
@pytest.mark.parametrize("geometry", [(4, 1), (2, 2)])
def test_sharded_fit_step_matches_single_device(pool, eight_devices, geometry):
    batch, lengths, langs = _batch8()
    mult = np.asarray([1, 3, 1, 2, 1, 1, 5, 1], np.int32)
    got = pool.run("sharded_fit_step", *geometry, HASHED8, 2, batch, lengths, langs, mult)
    spec = _jspec(HASHED8)
    want = np.asarray(jfit.gram_counts_dense(batch, lengths, langs, mult, spec=spec,
                                             num_langs=2))
    import jax.numpy as jnp

    step = jsharded.make_sharded_fit_step(_jmesh(eight_devices, *geometry), spec, 2)
    jax_step = np.asarray(step(batch, lengths, langs,
                               jnp.zeros((spec.id_space_size, 2), jnp.int32), mult=mult))
    np.testing.assert_array_equal(jax_step, want)
    for local, total in got:
        np.testing.assert_array_equal(total, want)
    # Each rank counted only its own data shard: the data line's tables
    # add up to the whole batch, once.
    data, vocab = geometry
    line = sum(got[d * vocab][0] for d in range(data))
    np.testing.assert_array_equal(line, want)


def test_full_training_step_on_mesh(pool, eight_devices):
    batch, lengths, langs = _batch8()
    batch[5, 0], lengths[5] = ord("q"), 1
    import jax.numpy as jnp

    spec = _jspec(HASHED8)
    jm = _jmesh(eight_devices, 2, 2)
    _, jw, jtop = jsharded.training_step(jm, spec, 2, profile_size=4)(
        batch, lengths, langs, jnp.zeros((256, 2), jnp.int32))
    for geometry in ((4, 1), (2, 2)):
        for weights, top in pool.run("training_step", *geometry, HASHED8, 2, 4,
                                     batch, lengths, langs):
            assert weights.shape == (256, 2) and top.shape == (2, 4)
            np.testing.assert_allclose(weights, np.asarray(jw), atol=1e-6)
            np.testing.assert_array_equal(np.sort(top, 1), np.sort(np.asarray(jtop), 1))


def _fit_corpus(seed=3, n=120):
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(97, 104, int(rng.integers(0, 300))).tolist()) for _ in range(n)]
    docs += [b"", b"a", b"xyz" * 1500]  # empty, shorter than n, chunk-split
    langs = [i % 3 for i in range(len(docs))]
    # duplicated (document, language) pairs: the dedup multiplicity
    return docs + docs[:9], np.asarray(langs + langs[:9], np.int32)


@pytest.mark.parametrize("geometry,spec_args,mode", [
    ((4, 1), ("hashed", (1, 2, 3), {"hash_bits": 12}), "parity"),
    ((2, 2), ("hashed", (1, 2, 3, 4, 5), {"hash_bits": 11}), "counts"),
    ((4, 1), ("exact", (1, 2, 3, 4), {}), "parity"),
])
def test_sharded_device_fit_matches_host_fit(pool, geometry, spec_args, mode):
    docs, langs = _fit_corpus()
    ids, w = jax_host_fit(docs, langs, 3, _jspec(spec_args), 40, mode)
    # Small fixed batches: many steps, one not divisible by the data axis.
    for got_ids, got_w in pool.run("device_fit", *geometry, docs, langs, 3, spec_args, 40,
                                   mode, batch_rows=13):
        np.testing.assert_array_equal(got_ids, np.asarray(ids))
        np.testing.assert_array_equal(got_w, np.asarray(w))


def test_tie_plateau_across_a_stripe_boundary(pool, eight_devices):
    """A parity plateau that straddles the stripe boundaries comes out
    lowest ids first: the port sharded, the port on one device and JAX's
    sharded finalize give one ranking."""
    V, L, k = 4096, 3, 60
    counts = np.zeros((V, L), np.int32)
    for l in range(L):
        counts[np.arange(10) * 97 + l, l] = 1  # a few top grams per language
        for b in (1024, 2048, 3072):  # plateaus across every stripe edge
            counts[b - 20 : b + 20, l] += 2
            counts[b - 20 : b + 20, (l + 1) % L] += 1
    present = counts > 0
    n = present.sum(1, keepdims=True)
    w = np.where(present, np.log1p(1.0 / np.maximum(n, 1)), -np.inf)
    w[n[:, 0] == 0] = -np.inf
    ids = np.arange(V)
    want = [np.lexsort((ids, -w[:, l]))[:k] for l in range(L)]
    jtop = np.asarray(jsharded.make_sharded_finalize_topk(
        _jmesh(eight_devices, 4), profile_size=k)(counts))
    # torch.topk lists equal values above the boundary in any order, so each
    # language's winners are compared in (value desc, id asc) order.
    def ranked(rows, l):
        return sorted(rows[l].tolist(), key=lambda i: (-w[i, l], i))

    crossing = 0
    for sharded, single, memo in pool.run("finalize_topk", 4, 1, counts, k):
        assert memo  # one finalize per (mesh, k, weight mode, block)
        for l in range(L):
            assert ranked(sharded, l) == ranked(single, l) == ranked(jtop, l) == want[l].tolist()
            crossing += int((want[l] < 1024).any() and (want[l] >= 1024).any())
    assert crossing  # the winners' plateau spans a stripe boundary
    # The stripe walked in blocks smaller than it gives the same ranking.
    for sharded, _, _ in pool.run("finalize_topk", 4, 1, counts, k, "parity", 256):
        assert [ranked(sharded, l) for l in range(L)] == [r.tolist() for r in want]


def test_vocab_not_divisible_by_the_shards_takes_the_unsharded_finalize(pool):
    rng = np.random.default_rng(9)
    V, L, k = 1001, 4, 30
    by_rank = [(rng.random((V, L)) < 0.02).astype(np.int32) * rng.integers(1, 4, (V, L),
                                                                         dtype=np.int32)
               for _ in range(4)]
    from spark_languagedetector_tpu_torch.ops.fit_tpu import finalize_counts
    import torch

    want_ids, want_w = finalize_counts(torch.from_numpy(sum(by_rank)), num_langs=L,
                                       profile_size=k)
    for ids, w, sharded, kept in pool.run("finalize_local_counts", 4, 1, by_rank, L, k):
        assert not sharded and kept
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(w, want_w)
    # A dividing table stripes, and the finalize leaves each rank's own
    # table as it was (a second finalize sums it again).
    by_rank = [c[:1000] for c in by_rank]
    want_ids, want_w = finalize_counts(torch.from_numpy(sum(by_rank)), num_langs=L,
                                       profile_size=k)
    for ids, w, sharded, kept in pool.run("finalize_local_counts", 4, 1, by_rank, L, k):
        assert sharded and kept
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(w, want_w)


# -------------------------------------------------------- long documents ----
def test_long_document_psum_and_ring_agree(pool, eight_devices):
    rng = np.random.default_rng(3)
    text = "".join(rng.choice(list("abcz")) for _ in range(3000))
    doc = text.encode()
    want = scores_oracle(text, GRAM_MAP, 2, [2, 3])
    jprofile = JaxProfile.from_gram_map(GRAM_MAP, LANGS, (2, 3))
    jw, jids = jprofile.device_arrays()
    jm = _jmesh(eight_devices, 4)
    jpsum = jseq.score_long_document(doc, jw, jids, jprofile.spec, jm, chunk_size=256)
    b, ln, lim = jseq.chunk_grid(doc, 4, 256, (2, 3))
    pb, pln, plim = chunk_grid(doc, 4, 256, (2, 3))
    np.testing.assert_array_equal(pb, b)
    np.testing.assert_array_equal(plim, lim)
    import jax.numpy as jnp

    jring = np.asarray(jseq.ring_score_chunks(jnp.asarray(b), jnp.asarray(ln), jnp.asarray(lim),
                                              jw, jids, jprofile.spec, jm))
    for psum, ring in pool.run("long_document", 4, 1, EXACT23, doc, PROFILE, None, 256):
        np.testing.assert_allclose(psum, ring, atol=ATOL, rtol=RTOL)
        for other in (want, np.asarray(jpsum), jring):
            np.testing.assert_allclose(psum, other, rtol=1e-5)


# ------------------------------------------------------------- bring-up ----
def test_host_shard_covers_everything(pool):
    assert distributed.host_shard(10) == slice(0, 10)  # one process: all of it
    from spark_languagedetector_tpu.parallel.distributed import host_shard as jax_host_shard

    assert jax_host_shard(10) == slice(0, 10)
    assert pool.run("host_shard", 10) == [(0, 3), (3, 6), (6, 9), (9, 10)]


def test_global_batch_gathers_every_ranks_rows(pool):
    got = pool.run("global_batch", 2)
    want = np.concatenate([np.arange(6, dtype=np.int32).reshape(2, 3) + 100 * r
                           for r in range(4)])
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_initialize_is_a_no_op_in_one_process_and_reads_the_knobs(monkeypatch):
    from spark_languagedetector_tpu_torch.exec import config as exec_config

    distributed.initialize()  # nothing named: a single process
    monkeypatch.setenv("LANGDETECT_TPU_NUM_PROCESSES", "1")
    distributed.initialize()
    import torch.distributed as dist

    assert not dist.is_initialized()
    monkeypatch.setenv("LANGDETECT_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        distributed.initialize()
    monkeypatch.setenv("LANGDETECT_TPU_COORDINATOR", "localhost:1")
    monkeypatch.setenv("LANGDETECT_TPU_PROCESS_ID", "0")
    knobs = exec_config.effective_config()["knobs"]
    assert knobs["tpu_coordinator"]["value"] == "localhost:1"
    assert knobs["tpu_num_processes"]["value"] == 2
    assert knobs["tpu_process_id"]["source"] == "env"
    monkeypatch.setenv("LANGDETECT_TPU_NUM_PROCESSES", "0")
    assert "error" in exec_config.effective_config()["knobs"]["tpu_num_processes"]
