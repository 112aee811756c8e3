"""The port's public API on a mesh of four gloo ranks, held against the
JAX package's mesh execution (``tests/test_mesh_api.py``).

Every rank fits and transforms the same table (the JAX multi-process
contract) and gets the whole profile and every label. Runner-level cases
set the JAX runner on the first four of its eight virtual devices, in the
port's geometry. Tolerance classes (docs/ARCHITECTURE.md): labels, ids and
fitted profiles bit-exact; the port on a mesh against the port on one
device bit-exact where the strategy's math is per row (every kernel's
plain version, the gather), in the reduction-order class where a vocab
stripe's partial sums are added (``mesh:vocab``); against JAX's f32 scores
the reduction-order class (``atol=1e-4, rtol=1e-5``), or the JAX test's
own bound where it sets one.
"""

import numpy as np
import pytest

from spark_languagedetector_tpu import LanguageDetector as JaxDetector
from spark_languagedetector_tpu import Table as JaxTable
from spark_languagedetector_tpu.api.runner import BatchRunner as JaxRunner
from spark_languagedetector_tpu.api.runner import resolve_mesh as jax_resolve_mesh
from spark_languagedetector_tpu.ops.cuckoo import build_cuckoo as jax_build_cuckoo
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxSpec
from spark_languagedetector_tpu.ops.vocab import gram_key
from spark_languagedetector_tpu.parallel import mesh as jmesh
from spark_languagedetector_tpu_torch.api.runner import BatchRunner, resolve_mesh
from spark_languagedetector_tpu_torch.parallel.mesh import build_mesh

from ._torch_mesh_worker import RankPool

ATOL, RTOL = 1e-4, 1e-5
LANGS = ["de", "en", "fr"]
ROWS = {
    "lang": ["de"] * 3 + ["en"] * 3 + ["fr"] * 3,
    "fulltext": [
        "Dies ist ein deutscher Text über Sprache",
        "Das Wetter ist heute sehr schön und warm",
        "Der schnelle braune Fuchs springt über den Hund",
        "This is an english text about language",
        "The weather today is very nice and warm",
        "The quick brown fox jumps over the lazy dog",
        "Ceci est un texte français sur la langue",
        "Le temps est très beau et chaud aujourd'hui",
        "Le renard brun rapide saute par dessus le chien",
    ],
}
EVAL = [
    "Der Hund springt über den Fuchs und das ist schön",
    "The dog jumps over the fox and that is nice",
    "Le chien saute par dessus le renard aujourd'hui",
    "",  # all-miss ⇒ first language
    "Das Wetter ist warm " * 400,  # long doc: chunked + mesh-padded path
]
DOCS = [t.encode() for t in EVAL]
BASE = {"rows": ROWS, "languages": LANGS, "grams": [1, 2], "k": 300}


def _spec(**kw):
    return {**BASE, **kw}


def _jax_model(spec):
    det = JaxDetector(spec["languages"], spec["grams"], spec["k"])
    if spec.get("vocab"):
        mode, bits = spec["vocab"]
        det = det.set_vocab_mode(mode)
        if bits:
            det = det.set_hash_bits(bits)
    return det.fit(JaxTable(spec["rows"]))


def _jmesh(devices, data, vocab=1):
    return jmesh.build_mesh(data=data, vocab=vocab, devices=devices[: data * vocab])


def _jax_runner(model, devices, geometry=None, **kw):
    weights, lut, cuckoo = model.profile.device_membership()
    mesh = None if geometry is None else _jmesh(devices, *geometry)
    return JaxRunner(weights=weights, lut=lut, cuckoo=cuckoo, spec=model.profile.spec,
                     mesh=mesh, **kw)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _same(results):
    """Every rank's result, checked equal to rank 0's; rank 0's."""
    first = results[0]
    for r in results[1:]:
        np.testing.assert_equal(r, first)
    return first


# ------------------------------------------------------------ resolution ----
def test_resolve_mesh_uses_all_ranks(pool, eight_devices):
    shape, fit = _same(pool.run("resolve_info", "mesh"))
    assert shape == fit == {"data": 4, "vocab": 1}
    assert int(np.prod(list(jax_resolve_mesh("mesh").shape.values()))) == len(eight_devices)
    assert _same(pool.run("resolve_info", "cpu"))[0] is None
    assert resolve_mesh("cpu") is None
    # Without a process group a mesh value is a one-rank mesh on the card:
    # here there is none, and it raises rather than fall back to the CPU.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_mesh("mesh")


def test_resolve_mesh_vocab_axis(pool, eight_devices):
    shape, _ = _same(pool.run("resolve_info", "mesh:vocab"))
    assert shape == {"data": 2, "vocab": 2}
    big = 8 * 256 * 1024 * 1024  # 8x the budget: the axis grows to the rank count
    shape, _ = _same(pool.run("resolve_info", "mesh:vocab", big))
    assert shape == {"data": 1, "vocab": 4}
    assert jax_resolve_mesh("mesh:vocab", table_bytes=big).shape["vocab"] == 8


def test_mesh_and_device_together_raise():
    m = build_mesh(device="cpu")
    with pytest.raises(ValueError, match="either device or mesh"):
        BatchRunner(weights=np.zeros((4, 2), np.float32), lut=None,
                    spec=None, device="cpu", mesh=m)


def test_a_mesh_asking_for_more_ranks_than_the_group_raises(pool):
    assert all("needs 8 ranks, have 4" in e for e in pool.run("mesh_request_raises", 8))


# ------------------------------------------------------------- transform ----
def test_transform_mesh_matches_single_device(pool, eight_devices):
    model = _jax_model(BASE)
    want = model.transform(JaxTable({"fulltext": EVAL})).column("lang").tolist()
    model.set_backend("mesh")
    assert model.transform(JaxTable({"fulltext": EVAL})).column("lang").tolist() == want
    single, strategy, _ = _same(pool.run("transform_labels", BASE, EVAL, "cpu"))
    meshed, mstrategy, shape = _same(pool.run("transform_labels", BASE, EVAL, "mesh"))
    assert shape == {"data": 4, "vocab": 1} and mstrategy == strategy
    assert meshed == single == want
    assert want[:4] == ["de", "en", "fr", "de"]


def test_mesh_scores_match_single_device(pool, eight_devices):
    model = _jax_model(BASE)
    want = _jax_runner(model, eight_devices, (4, 1)).score(DOCS)
    single, _, _ = _same(pool.run("runner_scores", BASE, DOCS, "cpu"))
    meshed, _, _ = _same(pool.run("runner_scores", BASE, DOCS, "mesh"))
    np.testing.assert_array_equal(meshed, single)
    np.testing.assert_allclose(meshed, want, atol=ATOL, rtol=RTOL)
    labels, _, _ = _same(pool.run("runner_scores", BASE, DOCS, "mesh", labels=True))
    np.testing.assert_array_equal(labels, np.argmax(single, 1))


def test_mesh_batch_not_divisible_by_data_axis(pool):
    """Ragged tail batches are padded with empty rows and un-padded."""
    docs = DOCS[:3] * 3  # 9 docs, batch 8 ⇒ a tail of 1
    for scores, _, _ in pool.run("runner_scores", BASE, docs, "mesh", batch_size=8):
        assert scores.shape == (9, 3)
        np.testing.assert_array_equal(scores[:3], scores[3:6])
    # Each batch of 7 rows pads to 8 over four ranks.
    single, _, _ = _same(pool.run("runner_scores", BASE, DOCS[:3] * 5, "cpu", batch_size=7))
    meshed, _, _ = _same(pool.run("runner_scores", BASE, DOCS[:3] * 5, "mesh", batch_size=7))
    np.testing.assert_array_equal(meshed, single)


def test_docblock_input_on_a_mesh_equals_the_list(pool):
    listed, _, _ = _same(pool.run("runner_scores", BASE, DOCS, "mesh"))
    block, _, _ = _same(pool.run("runner_scores", BASE, DOCS, "mesh", block_input=True))
    np.testing.assert_array_equal(block, listed)


def test_fit_device_mesh_matches_host_fit(pool):
    host = _jax_model(BASE)
    ids, w = _same(pool.run("fit_profile", _spec(fit_backend="device")))
    np.testing.assert_array_equal(ids, host.profile.ids)
    np.testing.assert_array_equal(w, host.profile.weights)


# ------------------------------------------------------------ strategies ----
def test_mesh_pallas_strategy_matches_single_device(pool, eight_devices):
    model = _jax_model(BASE)
    want = _jax_runner(model, eight_devices, (4, 1), strategy="pallas", batch_size=8).score(DOCS)
    single, s1, _ = _same(pool.run("runner_scores", BASE, DOCS, "cpu", strategy="pallas",
                                   batch_size=8))
    meshed, s2, _ = _same(pool.run("runner_scores", BASE, DOCS, "mesh", strategy="pallas",
                                   batch_size=8))
    assert s1 == s2 == "pallas"
    np.testing.assert_array_equal(meshed, single)
    np.testing.assert_allclose(meshed, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("strategy", ["gather", "fused"])
def test_mesh_runner_with_a_lut(pool, eight_devices, strategy):
    """Compact-table (LUT) profiles run sharded, through the gather and
    the fused kernel's plain version."""
    spec = _spec(vocab=("hashed", 12))
    model = _jax_model(spec)
    want = _jax_runner(model, eight_devices).score(DOCS)
    single, _, _ = _same(pool.run("runner_scores", spec, DOCS, "cpu", strategy=strategy))
    meshed, got, shape = _same(pool.run("runner_scores", spec, DOCS, "mesh", strategy=strategy))
    assert got == strategy and shape == {"data": 4, "vocab": 1}
    np.testing.assert_array_equal(meshed, single)
    np.testing.assert_allclose(meshed, want, atol=ATOL, rtol=RTOL)


def test_mesh_cuckoo_membership_matches_single_device(pool, eight_devices):
    """Exact gram lengths 4..5 (cuckoo membership): entries replicate,
    batches shard over the data axis."""
    spec = _spec(grams=[1, 4], k=200, vocab=("exact", None))
    model = _jax_model(spec)
    want = _jax_runner(model, eight_devices, (4, 1)).score(DOCS)
    single, strategy, _ = _same(pool.run("runner_scores", spec, DOCS, "cpu"))
    meshed, mstrategy, _ = _same(pool.run("runner_scores", spec, DOCS, "mesh"))
    assert strategy == mstrategy == "hybrid"
    np.testing.assert_array_equal(meshed, single)
    np.testing.assert_allclose(meshed, want, rtol=1e-5, atol=1e-4)


def test_mesh_hybrid_strategy_matches_single_device(pool, eight_devices):
    spec = _spec(grams=[1, 2, 3], vocab=("exact", None))
    model = _jax_model(spec)
    want = _jax_runner(model, eight_devices, (4, 1), strategy="hybrid", batch_size=8).score(DOCS)
    single, _, _ = _same(pool.run("runner_scores", spec, DOCS, "cpu", strategy="hybrid",
                                  batch_size=8))
    meshed, _, _ = _same(pool.run("runner_scores", spec, DOCS, "mesh", strategy="hybrid",
                                  batch_size=8))
    np.testing.assert_array_equal(meshed, single)
    np.testing.assert_allclose(meshed, want, rtol=1e-4, atol=1e-3)


def test_mesh_hist_strategy_matches_single_device(pool, eight_devices):
    """strategy='hist' on a data-parallel mesh against the single-device
    gather scorer, the port's and JAX's."""
    rng = np.random.default_rng(23)
    spec_args = ("exact", (1, 2, 3, 4, 5), {})
    grams = sorted({bytes(rng.integers(97, 110, int(rng.integers(1, 6))).tolist())
                    for _ in range(300)})
    L = 6
    weights = np.zeros((len(grams) + 1, L), np.float32)
    weights[:-1] = rng.normal(size=(len(grams), L)).astype(np.float32)
    keys = [gram_key(g) for g in grams]
    lo = np.asarray([k[0] for k in keys], np.int32)
    hi = np.asarray([k[1] for k in keys], np.int32)
    docs = [bytes(rng.integers(97, 112, int(rng.integers(0, 100))).tolist())
            for _ in range(21)] + [b"", b"ab", bytes(b"abcde" * 120)]
    ref = JaxRunner(weights=weights, lut=None, spec=JaxSpec("exact", (1, 2, 3, 4, 5)),
                    cuckoo=jax_build_cuckoo(lo, hi), strategy="gather",
                    length_buckets=(128, 256)).score(docs)
    single, _, _ = _same(pool.run("raw_runner_scores", weights, None, spec_args, docs, "cpu",
                                  strategy="gather", length_buckets=(128, 256),
                                  cuckoo_keys=(lo, hi)))
    meshed, got, _ = _same(pool.run("raw_runner_scores", weights, None, spec_args, docs,
                                    "mesh", strategy="hist", length_buckets=(128, 256),
                                    cuckoo_keys=(lo, hi)))
    assert got == "hist"
    np.testing.assert_allclose(meshed, single, atol=1e-3)
    np.testing.assert_allclose(meshed, ref, atol=1e-3)


# ------------------------------------------------------------ vocab axis ----
def test_vocab_striped_scores_match_replicated(pool, eight_devices):
    """The dense hashed table striped over the vocab axis against the
    replicated mesh: the reduction-order class (the port adds the stripes'
    partial sums)."""
    rng = np.random.default_rng(5)
    spec_args = ("hashed", (1, 2, 3), {"hash_bits": 12})
    V, L = 1 << 12, 5
    weights = rng.normal(size=(V, L)).astype(np.float32)
    docs = [bytes(rng.integers(97, 122, int(rng.integers(0, 120))).tolist())
            for _ in range(19)] + [b""]
    rep, _, rshape = _same(pool.run("raw_runner_scores", weights, None, spec_args, docs, "mesh",
                                    strategy="gather", length_buckets=(64, 128)))
    striped, strategy, shape = _same(pool.run("raw_runner_scores", weights, None, spec_args,
                                              docs, "mesh:vocab", length_buckets=(64, 128)))
    assert strategy == "gather" and shape == {"data": 2, "vocab": 2}
    assert rshape == {"data": 4, "vocab": 1}
    np.testing.assert_allclose(striped, rep, atol=ATOL, rtol=RTOL)
    jshard = JaxRunner(weights=weights, lut=None, spec=JaxSpec("hashed", (1, 2, 3), hash_bits=12),
                       mesh=_jmesh(eight_devices, 2, 2), length_buckets=(64, 128)).score(docs)
    np.testing.assert_allclose(striped, jshard, atol=ATOL, rtol=RTOL)


def test_public_api_mesh_vocab_backend(pool, eight_devices):
    """device='mesh:vocab' end to end: label-identical to the replicated
    mesh, the dense table striped over two vocab ranks."""
    want, _, _ = _same(pool.run("transform_labels", BASE, EVAL, "mesh"))
    got, strategy, shape = _same(pool.run("transform_labels", BASE, EVAL, "mesh:vocab"))
    assert shape == {"data": 2, "vocab": 2} and strategy == "gather"
    assert got == want
    model = _jax_model(BASE)
    model.set_backend("mesh:vocab")
    assert model.transform(JaxTable({"fulltext": EVAL})).column("lang").tolist() == want


def test_mesh_vocab_falls_back_for_compact_profiles(pool):
    """A cuckoo profile has nothing to stripe: 'mesh:vocab' keeps the whole
    data axis."""
    spec = _spec(grams=[1, 2, 3, 4, 5], k=100, vocab=("exact", None))
    _, strategy, shape = _same(pool.run("transform_labels", spec, EVAL, "mesh:vocab"))
    assert shape == {"data": 4, "vocab": 1} and strategy == "hybrid"


# ------------------------------------------------------------ segment mode --
def test_segment_mode_on_a_mesh_matches_single_device(pool):
    spec = _spec(vocab=("hashed", 12))
    docs = DOCS + [b"abc" * 700]
    single, s1 = _same(pool.run("segment_cells", spec, docs, "cpu"))
    meshed, s2 = _same(pool.run("segment_cells", spec, docs, "mesh"))
    assert s1 == s2 == "fused"
    for a, b in zip(meshed, single):
        np.testing.assert_array_equal(a, b)
    want = _same(pool.run("segment_results", spec, EVAL, "cpu"))
    assert _same(pool.run("segment_results", spec, EVAL, "mesh")) == want
    # The striped gather's cells add the stripes' parts.
    cells, strategy = _same(pool.run("segment_cells", BASE, docs, "mesh:vocab"))
    ref, _ = _same(pool.run("segment_cells", BASE, docs, "cpu"))
    assert strategy == "gather"
    for a, b in zip(cells, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
