"""The port's cold-start plane against the JAX package's.

Baked artifacts share the ``ldbake`` v1 format: the same profile baked by
either package gives byte-identical ``blocks.bin`` and equal headers for the
dense, LUT and cuckoo device forms in f64, int8 and int16, and each package
loads the other's bake. The port's baked model scores bit for bit as its
parquet-loaded model and labels as the JAX model does (scores in the
reduction-order class). The JAX package's torn-write, recovery, mapping and
knob cases hold in the port, and so does the prewarm's full → sentinel →
self-heal sequence under the port's rule of a verified-warm cache: every
kernel library the runner launches found in the cache and loaded, no nvcc
run (on the CPU a runner launches none).
"""

import functools
import json
import os
import shutil
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

from spark_languagedetector_tpu.artifacts import bake as jbake
from spark_languagedetector_tpu.models.profile import GramProfile as JaxProfile
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxSpec
from spark_languagedetector_tpu_torch import LanguageDetectorModel
from spark_languagedetector_tpu_torch.api.runner import BatchRunner
from spark_languagedetector_tpu_torch.artifacts import bake as tbake
from spark_languagedetector_tpu_torch.artifacts import compile_cache
from spark_languagedetector_tpu_torch.artifacts.bake import (
    BLOCKS_NAME,
    ArtifactError,
    artifact_path_for,
    bake_model,
    load_artifact,
    load_baked_model,
    maybe_load_baked,
    recover_artifact,
)
from spark_languagedetector_tpu_torch.models.profile import GramProfile
from spark_languagedetector_tpu_torch.ops import _kernels
from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec
from spark_languagedetector_tpu_torch.serve.registry import ModelRegistry
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

# (mode, gram lengths, hash bits, languages): the device form each bakes to.
FORMS = {
    "dense": ("exact", (1, 2), 20, 3),
    "lut": ("hashed", (1, 2, 3), 12, 8),
    "cuckoo": ("exact", (2, 4), 20, 3),
}
DTYPES = [None, "int8", "int16"]
DOCS = [b"abc abc xyz", b"qqrrss", b"the quick brown fox", b"zz", b"", b"a",
        b"lorem ipsum dolor sit amet " * 6, bytes(range(97, 123)) * 3]
UID = "LanguageDetectorModel_bake0"


@functools.lru_cache(maxsize=None)
def _arrays(form: str):
    """(ids, weights) of one seeded profile of ``form``."""
    mode, glens, bits, L = FORMS[form]
    rng = np.random.default_rng(list(FORMS).index(form))
    spec = VocabSpec(mode, glens, hash_bits=bits)
    if mode == "exact":
        grams = {bytes(rng.integers(97, 123, size=n).tolist()) for n in glens for _ in range(120)}
        ids = np.unique([spec.gram_to_id(g) for g in grams]).astype(np.int64)
    else:
        ids = np.unique(rng.integers(0, spec.id_space_size, size=300)).astype(np.int64)
    weights = rng.normal(size=(len(ids), L))
    return ids, weights


def _langs(form):
    return tuple(f"l{i}" for i in range(FORMS[form][3]))


def _profiles(form):
    """The same profile in both packages."""
    mode, glens, bits, _ = FORMS[form]
    ids, weights = _arrays(form)
    return (
        JaxProfile(spec=JaxSpec(mode, glens, hash_bits=bits), languages=_langs(form),
                   ids=ids.copy(), weights=weights.copy()),
        GramProfile(spec=VocabSpec(mode, glens, hash_bits=bits), languages=_langs(form),
                    ids=ids.copy(), weights=weights.copy()),
    )


def _port_model(form):
    return LanguageDetectorModel(_profiles(form)[1], uid=UID, device="cpu")


def _counter(name: str) -> int:
    return int(REGISTRY.snapshot()["counters"].get(name, 0))


def _gram_model(seed=0, gram_lengths=(1, 2)):
    """The JAX tests' small exact model, in the port."""
    rng = np.random.default_rng(seed)
    grams = {}
    for n in gram_lengths:
        for _ in range(120):
            grams[bytes(rng.integers(97, 123, size=n).tolist())] = rng.random(3).tolist()
    return LanguageDetectorModel.from_gram_map(grams, gram_lengths, ("de", "en", "fr"),
                                               device="cpu")


def _saved_and_baked(tmp_path, model=None):
    model = _gram_model() if model is None else model
    md = tmp_path / "model"
    model.save(str(md))
    return model, md, Path(bake_model(model, artifact_path_for(md)))


# ------------------------------------------------------- across packages ---
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d or "f64")
@pytest.mark.parametrize("form", list(FORMS))
def test_bake_is_byte_identical_across_packages(form, dtype, tmp_path):
    jprof, tprof = _profiles(form)
    params = _port_model(form).param_metadata()
    jpath = jbake.bake_artifact(tmp_path / "jax.baked", jprof, UID, params, quantize=dtype)
    tpath = tbake.bake_artifact(tmp_path / "port.baked", tprof, UID, params, quantize=dtype)
    assert (Path(jpath) / BLOCKS_NAME).read_bytes() == (Path(tpath) / BLOCKS_NAME).read_bytes()
    jhead = json.loads((Path(jpath) / "header.json").read_text())
    assert jhead == json.loads((Path(tpath) / "header.json").read_text())
    assert jhead["device_form"] == form

    # The port's parquet save of the same model, quantized alike.
    model = _port_model(form)
    writer = model.write().overwrite()
    (writer.quantized(dtype) if dtype else writer).save(str(tmp_path / "m"))
    parquet = LanguageDetectorModel.load(str(tmp_path / "m"), device="cpu")

    want_s = parquet.runner.score(DOCS)
    want_l = np.argmax(want_s, axis=1)
    for path in (tpath, jpath):  # each package's bake, loaded by the port
        baked = load_baked_model(path, device="cpu")
        np.testing.assert_array_equal(baked.profile.ids, parquet.profile.compacted().ids)
        np.testing.assert_array_equal(baked.profile.weights, parquet.profile.compacted().weights)
        np.testing.assert_array_equal(baked.runner.score(DOCS), want_s)
        np.testing.assert_array_equal(baked.runner.predict_ids(DOCS), want_l)
    for path in (tpath, jpath):  # and by the JAX package
        jmodel = jbake.load_baked_model(path)
        jscores = np.asarray(jmodel._get_runner().score(DOCS))
        np.testing.assert_array_equal(np.argmax(jscores, axis=1), want_l)
        np.testing.assert_allclose(jscores, want_s, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("form", list(FORMS))
def test_prebuilt_membership_equals_device_membership(form, tmp_path):
    path = bake_model(_port_model(form), tmp_path / "m.baked")
    baked = load_baked_model(path, device="cpu")
    pb = baked._prebuilt_membership
    w, lut, ck = baked.profile.device_membership(device="cpu")
    np.testing.assert_array_equal(np.asarray(pb["weights"]), w.numpy())
    assert (pb["lut"] is None) == (lut is None) and (pb["cuckoo"] is None) == (ck is None)
    if lut is not None:
        np.testing.assert_array_equal(np.asarray(pb["lut"]), lut.numpy())
    if ck is not None:
        for field in ("slots", "keys_lo", "keys_hi"):
            np.testing.assert_array_equal(getattr(pb["cuckoo"], field), getattr(ck, field))
        assert (pb["cuckoo"].seed1, pb["cuckoo"].seed2) == (ck.seed1, ck.seed2)
    # A copy carries no mapped views: it rebuilds membership from the profile.
    assert not hasattr(baked.copy(), "_prebuilt_membership")


@pytest.mark.parametrize("strategy", ["auto", "gather"])
@pytest.mark.parametrize("form", list(FORMS))
def test_cpu_runner_never_aliases_the_mapping(form, strategy, tmp_path):
    """The mapped blocks are read-only: a CPU runner built on them copies
    where a later op could write, and torch never sees a non-writable
    array."""
    path = bake_model(_port_model(form), tmp_path / "m.baked")
    pb = load_baked_model(path, device="cpu")._prebuilt_membership
    buf = load_artifact(path)._buf
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*not writable.*")
        runner = BatchRunner(weights=pb["weights"], lut=pb["lut"], cuckoo=pb["cuckoo"],
                             spec=_profiles(form)[1].spec, device="cpu", strategy=strategy)
        scores = runner.score(DOCS)
        runner._host_operands()
    ref = _port_model(form).runner if strategy == "auto" else BatchRunner(
        *_port_model(form).profile.device_membership(device="cpu")[:2],
        cuckoo=_port_model(form).profile.device_membership(device="cpu")[2],
        spec=_profiles(form)[1].spec, device="cpu", strategy=strategy)
    np.testing.assert_array_equal(scores, ref.score(DOCS))
    for t in runner.device_tables() + list(runner._host_ops):
        if t is not None:
            assert not np.shares_memory(t.numpy(), buf)


# ---------------------------------------------------- torn-write shapes ---
def test_torn_blocks_refused_and_parquet_fallback(tmp_path):
    _, md, art = _saved_and_baked(tmp_path)
    blocks = art / BLOCKS_NAME
    data = blocks.read_bytes()
    blocks.write_bytes(data[: len(data) // 2])
    with pytest.raises(ArtifactError, match="torn write"):
        load_artifact(art)
    before = _counter("artifacts/load_errors")
    assert maybe_load_baked(md, device="cpu") is None
    assert _counter("artifacts/load_errors") == before + 1
    # The registry's load takes the parquet tree and counts no baked load.
    baked0 = _counter("artifacts/baked_loads")
    reg = ModelRegistry(device="cpu")
    reg.load(str(md))
    assert _counter("artifacts/baked_loads") == baked0
    assert _counter("artifacts/load_errors") == before + 2
    assert reg.peek().model.profile.num_grams == _gram_model().profile.num_grams


def test_missing_end_magic_refused(tmp_path):
    _, _, art = _saved_and_baked(tmp_path)
    blocks = art / BLOCKS_NAME
    data = bytearray(blocks.read_bytes())
    data[-8:] = b"\x00" * 8
    blocks.write_bytes(bytes(data))
    with pytest.raises(ArtifactError, match="magic"):
        load_artifact(art)


def test_foreign_format_refused(tmp_path):
    _, md, art = _saved_and_baked(tmp_path)
    head = json.loads((art / "header.json").read_text())
    head["version"] = 2
    (art / "header.json").write_text(json.dumps(head))
    with pytest.raises(ArtifactError, match="format"):
        load_artifact(art)
    assert maybe_load_baked(md, device="cpu") is None


def test_recover_promotes_valid_sibling_never_torn(tmp_path):
    model, md, root = _saved_and_baked(tmp_path)
    good = root.parent / f".{root.name}.tmp.111"
    os.replace(root, good)  # root gone: the crashed-mid-swap shape
    torn = root.parent / f".{root.name}.tmp.222"
    shutil.copytree(good, torn)
    tb = torn / BLOCKS_NAME
    tb.write_bytes(tb.read_bytes()[:-16])
    future = time.time() + 60
    os.utime(torn, (future, future))

    assert recover_artifact(root) is True
    baked = load_baked_model(root, device="cpu")
    np.testing.assert_array_equal(baked.profile.weights, model.profile.weights)
    assert not list(root.parent.glob(f".{root.name}.tmp.*"))
    # The JAX package recovers the port's bake the same way.
    os.replace(root, good)
    assert jbake.recover_artifact(root) is True


def test_recover_refuses_when_only_torn_candidates(tmp_path):
    _, md, root = _saved_and_baked(tmp_path)
    torn = root.parent / f".{root.name}.tmp.9"
    os.replace(root, torn)
    tb = torn / BLOCKS_NAME
    tb.write_bytes(tb.read_bytes()[:100])
    assert recover_artifact(root) is False
    assert not root.exists()
    assert maybe_load_baked(md, device="cpu") is None


# ---------------------------------------------------------- mmap sharing ---
def test_concurrent_readers_share_one_mapping(tmp_path):
    model, _, art = _saved_and_baked(tmp_path)
    a1, a2 = load_artifact(art), load_artifact(art)
    assert a1._buf is a2._buf
    m1, m2 = load_baked_model(art, device="cpu"), load_baked_model(art, device="cpu")
    assert np.shares_memory(np.asarray(m1._prebuilt_membership["weights"]),
                            np.asarray(m2._prebuilt_membership["weights"]))
    # A re-bake is another file generation: it maps fresh.
    bake_model(model, art)
    assert load_artifact(art)._buf is not a1._buf


# ------------------------------------------------------------ knob routing ---
def test_artifact_dir_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("LANGDETECT_ARTIFACT_DIR", str(tmp_path / "arts"))
    assert artifact_path_for("/nowhere/model") == tmp_path / "arts" / "model.baked"
    assert artifact_path_for("/nowhere/model") == jbake.artifact_path_for("/nowhere/model")
    monkeypatch.delenv("LANGDETECT_ARTIFACT_DIR")
    assert artifact_path_for("/nowhere/model") == Path("/nowhere/model.baked")


def test_bake_on_save_knob(tmp_path, monkeypatch):
    """Every native save also bakes, with the save's quantization codec; a
    bake that fails is logged and the save stands."""
    monkeypatch.setenv("LANGDETECT_BAKE_ON_SAVE", "1")
    model = _gram_model()
    md = tmp_path / "model"
    model.write().overwrite().quantized("int8").save(str(md))
    art = artifact_path_for(md)
    assert art.exists()
    baked = load_baked_model(art, device="cpu")
    loaded = LanguageDetectorModel.load(str(md), device="cpu")
    np.testing.assert_array_equal(loaded.profile.weights, baked.profile.weights)
    assert json.loads((art / "header.json").read_text())["quantization"]["dtype"] == "int8"

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tbake, "bake_artifact", broken)
    model.save(str(tmp_path / "model2"))  # no raise
    assert LanguageDetectorModel.load(str(tmp_path / "model2"), device="cpu").uid == model.uid
    assert not artifact_path_for(tmp_path / "model2").exists()


def test_registry_and_zoo_cold_loads_map_the_bake(tmp_path):
    from spark_languagedetector_tpu_torch.zoo import ModelZoo

    model, md, art = _saved_and_baked(tmp_path)
    want = model.runner.score(DOCS)
    baked0 = _counter("artifacts/baked_loads")
    reg = ModelRegistry(device="cpu")
    reg.load(str(md), artifact=str(art))
    served = reg.peek()
    assert _counter("artifacts/baked_loads") == baked0 + 1
    assert hasattr(served.model, "_prebuilt_membership")
    np.testing.assert_array_equal(served.runner.score(DOCS), want)
    reg.close()

    zoo = ModelZoo(device="cpu", max_wait_ms=2)
    try:
        zoo.add_tenant("t0", path=str(md))
        _, rt = zoo.runtime("t0")
        assert _counter("artifacts/baked_loads") == baked0 + 2
        np.testing.assert_array_equal(rt.registry.peek().runner.score(DOCS), want)
    finally:
        zoo.close()


# ------------------------------------------------------- the build cache ---
def test_enable_compile_cache_points_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    before = _kernels.BUILD_DIR
    assert compile_cache.enable_compile_cache(env={}) is None
    assert _kernels.BUILD_DIR == before
    got = compile_cache.enable_compile_cache(env={"LANGDETECT_COMPILE_CACHE_DIR": str(tmp_path / "cc")})
    assert got == str(tmp_path / "cc") and (tmp_path / "cc").is_dir()
    assert _kernels.BUILD_DIR == tmp_path / "cc"
    assert _kernels.FUSED_DETECT.library_path.parent == tmp_path / "cc"


def _runner(buckets=(128, 256)):
    w, lut, ck = _gram_model().profile.device_membership(device="cpu")
    runner = BatchRunner(weights=w, lut=lut, cuckoo=ck, spec=_gram_model().profile.spec,
                         device="cpu", strategy="gather", length_buckets=buckets)
    runner._cost_recorded = True
    return runner


class _StubKernel:
    """A kernel library in the cache directory, standing in for a CUDA
    one on the CPU: building it writes the file and counts a miss."""

    name = "stub"

    @property
    def library_path(self) -> Path:
        return _kernels.BUILD_DIR / "libstub_0123456789abcdef.so"

    def library(self):
        assert self.library_path.is_file()


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    return Path(compile_cache.enable_compile_cache(str(tmp_path / "cc")))


def test_prewarm_full_trace_writes_manifest(cache_dir):
    runner = _runner()
    out = compile_cache.prewarm_lattice(runner, cache_dir=str(cache_dir))
    assert out["mode"] == "full" and out["buckets"] == [128, 256]
    assert out["verified_hit"] is None
    manifests = list(cache_dir.glob("lattice-*.manifest.json"))
    assert len(manifests) == 1
    sig = json.loads(manifests[0].read_text())
    assert sig == compile_cache._lattice_signature(runner, (128, 256))
    assert sig["kernels"] == [] and sig["device"] == "cpu"


def test_prewarm_full_sentinel_self_heal(cache_dir, monkeypatch):
    """Full (the library built: a miss), then sentinel (found, loaded, no
    build: verified), then the library wiped behind the manifest: the
    sentinel's proof fails and the full lattice runs again, rewriting the
    manifest."""
    stub = _StubKernel()
    built = []

    def build_all(kernels):
        for k in kernels:
            k.library_path.write_bytes(b"\x7fELF")
            REGISTRY.incr("compile_cache/misses")
            built.append(k.name)

    monkeypatch.setattr(_kernels, "build_all", build_all)
    scored = []

    def runner_with_stub():
        runner = _runner()
        runner.kernels = lambda: (stub,)
        real = runner.score
        runner.score = lambda docs: scored.append(len(docs[0])) or real(docs)
        return runner

    out1 = compile_cache.prewarm_lattice(runner_with_stub(), cache_dir=str(cache_dir))
    assert (out1["mode"], out1["verified_hit"], built, scored) == ("full", None, ["stub"],
                                                                    [128, 256])
    scored.clear()
    out2 = compile_cache.prewarm_lattice(runner_with_stub(), cache_dir=str(cache_dir))
    assert (out2["mode"], out2["verified_hit"], built, scored) == ("sentinel", True, ["stub"],
                                                                    [128])
    stub.library_path.unlink()  # an evicted cache behind a valid manifest
    scored.clear()
    out3 = compile_cache.prewarm_lattice(runner_with_stub(), cache_dir=str(cache_dir))
    assert (out3["mode"], out3["verified_hit"], scored) == ("full", False, [128, 256])
    assert built == ["stub", "stub"]
    # Healed: the next prewarm is a verified sentinel again.
    assert compile_cache.prewarm_lattice(
        runner_with_stub(), cache_dir=str(cache_dir))["verified_hit"] is True
    # Off the card the kernel set is empty, and the proof holds.
    plain = _runner()
    assert compile_cache.prewarm_lattice(plain, cache_dir=str(cache_dir))["mode"] == "full"
    out = compile_cache.prewarm_lattice(_runner(), cache_dir=str(cache_dir))
    assert (out["mode"], out["verified_hit"]) == ("sentinel", True)


def test_prewarm_signature_mismatch_forces_full_trace(cache_dir):
    compile_cache.prewarm_lattice(_runner(buckets=(128,)), cache_dir=str(cache_dir))
    out = compile_cache.prewarm_lattice(_runner(buckets=(128, 256)), cache_dir=str(cache_dir))
    assert out["mode"] == "full" and out["verified_hit"] is None
    assert len(list(cache_dir.glob("lattice-*.manifest.json"))) == 2


def test_prewarm_without_cache_dir_never_writes_manifest(monkeypatch):
    def no_manifest(*a, **k):
        raise AssertionError("a manifest path was computed without a cache dir")

    monkeypatch.setattr(compile_cache, "_manifest_path", no_manifest)
    out = compile_cache.prewarm_lattice(_runner(buckets=(128,)))
    assert out["mode"] == "full" and out["verified_hit"] is None
    assert REGISTRY.snapshot()["histograms"]["artifacts/prewarm_s"]["count"] >= 1
