"""The port's own native packer against the JAX package's and the numpy packers.

* the library builds with g++ under ``build/native/`` (named by a hash of
  the sources), never in either package's folder, and loads from there;
* ``pack_batch``, ``pack_ragged``, ``clean_bytes`` and ``ascii_lower`` are
  bit-exact against the JAX ``native`` module and the numpy packers, into
  fresh arrays and into caller buffers;
* without a compiler the numpy packers serve, and ``native/unavailable``
  counts it;
* ``RefScorer`` agrees with the port's host float64 scorer.
"""

from pathlib import Path

import numpy as np
import pytest

import spark_languagedetector_tpu as jax_pkg
from spark_languagedetector_tpu import native as jnative
from spark_languagedetector_tpu_torch import native
from spark_languagedetector_tpu_torch.models.profile import GramProfile
from spark_languagedetector_tpu_torch.ops.encode_device import DocBlock
from spark_languagedetector_tpu_torch.ops.encoding import pack_ragged_numpy, pad_batch
from spark_languagedetector_tpu_torch.ops.score import score_batch_numpy
from spark_languagedetector_tpu_torch.telemetry import REGISTRY

PORT_DIR = Path(native.__file__).resolve().parents[1]
ROOT = PORT_DIR.parent


def _docs(seed=0, n=50):
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(0, 256, int(rng.integers(0, 700))).tolist()) for _ in range(n)]
    return docs + [b"", b"a", b"b" * 128, b"c" * 8192, b"d" * 9000]


def test_library_builds_under_build_native():
    assert native.available()
    path = native.library_path()
    assert path.is_file()
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libpacker_") and path.suffix == ".so"
    jax_dir = Path(jax_pkg.__file__).resolve().parent
    for pkg in (PORT_DIR, jax_dir):
        assert pkg not in path.parents
    assert not list((PORT_DIR / "native").glob("*.so"))
    # The build directory is ignored by git.
    assert "build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("pad_to", [128, 1024, 8192])
def test_pack_batch_equals_jax_and_numpy(pad_to):
    docs = _docs(1)
    got = native.pack_batch(docs, pad_to, n_threads=3)
    for ref in (jnative.pack_batch(docs, pad_to), pad_batch(docs, pad_to)):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[1].dtype == np.int32
    out = np.full((len(docs), pad_to), 0x77, np.uint8)
    lens = np.full(len(docs), -1, np.int32)
    b, ln = native.pack_batch(docs, pad_to, out=out, lengths_out=lens)
    assert b is out and ln is lens
    np.testing.assert_array_equal(out, got[0])
    np.testing.assert_array_equal(lens, got[1])
    block = native.pack_batch(DocBlock.from_bytes(docs), pad_to)
    np.testing.assert_array_equal(block[0], got[0])
    with pytest.raises(ValueError, match="out"):
        native.pack_batch(docs, pad_to, out=out[:, : pad_to // 2])


@pytest.mark.parametrize("pad_to", [128, 1024, 8192])
@pytest.mark.parametrize("flat_step", [None, 100])
def test_pack_ragged_equals_jax_and_numpy(pad_to, flat_step):
    docs = _docs(2)
    got = native.pack_ragged(docs, pad_to, flat_step=flat_step, n_threads=2)
    for ref in (jnative.pack_ragged(docs, pad_to, flat_step=flat_step),
                pack_ragged_numpy(docs, pad_to, flat_step)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    out = np.full_like(got[0], 0x33)
    again = native.pack_ragged(docs, pad_to, flat_step=flat_step, out=out)
    assert again[0] is out
    np.testing.assert_array_equal(out, got[0])


def test_clean_and_lower_equal_jax():
    rng = np.random.default_rng(3)
    samples = [bytes(rng.integers(0, 256, int(rng.integers(0, 200))).tolist()) for _ in range(40)]
    samples += [b"", b"  Hello,\t\tWorld /_[]*()  ", "Ünïcödé  X".encode()]
    for s in samples:
        assert native.clean_bytes(s) == jnative.clean_bytes(s)
        assert native.ascii_lower(s) == jnative.ascii_lower(s)


def test_numpy_fallback_without_a_library(monkeypatch):
    docs = _docs(4)
    want_b = native.pack_batch(docs, 1024)
    want_r = native.pack_ragged(docs, 1024, flat_step=64)
    want_c = [native.clean_bytes(d) for d in docs[:10]]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "library_path", lambda: ROOT / "build" / "native" / "missing.so")
    monkeypatch.setattr(native, "_build", lambda out: False)
    REGISTRY.reset()
    assert not native.available()
    assert REGISTRY.snapshot()["counters"]["native/unavailable"] == 1
    assert not native.available()  # counted once
    assert REGISTRY.snapshot()["counters"]["native/unavailable"] == 1
    for a, b in zip(native.pack_batch(docs, 1024), want_b):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(native.pack_ragged(docs, 1024, flat_step=64), want_r):
        np.testing.assert_array_equal(a, b)
    assert [native.clean_bytes(d) for d in docs[:10]] == want_c
    with pytest.raises(RuntimeError, match="unavailable"):
        native.RefScorer([b"a"], np.ones((1, 2)))


def test_refscorer_agrees_with_the_port_host_scorer():
    rng = np.random.default_rng(7)
    langs = ["a", "b", "c", "d"]
    gram_lengths = [1, 2, 3]
    alphabet = b"abcdefg"
    gram_map = {}
    for _ in range(120):
        n = int(rng.integers(1, 4))
        gram_map[bytes(rng.choice(list(alphabet), n).tolist())] = rng.normal(size=4).tolist()
    profile = GramProfile.from_gram_map(gram_map, langs, gram_lengths)
    keys = list(gram_map)
    docs = [bytes(rng.choice(list(alphabet), int(rng.integers(0, 40))).tolist())
            for _ in range(300)] + [b"", b"a", b"ab", b"zz"]
    rs = native.RefScorer(keys, np.asarray([gram_map[k] for k in keys]))
    try:
        got = rs.score(docs, gram_lengths)
        np.testing.assert_array_equal(got, rs.score(docs, gram_lengths, n_threads=4))
    finally:
        rs.close()
    w, ids = profile.host_arrays()
    host = score_batch_numpy(docs, w, ids, profile.spec)
    np.testing.assert_array_equal(got, np.argmax(host, axis=1))
    with pytest.raises(RuntimeError, match="closed"):
        rs.score(docs, gram_lengths)
