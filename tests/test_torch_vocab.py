"""The port's window ids against the JAX package's, bit for bit.

Same uint8 batches (numpy seed) through JAX ``window_ids`` /
``partial_window_ids`` / ``prefix_hashes``, the host ``window_ids_numpy``, and
the port's torch versions, over an exact vocab, a hashed fnv1a vocab
(``hash_bits=12``) and a hashed exact12 vocab (``hash_bits=20``). The batches
hold documents shorter than n and the bytes 0x00 and 0xFF.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_languagedetector_tpu.ops import vocab as jv
from spark_languagedetector_tpu_torch.ops import vocab as tv
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch

SPECS = {
    "exact_n1_3": ("exact", (1, 2, 3), 20),
    "hashed_fnv1a_12": ("hashed", (1, 2, 3, 4, 5), 12),
    "hashed_exact12_20": ("hashed", (1, 2, 3, 4, 5), 20),
}


def _batch(seed):
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(0, 256, int(rng.integers(0, 40))).tolist()) for _ in range(12)]
    docs += [b"", b"\x00", b"\xff", b"\xff\xff", b"\x00\xff\x00\xff", b"\xff" * 33]
    return pad_batch(docs, 64)


@pytest.mark.parametrize("name", list(SPECS))
def test_window_ids_bit_identical(name):
    mode, glens, bits = SPECS[name]
    spec, jspec = tv.VocabSpec(mode, glens, bits), jv.VocabSpec(mode, glens, bits)
    assert spec.hash_scheme == jspec.hash_scheme
    assert spec.id_space_size == jspec.id_space_size
    batch, lengths = _batch(1)
    tb, tl = torch.from_numpy(batch), torch.from_numpy(lengths)
    for n in glens:
        got = tv.window_ids(tb, n, spec)
        ref = np.asarray(jv.window_ids(jnp.asarray(batch), n, jspec))
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), tv.window_ids_numpy(batch, n, spec))
        np.testing.assert_array_equal(
            tv.window_ids_numpy(batch, n, spec), jv.window_ids_numpy(batch, n, jspec)
        )
        pw = tv.partial_window_ids(tb, tl, n, got[:, 0], spec)
        jpw = jv.partial_window_ids(
            jnp.asarray(batch), jnp.asarray(lengths), n, jnp.asarray(ref[:, 0]), jspec
        )
        short = (lengths > 0) & (lengths < n)  # where the value is meaningful
        np.testing.assert_array_equal(pw.numpy()[short], np.asarray(jpw)[short])
    if mode == "hashed":
        got = tv.prefix_hashes(tb, 4, spec)
        ref = np.asarray(jv.prefix_hashes(jnp.asarray(batch), 4, jspec))
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", list(SPECS))
def test_short_docs_and_gram_ids_match(name):
    """Host rules: gram ↔ id and the partial-window ids of short docs."""
    mode, glens, bits = SPECS[name]
    spec, jspec = tv.VocabSpec(mode, glens, bits), jv.VocabSpec(mode, glens, bits)
    rng = np.random.default_rng(2)
    for k in range(1, max(glens) + 1):
        for _ in range(20):
            g = bytes(rng.integers(0, 256, k).tolist())
            assert spec.gram_to_id(g) == jspec.gram_to_id(g)
            assert tv.short_doc_ids_numpy(g, spec) == jv.short_doc_ids_numpy(g, jspec)
    # A batch narrower than the window zero-extends, like the JAX version.
    narrow = np.asarray([[7, 255]], np.uint8)
    for n in glens:
        np.testing.assert_array_equal(
            tv.window_ids(torch.from_numpy(narrow), n, spec).numpy(),
            np.asarray(jv.window_ids(jnp.asarray(narrow), n, jspec)),
        )


def test_vocab_spec_validation_matches():
    for args in (("exact", (6,)), ("hashed", (1,), 31), ("hashed", (1,), 16, "exact12"), ("x", (1,))):
        with pytest.raises(ValueError) as theirs:
            jv.VocabSpec(*args)
        with pytest.raises(ValueError) as ours:
            tv.VocabSpec(*args)
        assert str(ours.value) == str(theirs.value)


def test_exact_long_window_ids_point_to_packed_keys():
    """Exact 4- and 5-gram ids overflow int32: the device ids are refused
    with a pointer to the packed keys; the host ids (int64) stay exact."""
    batch = np.arange(16, dtype=np.uint8).reshape(2, 8)
    for n in (4, 5):
        spec = tv.VocabSpec("exact", tuple(range(1, n + 1)))
        with pytest.raises(ValueError, match="window_keys"):
            tv.window_ids(torch.from_numpy(batch), n, spec)
        np.testing.assert_array_equal(
            tv.window_ids_numpy(batch, n, spec),
            jv.window_ids_numpy(batch, n, jv.VocabSpec("exact", tuple(range(1, n + 1)))),
        )
