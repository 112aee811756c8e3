"""Packed gram keys, mix32, cuckoo and bucket tables: the port against JAX.

The same inputs (numpy seed) go through the JAX package's ``ops.vocab``,
``ops.cuckoo``, ``ops.bucket``, ``ops.score._cuckoo_rows`` and
``ops.score_hist._bucket_rows`` and through the port's copies.

* Bit-exact: ``gram_key`` / ``window_keys`` / ``partial_window_keys`` /
  ``mix32`` (numpy and torch), ``build_cuckoo`` and ``entries()``, both
  bucket builds, both host lookups, ``_cuckoo_rows`` and ``_bucket_rows``.
* Reduction-order (``atol=1e-4, rtol=1e-5``, labels identical):
  ``score_batch_cuckoo``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_languagedetector_tpu.ops import bucket as jbucket
from spark_languagedetector_tpu.ops import cuckoo as jcuckoo
from spark_languagedetector_tpu.ops import score as jscore
from spark_languagedetector_tpu.ops import score_hist as jhist
from spark_languagedetector_tpu.ops import vocab as jv
from spark_languagedetector_tpu_torch.ops import bucket as tbucket
from spark_languagedetector_tpu_torch.ops import cuckoo as tcuckoo
from spark_languagedetector_tpu_torch.ops import score as tscore
from spark_languagedetector_tpu_torch.ops import score_hist as thist
from spark_languagedetector_tpu_torch.ops import vocab as tv
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch

ATOL, RTOL = 1e-4, 1e-5
L = 5
INT32_EDGES = np.asarray([0, -1, -(2**31), 2**31 - 1, 1, 0x7F00FF00], np.int64)


def _batch(seed, pad=64):
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(0, 256, int(rng.integers(0, 40))).tolist()) for _ in range(10)]
    docs += [b"", b"\x00", b"\xff", b"\xff\xff", b"\x80\x00\xff", b"\xff" * 4, b"\xff" * pad]
    return pad_batch(docs, pad)


def _grams(rng, n_grams, gram_lengths=(1, 2, 3, 4, 5), lo=97, hi=110):
    grams = set()
    while len(grams) < n_grams:
        n = int(rng.integers(min(gram_lengths), max(gram_lengths) + 1))
        grams.add(bytes(rng.integers(lo, hi, n).tolist()))
    return sorted(grams)


def _keys(grams):
    keys = [tv.gram_key(g) for g in grams]
    return (
        np.asarray([k[0] for k in keys], np.int32),
        np.asarray([k[1] for k in keys], np.int32),
    )


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_window_keys_bit_identical(n):
    batch, lengths = _batch(n)
    lo, hi = tv.window_keys(torch.from_numpy(batch), n)
    jlo, jhi = jv.window_keys(jnp.asarray(batch), n)
    assert lo.dtype == hi.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    nlo, nhi = tv.window_keys_numpy(batch, n)
    np.testing.assert_array_equal(nlo, np.asarray(jlo))
    np.testing.assert_array_equal(nhi, np.asarray(jhi))
    plo, phi = tv.partial_window_keys(torch.from_numpy(batch), torch.from_numpy(lengths), n)
    jplo, jphi = jv.partial_window_keys(jnp.asarray(batch), jnp.asarray(lengths), n)
    short = (lengths > 0) & (lengths < n)  # where the value is meaningful
    np.testing.assert_array_equal(plo.numpy()[short], np.asarray(jplo)[short])
    np.testing.assert_array_equal(phi.numpy()[short], np.asarray(jphi)[short])
    # A batch narrower than the window zero-extends.
    narrow = np.asarray([[0xFF, 0x80]], np.uint8)
    got = tv.window_keys(torch.from_numpy(narrow), n)
    ref = jv.window_keys(jnp.asarray(narrow), n)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_gram_key_matches_and_wraps():
    rng = np.random.default_rng(1)
    for n in range(1, 6):
        for _ in range(30):
            g = bytes(rng.integers(0, 256, n).tolist())
            assert tv.gram_key(g) == jv.gram_key(g)
    assert tv.gram_key(b"\xff\xff\xff\xff") == (-1, 4 << 8)
    assert tv.gram_key(b"\x80\x00\x00\x00\x07") == (-(2**31), 7 | 5 << 8)
    with pytest.raises(ValueError):
        tv.gram_key(b"abcdef")


@pytest.mark.parametrize("seed", [1, 0x9E3779B9, 2**31 - 2, 12345])
def test_mix32_bit_identical(seed):
    rng = np.random.default_rng(2)
    lo = np.concatenate([INT32_EDGES, rng.integers(-(2**31), 2**31, 500)]).astype(np.int32)
    hi = np.concatenate([INT32_EDGES[::-1], rng.integers(-(2**31), 2**31, 500)]).astype(np.int32)
    ref = jv.mix32(lo, hi, seed)
    np.testing.assert_array_equal(tv.mix32(lo, hi, seed), ref)
    got = tv.mix32_torch(torch.from_numpy(lo), torch.from_numpy(hi), seed)
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jv.mix32(jnp.asarray(lo), jnp.asarray(hi), seed, xp=jnp))
    )


@pytest.mark.parametrize("n_grams", [1, 37, 600])
def test_build_cuckoo_and_entries_bit_identical(n_grams):
    klo, khi = _keys(_grams(np.random.default_rng(n_grams), n_grams))
    t = tcuckoo.build_cuckoo(klo, khi)
    j = jcuckoo.build_cuckoo(klo, khi)
    assert (t.seed1, t.seed2) == (j.seed1, j.seed2)
    np.testing.assert_array_equal(t.slots, j.slots)
    np.testing.assert_array_equal(t.keys_lo, j.keys_lo)
    np.testing.assert_array_equal(t.keys_hi, j.keys_hi)
    np.testing.assert_array_equal(t.entries(), j.entries())
    probe_lo = np.concatenate([klo, klo ^ 1])
    probe_hi = np.concatenate([khi, khi])
    rows = tcuckoo.lookup_numpy(t, probe_lo, probe_hi)
    np.testing.assert_array_equal(rows, jcuckoo.lookup_numpy(j, probe_lo, probe_hi))
    np.testing.assert_array_equal(rows[:n_grams], np.arange(n_grams))


def test_build_buckets_bit_identical():
    rng = np.random.default_rng(3)
    klo, khi = _keys(_grams(rng, 900))
    t = tbucket.build_buckets_exact(klo, khi)
    j = jbucket.build_buckets_exact(klo, khi)
    assert (t.seed, t.kind) == (j.seed, j.kind) and t.kind == "exact"
    np.testing.assert_array_equal(t.rows, j.rows)
    ids = rng.choice(1 << 20, 700, replace=False).astype(np.int32)
    rows = rng.permutation(700).astype(np.int32)
    t = tbucket.build_buckets_hashed(ids, rows)
    j = jbucket.build_buckets_hashed(ids, rows)
    assert (t.seed, t.kind) == (j.seed, j.kind) and t.kind == "hashed"
    np.testing.assert_array_equal(t.rows, j.rows)
    np.testing.assert_array_equal(
        tbucket.lookup_numpy(t, ids, np.zeros_like(ids), -7),
        jbucket.lookup_numpy(j, ids, np.zeros_like(ids), -7),
    )
    # No zero-overflow seed within the budget: both give up.
    assert tbucket.build_buckets_hashed(ids, rows, max_seeds=0) is None


def _probe_keys(klo, khi, rng, shape):
    """Keys half of which hit the table, half of which miss."""
    pick = rng.integers(0, len(klo), shape)
    lo, hi = klo[pick], khi[pick]
    miss = rng.random(shape) < 0.5
    lo = np.where(miss, rng.integers(-(2**31), 2**31, shape), lo).astype(np.int32)
    return lo, hi


def test_cuckoo_rows_bit_identical():
    rng = np.random.default_rng(4)
    klo, khi = _keys(_grams(rng, 300))
    table = tcuckoo.build_cuckoo(klo, khi)
    lo, hi = _probe_keys(klo, khi, rng, (6, 50))
    G = len(klo)
    got = tscore._cuckoo_rows(
        torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(table.entries()),
        G, table.seed1, table.seed2,
    )
    ref = jscore._cuckoo_rows(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(table.entries()), G,
        table.seed1, table.seed2,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() < G).sum() > 0 and (got.numpy() == G).sum() > 0


@pytest.mark.parametrize("kind", ["exact", "hashed"])
def test_bucket_rows_bit_identical(kind):
    rng = np.random.default_rng(5)
    if kind == "exact":
        klo, khi = _keys(_grams(rng, 400))
        bt = tbucket.build_buckets_exact(klo, khi)
        # Wider than MEMBER_BLOCK, so both sides block the window axis.
        lo, hi = _probe_keys(klo, khi, rng, (3, thist.MEMBER_BLOCK + 300))
    else:
        ids = rng.choice(1 << 16, 500, replace=False).astype(np.int32)
        bt = tbucket.build_buckets_hashed(ids, rng.permutation(500).astype(np.int32))
        lo = np.where(rng.random((3, 700)) < 0.5, rng.choice(ids, (3, 700)),
                      rng.integers(0, 1 << 16, (3, 700))).astype(np.int32)
        hi = np.zeros_like(lo)
    got = thist._bucket_rows(
        torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(bt.rows), 9999,
        bt.seed, kind,
    )
    ref = jhist._bucket_rows(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(bt.rows), 9999,
                             bt.seed, kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), tbucket.lookup_numpy(bt, lo, hi, 9999))


@pytest.mark.parametrize("subset", [None, (3, 4, 5)])
@pytest.mark.parametrize("limited", [False, True])
def test_score_batch_cuckoo_matches_jax(subset, limited):
    rng = np.random.default_rng(6)
    spec, jspec = tv.VocabSpec("exact", (1, 2, 3, 4, 5)), jv.VocabSpec("exact", (1, 2, 3, 4, 5))
    grams = _grams(rng, 400)
    klo, khi = _keys(grams)
    table = tcuckoo.build_cuckoo(klo, khi)
    w = np.zeros((len(grams) + 1, L), np.float32)
    w[:-1] = rng.normal(size=(len(grams), L)).astype(np.float32)
    docs = [bytes(rng.integers(97, 110, int(rng.integers(0, 60))).tolist()) for _ in range(9)]
    docs += [b"", b"a", b"ab", b"abcd", bytes(rng.integers(0, 256, 200).tolist())]
    batch, lengths = pad_batch(docs, 256)
    lim = (rng.integers(1, 40, len(docs)) if limited else np.full(len(docs), 256)).astype(np.int32)
    got = tscore.score_batch_cuckoo(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(w),
        torch.from_numpy(table.entries()), seed1=table.seed1, seed2=table.seed2,
        spec=spec, window_limit=torch.from_numpy(lim), gram_lengths_subset=subset,
    ).numpy()
    ref = np.asarray(jscore.score_batch_cuckoo(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(w),
        jnp.asarray(table.entries()), seed1=table.seed1, seed2=table.seed2,
        spec=jspec, window_limit=jnp.asarray(lim), gram_lengths_subset=subset,
    ))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(np.argmax(got, 1), np.argmax(ref, 1))
    assert np.abs(ref).sum() > 0  # the profile's grams do occur
    with pytest.raises(ValueError, match="exact vocab"):
        tscore.score_batch_cuckoo(
            torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(w),
            torch.from_numpy(table.entries()), seed1=1, seed2=2,
            spec=tv.VocabSpec("hashed", (1, 2), 12),
        )
