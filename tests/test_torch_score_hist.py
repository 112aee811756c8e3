"""The port's row-histogram scorer (plain version on the CPU) against JAX.

The same profiles and documents (numpy seed) go through the JAX package's
``ops.score_hist`` (its Pallas kernel in interpret mode, ``block=128`` as
``tests/test_score_hist.py`` runs it), its gather scorers, and the port's
``score_hist`` with CPU tensors, which is the row-histogram kernel's plain
PyTorch version.

* Bit-exact: ``row_hist`` against JAX ``_hist_from_rows`` on the same rows
  plane, the miss row's entry zeroed (the TPU kernel counts a
  block-granularity-dependent number of miss windows there; the port's
  kernel leaves the miss row out of the function).
* Reduction-order (``atol=1e-4, rtol=1e-5``, labels identical):
  ``score_batch_hist`` over an exact (cuckoo-derived) bucket table, a hashed
  (LUT-derived) bucket table and the LUT itself, with window limits and gram
  subsets.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_languagedetector_tpu.ops import score as jscore
from spark_languagedetector_tpu.ops import score_hist as jhist
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu_torch.ops import score_hist as SH
from spark_languagedetector_tpu_torch.ops._kernels import ROW_HIST
from spark_languagedetector_tpu_torch.ops.bucket import build_buckets_exact, build_buckets_hashed
from spark_languagedetector_tpu_torch.ops.cuckoo import build_cuckoo
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
from spark_languagedetector_tpu_torch.ops.vocab import VocabSpec, gram_key, window_ids_numpy

ATOL, RTOL = 1e-4, 1e-5
L = 5
PAD = 256
BLOCK = 128


def _docs(rng, n=9):
    docs = [bytes(rng.integers(97, 110, int(rng.integers(0, 60))).tolist()) for _ in range(n)]
    # Empty, 1 byte, shorter than n = 3..5, bytes 0x00/0xFF, a full-width doc.
    docs += [b"", b"a", b"ab", b"abcd", b"\x00\xff\x00", bytes(rng.integers(0, 256, PAD).tolist())]
    return docs


def _exact_profile(rng, gram_lengths=(1, 2, 3, 4, 5), n_grams=400):
    grams = set()
    while len(grams) < n_grams:
        n = int(rng.integers(min(gram_lengths), max(gram_lengths) + 1))
        grams.add(bytes(rng.integers(97, 110, n).tolist()))
    grams = sorted(grams)
    keys = [gram_key(g) for g in grams]
    klo = np.asarray([k[0] for k in keys], np.int32)
    khi = np.asarray([k[1] for k in keys], np.int32)
    w = np.zeros((len(grams) + 1, L), np.float32)
    w[:-1] = rng.normal(size=(len(grams), L)).astype(np.float32)
    return w, klo, khi


def _lut_profile(rng, spec, docs, n_rows=300):
    """A LUT profile half of whose ids occur in ``docs``."""
    V = spec.id_space_size
    batch, _ = pad_batch(docs, PAD)
    seen = np.unique(np.concatenate(
        [window_ids_numpy(batch, n, spec).ravel() for n in spec.gram_lengths]
    ))
    learned = np.unique(np.concatenate([
        rng.choice(seen, n_rows // 2, replace=False),
        rng.choice(V, n_rows // 2, replace=False),
    ]))
    G = len(learned)
    lut = np.full(V, G, np.int32)
    lut[learned] = np.arange(G)
    w = np.zeros((G + 1, L), np.float32)
    w[:-1] = rng.normal(size=(G, L)).astype(np.float32)
    return w, lut


def _case(name, seed):
    """(spec args, weights, membership, gather reference, docs, rng)."""
    rng = np.random.default_rng(seed)
    docs = _docs(rng)
    if name == "exact_bucket":
        args = ("exact", (1, 2, 3, 4, 5))
        w, klo, khi = _exact_profile(rng)
        bt = build_buckets_exact(klo, khi)
        table = build_cuckoo(klo, khi)
        member = dict(bucket=bt.rows, bucket_seed=bt.seed, bucket_kind="exact")

        def gather(batch, lengths, lim, subset):
            return jscore.score_batch_cuckoo(
                batch, lengths, jnp.asarray(w), jnp.asarray(table.entries()),
                seed1=table.seed1, seed2=table.seed2, spec=JaxVocabSpec(*args),
                window_limit=lim, gram_lengths_subset=subset,
            )
    else:
        args = ("hashed", (1, 2, 3, 4, 5), 12) if name != "exact_lut_bucket" else ("exact", (1, 2, 3))
        w, lut = _lut_profile(rng, VocabSpec(*args), docs)
        if name == "lut":
            member = dict(lut=lut)
        else:
            ids = np.flatnonzero(lut != w.shape[0] - 1).astype(np.int32)
            bt = build_buckets_hashed(ids, lut[ids])
            member = dict(bucket=bt.rows, bucket_seed=bt.seed, bucket_kind="hashed")

        def gather(batch, lengths, lim, subset):
            return jscore.score_batch(
                batch, lengths, jnp.asarray(w), jnp.asarray(lut), spec=JaxVocabSpec(*args),
                window_limit=lim, gram_lengths_subset=subset,
            )
    return args, w, member, gather, docs, rng


def _port_member(member):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in member.items()}


def _jax_member(member):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in member.items()}


CASES = ["exact_bucket", "hashed_bucket", "exact_lut_bucket", "lut"]


@pytest.mark.parametrize("subset", [None, (3, 4)])
@pytest.mark.parametrize("limited", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_score_batch_hist_matches_jax(name, limited, subset):
    args, w, member, gather, docs, rng = _case(name, 7)
    if subset is not None and max(args[1]) < 4:
        subset = (2, 3)
    spec = VocabSpec(*args)
    batch, lengths = pad_batch(docs, PAD)
    lim = (rng.integers(1, 40, len(docs)) if limited else np.full(len(docs), PAD)).astype(np.int32)
    wp, rhi = SH.pad_weights(w)
    got = SH.score_batch_hist(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(wp).double(),
        window_limit=torch.from_numpy(lim), spec=spec, rhi=rhi,
        gram_lengths_subset=subset, **_port_member(member),
    ).numpy()
    ref = np.asarray(jhist.score_batch_hist(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(wp),
        window_limit=jnp.asarray(lim), spec=JaxVocabSpec(*args), rhi=rhi,
        gram_lengths_subset=subset, interpret=True, block=BLOCK, **_jax_member(member),
    ))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(np.argmax(got, 1), np.argmax(ref, 1))
    gref = np.asarray(gather(jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(lim), subset))
    np.testing.assert_allclose(got, gref, atol=ATOL, rtol=RTOL)
    assert np.abs(gref).sum() > 0


@pytest.mark.parametrize("rhi", [8, 16])
def test_row_hist_plain_matches_jax_kernel(rhi):
    """The same rows plane through JAX ``_hist_from_rows`` (interpret mode)
    and the port's plain version: identical counts outside the miss row.
    Windows at or past a document's vmax hold the miss row, as the scorer
    guarantees; the JAX kernel skips whole blocks past vmax."""
    rng = np.random.default_rng(rhi)
    B, K, W = 16, 3, 2 * BLOCK
    R = rhi * 256
    miss = R - 1
    rows = rng.integers(0, R, (B, K * W)).astype(np.int32)
    rows[rng.random((B, K * W)) < 0.3] = miss
    vmax = rng.integers(0, W + 1, B).astype(np.int32)
    vmax[:3] = (0, 1, W)
    local = np.arange(K * W) % W
    rows[local[None, :] >= vmax[:, None]] = miss
    got = SH.row_hist(torch.from_numpy(rows), torch.from_numpy(vmax), W, rhi, miss).numpy()
    ref = np.array(jhist._hist_from_rows(
        jnp.asarray(rows), jnp.asarray(vmax), W, rhi, block=BLOCK, interpret=True
    ))
    ref[:, miss] = 0
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32 and got.sum() > 0
    # Ids outside [0, R) and windows past vmax never count.
    rows[:, 0] = -1
    rows[:, 1] = R
    rows[0, :] = 0
    got2 = SH.row_hist(torch.from_numpy(rows), torch.from_numpy(vmax), W, rhi, miss).numpy()
    assert got2[0].sum() == 0  # vmax[0] == 0
    assert got2[1, 0] == (rows[1, :1] == 0).sum()


def test_row_hist_wrapper_takes_plain_version_only_on_cpu():
    rows = torch.zeros((2, 6), dtype=torch.int32)
    vmax = torch.tensor([3, 0], dtype=torch.int32)
    launches = ROW_HIST.launches
    got = SH.row_hist(rows, vmax, 3, 1, 255)
    assert ROW_HIST.launches == launches  # no kernel launch on the CPU
    assert got.shape == (2, 256) and float(got[0, 0]) == 6.0 and float(got[1].sum()) == 0.0
    with pytest.raises(ValueError, match="CUDA"):
        SH.row_hist_kernel(rows, vmax, 3, 1, 255)


def test_hist_contraction_runs_in_float64(monkeypatch):
    """Counts x weights never go through a float32 matmul, so no TF32 or
    reduced-precision setting can reach them."""
    args, w, member, _, docs, _ = _case("exact_bucket", 3)
    batch, lengths = pad_batch(docs, PAD)
    wp, rhi = SH.pad_weights(w)
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append((a.dtype, b.dtype))
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    SH.score_batch_hist(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(wp).double(),
        spec=VocabSpec(*args), rhi=rhi, **_port_member(member),
    )
    assert seen == [(torch.float64, torch.float64)]
    with pytest.raises(ValueError, match="float64"):
        SH.score_batch_hist(
            torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(wp),
            spec=VocabSpec(*args), rhi=rhi, **_port_member(member),
        )


def test_pad_weights_matches_jax():
    w = np.random.default_rng(1).normal(size=(300, L))
    got, rhi = SH.pad_weights(w)
    ref, jrhi = jhist.pad_weights(w)
    assert rhi == jrhi == 8
    np.testing.assert_array_equal(got, ref)
    assert not got[-1].any()  # the last row is zero: the miss row
