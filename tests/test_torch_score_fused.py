"""The port's fused kernel (plain version on the CPU) against the JAX package.

Same profiles and documents, made from a numpy seed, go through the JAX fused
kernel (Pallas, interpret mode, as tests/test_score_fused.py runs it), the JAX
gather scorer, and the port's ``score_batch_fused`` / ``detect_batch_fused``
with CPU tensors — which is the kernel's plain PyTorch version.

Tolerance: scores ``atol=1e-4, rtol=1e-5`` (the reduction-order class of
docs/ARCHITECTURE.md: the sums run in another order); labels identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_languagedetector_tpu.ops import score as jax_score
from spark_languagedetector_tpu.ops import score_fused as jax_fused
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu_torch.ops import score as torch_score
from spark_languagedetector_tpu_torch.ops import score_fused as SF
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, HASHED, VocabSpec, window_ids_numpy

L = 6
PAD = 256
ATOL, RTOL = 1e-4, 1e-5
# One streamed table tile on the TPU layout: the result does not depend on
# the tiling, and fewer grid steps keep interpret mode quick.
JAX_TILE_BYTES = 64 << 20


def _docs(rng):
    docs = [
        bytes(rng.integers(97, 112, int(rng.integers(0, 60))).tolist())
        for _ in range(3)
    ]
    # Edges: empty, 1 byte, shorter than every n > 2, 0x00/0xFF bytes, and
    # 200 random bytes. Eight documents: one grid step of the TPU kernel.
    docs += [b"", b"a", b"ab", b"\x00\xff\x00", bytes(rng.integers(0, 256, 200).tolist())]
    return docs


def _dense(spec, rng, n_learned):
    w = np.zeros((spec.id_space_size, L), np.float32)
    learned = rng.choice(spec.id_space_size, n_learned, replace=False)
    w[learned] = rng.normal(size=(n_learned, L)).astype(np.float32)
    return w, None


def _lut(spec, rng, n_rows):
    lut = np.full(spec.id_space_size, n_rows, np.int32)
    lut[rng.choice(spec.id_space_size, n_rows, replace=False)] = np.arange(n_rows)
    w = np.zeros((n_rows + 1, L), np.float32)
    w[:-1] = rng.normal(size=(n_rows, L)).astype(np.float32)
    return w, lut


# name -> (vocab spec args, membership constructor); the five layouts of the
# kernel: dense ids of every kind and both LUT routes.
LAYOUTS = {
    "dense_exact_bigram": ((EXACT, (2,)), lambda s, r: _dense(s, r, 500)),
    "dense_hashed_fnv1a": ((HASHED, (1, 2, 3), 12), lambda s, r: _dense(s, r, 600)),
    "dense_hashed_exact12_fold": (
        (HASHED, (1, 2, 3, 4, 5), 17), lambda s, r: _dense(s, r, 900)
    ),
    "lut_exact12_n1_5": ((HASHED, (1, 2, 3, 4, 5), 17), lambda s, r: _lut(s, r, 300)),
    "lut_exact_n1_3": ((EXACT, (1, 2, 3)), lambda s, r: _lut(s, r, 300)),
}


def _case(name, seed):
    args, build = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    spec = VocabSpec(*args)
    jspec = JaxVocabSpec(*args)
    w, lut = build(spec, rng)
    docs = _docs(rng)
    batch, lengths = pad_batch(docs, PAD)
    # Half the documents own only their first few window starts (chunk
    # ownership), the rest every start.
    lim = np.where(
        np.arange(len(docs)) % 2 == 0, rng.integers(1, 40, len(docs)), PAD
    ).astype(np.int32)
    return spec, jspec, w, lut, docs, batch, lengths, lim


def _port(ft, batch, lengths, lim, spec, detect):
    fn = SF.detect_batch_fused if detect else SF.score_batch_fused
    return fn(
        torch.from_numpy(batch), torch.from_numpy(lengths),
        torch.from_numpy(ft.wq), torch.from_numpy(ft.scales),
        None if ft.lut is None else torch.from_numpy(ft.lut),
        torch.from_numpy(lim), spec=spec, layout=ft.layout,
    )


def _jax(w, lut, jspec, quant, batch, lengths, lim, detect):
    jft = jax_fused.build_fused_tables(w, lut, jspec, quant, tile_bytes=JAX_TILE_BYTES)
    fn = jax_fused.detect_batch_fused if detect else jax_fused.score_batch_fused
    return fn(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(jft.wq),
        jnp.asarray(jft.scales), None if jft.lut is None else jnp.asarray(jft.lut),
        jnp.asarray(lim), spec=jspec, layout=jft.layout, block=256, interpret=True,
    )


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_fused_f32_matches_jax_fused_and_gather(name):
    spec, jspec, w, lut, docs, batch, lengths, lim = _case(name, 7)
    ft = SF.build_fused_tables(w, lut, spec)
    assert (ft.layout.inline == ()) == (name == "lut_exact_n1_3")
    got = _port(ft, batch, lengths, lim, spec, detect=False).numpy()
    ref_fused = np.asarray(_jax(w, lut, jspec, None, batch, lengths, lim, False))
    ref_gather = np.asarray(
        jax_score.score_batch(
            jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(w),
            None if lut is None else jnp.asarray(lut), spec=jspec,
            window_limit=jnp.asarray(lim),
        )
    )
    np.testing.assert_allclose(got, ref_fused, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref_gather, atol=ATOL, rtol=RTOL)
    labels, best = _port(ft, batch, lengths, lim, spec, detect=True)
    jlabels, jbest = _jax(w, lut, jspec, None, batch, lengths, lim, True)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_allclose(best.numpy(), np.asarray(jbest), atol=ATOL, rtol=RTOL)
    # The port's gather scorer is the same function.
    gather = torch_score.score_batch(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(w),
        None if lut is None else torch.from_numpy(lut), spec=spec,
        window_limit=torch.from_numpy(lim),
    ).numpy()
    np.testing.assert_allclose(gather, ref_gather, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quant", ["int16", "int8"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_fused_quantized_matches_jax_fused(name, quant):
    spec, jspec, w, lut, docs, batch, lengths, lim = _case(name, 8)
    ft = SF.build_fused_tables(w, lut, spec, quant)
    assert ft.wq.dtype == np.dtype(quant)
    assert ft.table_bytes * {"int8": 4, "int16": 2}[quant] == ft.f32_bytes
    got = _port(ft, batch, lengths, lim, spec, detect=False).numpy()
    ref = np.asarray(_jax(w, lut, jspec, quant, batch, lengths, lim, False))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    labels, best = _port(ft, batch, lengths, lim, spec, detect=True)
    np.testing.assert_array_equal(labels.numpy(), np.argmax(ref, axis=1))
    np.testing.assert_allclose(best.numpy(), ref.max(axis=1), atol=ATOL, rtol=RTOL)


def test_fused_layout_matches_jax_row_layout():
    """The port keeps the TPU layout's row assignment (dense12 region, then
    the compact long rows; the re-based LUT) — only the padding is gone."""
    spec, jspec, w, lut, *_ = _case("lut_exact12_n1_5", 9)
    ft = SF.build_fused_tables(w, lut, spec, "int8")
    jft = jax_fused.build_fused_tables(w, lut, jspec, "int8")
    R = ft.layout.rows
    assert R == jft.layout.rows
    assert [e[:2] for e in ft.layout.inline] == [(1, SF.POLY), (2, SF.POLY)]
    assert ft.layout.rows_lengths == jft.layout.rows_lengths == (3, 4, 5)
    np.testing.assert_array_equal(ft.wq, jft.wq[:R, :L])
    np.testing.assert_array_equal(ft.scales, jft.scales[0, :L])
    np.testing.assert_array_equal(ft.lut, jft.lut)


def test_fused_all_miss_and_empty_docs_label_zero():
    spec = VocabSpec(EXACT, (2,))
    w = np.zeros((spec.id_space_size, L), np.float32)  # nothing learned
    docs = [b"", b"anything", bytes(range(200, 240))]
    batch, lengths = pad_batch(docs, 128)
    lim = np.full(len(docs), 128, np.int32)
    for quant in (None, "int8"):
        ft = SF.build_fused_tables(w, None, spec, quant)
        labels, best = _port(ft, batch, lengths, lim, spec, detect=True)
        np.testing.assert_array_equal(labels.numpy(), 0)
        np.testing.assert_array_equal(best.numpy(), 0.0)


def test_fused_first_max_tie_goes_to_lowest_language():
    spec = VocabSpec(EXACT, (1,))
    w = np.zeros((spec.id_space_size, L), np.float32)
    w[ord("x"), 2] = w[ord("x"), 4] = 1.5  # tie between languages 2 and 4
    batch, lengths = pad_batch([b"xx"], 128)
    ft = SF.build_fused_tables(w, None, spec)
    labels, best = _port(ft, batch, lengths, np.full(1, 128, np.int32), spec, True)
    assert int(labels[0]) == 2 and float(best[0]) == 3.0


def _kernel_inline_ids(batch, n, kind, p1, p2):
    """The kernel's ``inline_row`` in numpy uint32: the ids it computes from
    one plan entry (``csrc/fused_detect.cu``)."""
    W = batch.shape[1] - n + 1
    planes = [batch[:, i : i + W].astype(np.uint32) for i in range(n)]
    if kind == SF.POLY:
        ids = np.zeros_like(planes[0])
        for p in planes:
            ids = ids * np.uint32(256) + p
        return ids.astype(np.int64) + p1
    h = np.full_like(planes[0], 2166136261)
    for p in planes:
        h = (h ^ p) * np.uint32(16777619)
    if kind == SF.FNV_MASK:
        return (h & np.uint32(p1)).astype(np.int64)
    return p1 + (h % np.uint32(p2)).astype(np.int64)


def test_inline_plan_reproduces_window_ids():
    """Every layout's inline plan (kind, p1, p2), read as the kernel reads
    it, gives the vocab's window ids bit for bit; the plain version takes
    its ids from the vocab, so a wrong plan entry cannot hide on the CPU."""
    rng = np.random.default_rng(3)
    batch = rng.integers(0, 256, (4, 64)).astype(np.uint8)
    batch[0, :8] = [0x00, 0xFF, 0xFF, 0x00, 0xFF, 0xFF, 0xFF, 0xFF]
    kinds = set()
    for name, (args, build) in LAYOUTS.items():
        spec = VocabSpec(*args)
        w, lut = build(spec, np.random.default_rng(0))
        ft = SF.build_fused_tables(w, lut, spec)
        for n, kind, p1, p2 in ft.layout.inline:
            kinds.add(kind)
            got = _kernel_inline_ids(batch, n, kind, p1, p2)
            np.testing.assert_array_equal(
                got, window_ids_numpy(batch, n, spec), err_msg=f"{name} n={n}"
            )
    assert kinds == {SF.POLY, SF.FNV_MASK, SF.FNV_FOLD}


def test_fused_wrapper_takes_plain_version_only_on_cpu():
    spec = VocabSpec(EXACT, (2,))
    w = np.ones((spec.id_space_size, L), np.float32)
    ft = SF.build_fused_tables(w, None, spec)
    batch, lengths = pad_batch([b"abc"], 128)
    inp = SF.prepare_fused_inputs(
        torch.from_numpy(batch), torch.from_numpy(lengths), None, None, spec, ft.layout
    )
    launches = SF.FUSED_DETECT.launches
    scores = SF.fused_detect(
        inp, torch.from_numpy(ft.wq), torch.from_numpy(ft.scales), ft.layout,
        want_labels=False,
    )
    assert SF.FUSED_DETECT.launches == launches  # no kernel launch on the CPU
    np.testing.assert_array_equal(scores.numpy(), 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        SF.fused_kernel(
            inp, torch.from_numpy(ft.wq), torch.from_numpy(ft.scales), ft.layout,
            want_labels=False,
        )
