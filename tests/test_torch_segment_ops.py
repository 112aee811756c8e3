"""Segment mode's per-cell scorers in the port against the JAX package.

Same tables and documents, made from a numpy seed, go through

* the JAX fused segment kernel (Pallas, interpret mode, as
  tests/test_segment.py runs it on the CPU) and the port's
  ``segment_batch_fused`` with CPU tensors, which is the CUDA kernel's plain
  PyTorch version;
* the JAX gather cell scorers (``window_scores_batch``, ``..._cuckoo``), the
  port's, and the float64 host oracle ``window_scores_numpy`` of both.

Tolerance: ``atol=1e-3`` per cell (the JAX package's own fused-vs-gather
class: the sums run in another order); int8/int16 tables within the same
tolerance of the JAX kernel on the same quantized table. The batch is 300
bytes wide, no multiple of any cell, and half the documents carry a window
limit that is no multiple of a cell either.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_languagedetector_tpu.ops import score as jax_score
from spark_languagedetector_tpu.ops import score_fused as jax_fused
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu_torch.models.profile import GramProfile
from spark_languagedetector_tpu_torch.ops import _kernels
from spark_languagedetector_tpu_torch.ops import score as torch_score
from spark_languagedetector_tpu_torch.ops import score_fused as SF
from spark_languagedetector_tpu_torch.ops.encoding import pad_batch
from spark_languagedetector_tpu_torch.ops.vocab import EXACT, VocabSpec
from tests.test_torch_score_fused import JAX_TILE_BYTES, LAYOUTS, L, _edge_case

PAD = 300
CELLS = (128, 256, 512)
ATOL = 1e-3


def _docs(rng):
    """Eight documents (one grid step of the TPU kernel): empty, one byte,
    a multi-byte one shorter than n = 5, 0x00/0xFF bytes, text-like ones of
    up to 300 bytes and random bytes."""
    return [
        b"", b"a", "é".encode(), b"\x00\xff\x00\xff",
        bytes(rng.integers(97, 112, 40).tolist()),
        bytes(rng.integers(97, 112, 290).tolist()),
        bytes(rng.integers(0, 256, 300).tolist()),
        bytes(rng.integers(0, 256, 200).tolist()),
    ]


def _case(name, seed):
    args, build = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    spec, jspec = VocabSpec(*args), JaxVocabSpec(*args)
    w, lut = build(spec, rng)
    batch, lengths = pad_batch(_docs(rng), PAD)
    # Odd rows own only window starts below an unaligned limit.
    lim = np.where(np.arange(len(lengths)) % 2 == 1, [0, 1, 0, 3, 0, 150, 0, 131], PAD)
    return spec, jspec, w, lut, batch, lengths, lim.astype(np.int32)


def _port(ft, batch, lengths, lim, spec, cell):
    return SF.segment_batch_fused(
        torch.from_numpy(batch), torch.from_numpy(lengths),
        torch.from_numpy(ft.wq), torch.from_numpy(ft.scales),
        None if ft.lut is None else torch.from_numpy(ft.lut),
        None if lim is None else torch.from_numpy(lim),
        spec=spec, layout=ft.layout, cell=cell,
    ).numpy()


def _jax(w, lut, jspec, quant, batch, lengths, lim, cell):
    jft = jax_fused.build_fused_tables(w, lut, jspec, quant, tile_bytes=JAX_TILE_BYTES)
    return np.asarray(jax_fused.segment_batch_fused(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(jft.wq),
        jnp.asarray(jft.scales), None if jft.lut is None else jnp.asarray(jft.lut),
        None if lim is None else jnp.asarray(lim),
        spec=jspec, layout=jft.layout, cell=cell, interpret=True,
    ))


def _dead_cells(lengths, lim, cell, n_cells):
    starts = np.arange(n_cells)[None, :] * cell
    lim = np.full_like(lengths, PAD) if lim is None else lim
    return (starts >= lengths[:, None]) | (starts >= lim[:, None])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_segment_fused_f32_matches_jax_kernel_and_gather(name, cell):
    spec, jspec, w, lut, batch, lengths, lim = _case(name, 17)
    ft = SF.build_fused_tables(w, lut, spec)
    got = _port(ft, batch, lengths, lim, spec, cell)
    assert got.shape == (len(lengths), -(-PAD // cell), L) and got.dtype == np.float32
    ref = _jax(w, lut, jspec, None, batch, lengths, lim, cell)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    gather = torch_score.window_scores_batch(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(w),
        None if lut is None else torch.from_numpy(lut), spec=spec, cell=cell,
        window_limit=torch.from_numpy(lim),
    ).numpy()
    np.testing.assert_allclose(got, gather, atol=ATOL)
    # Cells at or past min(len, lim) are exactly zero; the rest sum to the
    # whole-document scores.
    assert not got[_dead_cells(lengths, lim, cell, got.shape[1])].any()
    whole = SF.score_batch_fused(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(ft.wq),
        torch.from_numpy(ft.scales), None if ft.lut is None else torch.from_numpy(ft.lut),
        torch.from_numpy(lim), spec=spec, layout=ft.layout,
    ).numpy()
    np.testing.assert_allclose(got.sum(axis=1), whole, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_segment_fused_without_window_limit_matches_jax_kernel(name):
    spec, jspec, w, lut, batch, lengths, _ = _case(name, 18)
    ft = SF.build_fused_tables(w, lut, spec)
    got = _port(ft, batch, lengths, None, spec, 256)
    np.testing.assert_allclose(
        got, _jax(w, lut, jspec, None, batch, lengths, None, 256), atol=ATOL
    )
    assert not got[_dead_cells(lengths, None, 256, got.shape[1])].any()
    assert not got[0].any()  # the empty document


@pytest.mark.parametrize("quant", ["int16", "int8"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_segment_fused_quantized_matches_jax_kernel(name, quant):
    spec, jspec, w, lut, batch, lengths, lim = _case(name, 19)
    ft = SF.build_fused_tables(w, lut, spec, quant)
    # One cell width per case, so that the ten cases cover all three.
    cell = CELLS[(list(LAYOUTS).index(name) + (quant == "int8")) % 3]
    got = _port(ft, batch, lengths, lim, spec, cell)
    np.testing.assert_allclose(
        got, _jax(w, lut, jspec, quant, batch, lengths, lim, cell), atol=ATOL
    )
    # Integer sums are exact: the cells add up to the whole-document scores
    # of the same quantized table to the last f32 rounding.
    whole = SF.score_batch_fused(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(ft.wq),
        torch.from_numpy(ft.scales), None if ft.lut is None else torch.from_numpy(ft.lut),
        torch.from_numpy(lim), spec=spec, layout=ft.layout,
    ).numpy()
    np.testing.assert_allclose(got.sum(axis=1), whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [None, "int16", "int8"])
@pytest.mark.parametrize("kind", ["repeat", "distinct"])
def test_segment_fused_edge_documents_match_jax_kernel(kind, quant):
    """One gram repeated to the width, and random bytes with a row of their
    own per window (both input routes of the exact12 LUT layout): the port's
    plain version against the JAX fused segment kernel, f32 within
    ``atol=1e-4, rtol=1e-5``, integer tables bit for bit, the argmax of
    every live cell identical."""
    spec, jspec, w, lut, batch, lengths, lim = _edge_case(kind, "lut_exact12_n1_5", 20, PAD)
    ft = SF.build_fused_tables(w, lut, spec, quant)
    cell = CELLS[(quant is not None) + (quant == "int8")]
    got = _port(ft, batch, lengths, lim, spec, cell)
    ref = _jax(w, lut, jspec, quant, batch, lengths, lim, cell)
    live = ~_dead_cells(lengths, lim, cell, got.shape[1])
    assert np.count_nonzero(ref[live].any(axis=1)) >= live.sum() - 1  # the cells score
    if quant is None:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.argmax(got[live], axis=1), np.argmax(ref[live], axis=1))
    assert not got[~live].any()


def test_segment_fused_cell_width_is_checked_with_the_jax_message():
    spec, _, w, lut, batch, lengths, lim = _case("dense_exact_bigram", 3)
    ft = SF.build_fused_tables(w, lut, spec)
    for cell in (0, 64, 200):
        with pytest.raises(ValueError, match="positive multiple of 128"):
            _port(ft, batch, lengths, lim, spec, cell)


def test_segment_wrapper_takes_plain_version_only_on_cpu():
    spec, _, w, lut, batch, lengths, lim = _case("lut_exact12_n1_5", 4)
    ft = SF.build_fused_tables(w, lut, spec, "int8")
    inp = SF.prepare_fused_inputs(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(ft.lut),
        torch.from_numpy(lim), spec, ft.layout,
    )
    wq, scales = torch.from_numpy(ft.wq), torch.from_numpy(ft.scales)
    launches = _kernels.FUSED_SEGMENT.launches
    got = SF.fused_segment(inp, wq, scales, ft.layout, 128)
    assert _kernels.FUSED_SEGMENT.launches == launches  # no launch on the CPU
    assert torch.equal(got, SF.fused_segment_plain(inp, wq, scales, ft.layout, 128))
    with pytest.raises(ValueError, match="CUDA"):
        SF.fused_segment_kernel(inp, wq, scales, ft.layout, 128)
    assert _kernels.FUSED_SEGMENT in _kernels.KERNELS
    assert _kernels.FUSED_SEGMENT.source.name == "fused_segment.cu"
    assert _kernels.FUSED_SEGMENT.source.is_file()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["edges", "repeat", "distinct"])
def test_fused_segment_kernel_matches_plain_on_the_card(kind):
    """Launches ``csrc/fused_segment.cu`` (built with nvcc on first use) and
    holds it against the plain version: on edge documents, on one gram
    repeated to the width, and on random bytes 4,100 wide whose cells (2048
    wide too) hold more distinct rows than the kernel's row-count table.
    f32 within the reduction-order tolerance and bit-identical across two
    launches, int8/int16 bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU form")
    dev = torch.device("cuda", 0)
    cells = CELLS
    if kind == "edges":
        spec, _, w, lut, batch, lengths, lim = _case("lut_exact12_n1_5", 5)
    elif kind == "repeat":
        spec, _, w, lut, batch, lengths, lim = _edge_case(kind, "lut_exact12_n1_5", 5, 1300)
    else:
        spec, _, w, lut, batch, lengths, lim = _edge_case(kind, "lut_exact12_n1_5", 5, 4100)
        cells = (128, 512, 2048)
    for quant in (None, "int16", "int8"):
        ft = SF.build_fused_tables(w, lut, spec, quant)
        inp = SF.prepare_fused_inputs(
            torch.from_numpy(batch).to(dev), torch.from_numpy(lengths).to(dev),
            torch.from_numpy(ft.lut).to(dev), torch.from_numpy(lim).to(dev),
            spec, ft.layout,
        )
        wq, scales = torch.from_numpy(ft.wq).to(dev), torch.from_numpy(ft.scales).to(dev)
        for cell in cells:
            launches = _kernels.FUSED_SEGMENT.launches
            got = SF.fused_segment(inp, wq, scales, ft.layout, cell)
            again = SF.fused_segment(inp, wq, scales, ft.layout, cell)
            torch.cuda.synchronize()
            assert _kernels.FUSED_SEGMENT.launches == launches + 2
            ref = SF.fused_segment_plain(inp, wq, scales, ft.layout, cell)
            if quant is None:
                torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)
                assert torch.equal(got, again)
            else:
                assert torch.equal(got, ref)


# ------------------------------------------------- gather cell scorers -----


def _oracle_batch(docs, w, sorted_ids, spec, cell, n_cells):
    """window_scores_numpy per document, zero-padded to the batch's cells."""
    out = np.zeros((len(docs), n_cells, w.shape[1]))
    for i, cells in enumerate(torch_score.window_scores_numpy(docs, w, sorted_ids, spec, cell)):
        out[i, : len(cells)] = cells
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", ["dense_hashed_fnv1a", "lut_exact12_n1_5", "lut_exact_n1_3"])
def test_window_scores_batch_matches_jax_and_host_oracle(name, cell):
    spec, jspec, w, lut, batch, lengths, lim = _case(name, 23)
    got = torch_score.window_scores_batch(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(w),
        None if lut is None else torch.from_numpy(lut), spec=spec, cell=cell,
        window_limit=torch.from_numpy(lim),
    ).numpy()
    ref = np.asarray(jax_score.window_scores_batch(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(w),
        None if lut is None else jnp.asarray(lut), spec=jspec, cell=cell,
        window_limit=jnp.asarray(lim),
    ))
    assert got.shape == ref.shape == (len(lengths), -(-PAD // cell), L)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # Without a limit, against the float64 host oracle of both packages.
    free = torch_score.window_scores_batch(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(w),
        None if lut is None else torch.from_numpy(lut), spec=spec, cell=cell, block=256,
    ).numpy()
    docs = [bytes(batch[i, : lengths[i]]) for i in range(len(lengths))]
    if lut is None:
        hw, sorted_ids = w, None
    else:
        sorted_ids = np.flatnonzero(lut != w.shape[0] - 1)
        hw = np.concatenate([w[lut[sorted_ids]], np.zeros((1, L), np.float32)])
    oracle = _oracle_batch(docs, hw, sorted_ids, spec, cell, free.shape[1])
    np.testing.assert_allclose(free, oracle, atol=ATOL)
    for mine, theirs in zip(
        torch_score.window_scores_numpy(docs, hw, sorted_ids, spec, cell),
        jax_score.window_scores_numpy(docs, hw, sorted_ids, jspec, cell),
    ):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("limited", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_window_scores_batch_cuckoo_matches_jax_and_host_oracle(cell, limited):
    rng = np.random.default_rng(29)
    spec, jspec = VocabSpec(EXACT, (1, 2, 3, 4, 5)), JaxVocabSpec(EXACT, (1, 2, 3, 4, 5))
    docs = _docs(rng)
    # Learn every fifth gram of the documents themselves, so windows hit.
    grams = sorted({d[s : s + n] for d in docs for n in spec.gram_lengths
                    for s in range(0, max(len(d) - n + 1, 0), 5)})
    profile = GramProfile.from_gram_map(
        {g: rng.normal(size=L).tolist() for g in grams},
        [f"l{i}" for i in range(L)], spec.gram_lengths,
    )
    w, lut, table = profile.device_membership(device="cpu")
    assert lut is None and table is not None
    w = np.asarray(w)
    hw, sorted_ids = profile.host_arrays()
    batch, lengths = pad_batch(docs, PAD)
    lim = np.where(np.arange(len(docs)) % 2 == 1, 131, PAD).astype(np.int32)
    got = torch_score.window_scores_batch_cuckoo(
        torch.from_numpy(batch), torch.from_numpy(lengths), torch.from_numpy(w),
        torch.from_numpy(table.entries()), seed1=table.seed1, seed2=table.seed2,
        spec=spec, cell=cell, window_limit=torch.from_numpy(lim) if limited else None,
    ).numpy()
    ref = np.asarray(jax_score.window_scores_batch_cuckoo(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(w),
        jnp.asarray(table.entries()), seed1=table.seed1, seed2=table.seed2,
        spec=jspec, cell=cell, window_limit=jnp.asarray(lim) if limited else None,
    ))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if not limited:
        assert got.any()
        oracle = _oracle_batch(docs, hw, sorted_ids, spec, cell, got.shape[1])
        np.testing.assert_allclose(got, oracle, atol=ATOL)


def test_window_scores_batch_cuckoo_needs_an_exact_vocab():
    with pytest.raises(ValueError, match="exact vocab spec"):
        torch_score.window_scores_batch_cuckoo(
            torch.zeros((1, 128), dtype=torch.uint8), torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, L)), torch.zeros((16, 4), dtype=torch.int32),
            seed1=1, seed2=2, spec=VocabSpec("hashed", (1, 2), 12), cell=128,
        )
