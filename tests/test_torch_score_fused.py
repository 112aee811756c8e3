"""The port's fused kernel (plain version on the CPU) against the JAX package.

Same profiles and documents, made from a numpy seed, go through the JAX fused
kernel (Pallas, interpret mode, as tests/test_score_fused.py runs it), the JAX
gather scorer, and the port's ``score_batch_fused`` / ``detect_batch_fused``
with CPU tensors — which is the kernel's plain PyTorch version.

Tolerance: scores ``atol=1e-4, rtol=1e-5`` (the reduction-order class of
docs/ARCHITECTURE.md: the sums run in another order); labels identical.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_languagedetector_tpu.ops import score as jax_score
from spark_languagedetector_tpu.ops import score_fused as jax_fused
from spark_languagedetector_tpu.ops.vocab import VocabSpec as JaxVocabSpec
from spark_languagedetector_tpu_torch.models.profile import QUANT_DTYPES
from spark_languagedetector_tpu_torch.ops import _kernels
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


def _repeat_docs(pad):
    """Eight documents that each repeat one gram up to ``pad`` bytes, the
    largest count a row can reach (the last a short one)."""
    return [
        b"a" * pad, b"ab" * (pad // 2), b"\xff" * pad, b"xyz" * (pad // 3),
        b"e" * (pad // 3), b"\x00" * pad, "é".encode() * (pad // 2), b"q" * 7,
    ]


def _distinct_docs(rng, pad):
    """Eight random-byte documents about as wide as the batch: nearly every
    window of the longer lengths is a row of its own, more distinct rows
    than a CUDA kernel block's row-count table holds at the card's widths
    (``SF.FUSED_MAX_ROWS``)."""
    return [bytes(rng.integers(0, 256, pad - i).tolist()) for i in range(8)]


# The fused kernels' edges: counts per row as large as the width allows, and
# more distinct rows per document than one flush of the row counts.
EDGE_BATCHES = {
    "repeat": lambda rng, pad: _repeat_docs(pad),
    "distinct": _distinct_docs,
}


def learn_windows(spec, w, lut, batch, rng):
    """Make every window of ``batch`` (every gram length) hit a learned
    row, so that the edge documents score: a dense table gets random
    weights in its unlearned rows among the ids, a LUT sends its missing
    ids to random learned rows."""
    ids = np.unique(np.concatenate([
        window_ids_numpy(batch, n, spec).ravel() for n in spec.gram_lengths
    ]))
    w = w.copy()
    if lut is None:
        cold = ids[~w[ids].any(axis=1)]
        w[cold] = rng.normal(size=(len(cold), w.shape[1])).astype(np.float32)
        return w, None
    lut = lut.copy()
    miss = w.shape[0] - 1
    cold = ids[lut[ids] == miss]
    lut[cold] = rng.integers(0, miss, len(cold))
    return w, lut


def _edge_case(kind, name, seed, pad=PAD):
    """A layout's table and one edge batch (window limits on half the
    documents), every window of it learned."""
    args, build = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    spec, jspec = VocabSpec(*args), JaxVocabSpec(*args)
    w, lut = build(spec, rng)
    batch, lengths = pad_batch(EDGE_BATCHES[kind](rng, pad), pad)
    w, lut = learn_windows(spec, w, lut, batch, rng)
    lim = np.where(
        np.arange(len(lengths)) % 2 == 0, rng.integers(1, pad, len(lengths)), pad
    ).astype(np.int32)
    return spec, jspec, w, lut, batch, lengths, lim


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


@pytest.mark.parametrize("quant", [None, "int16", "int8"])
@pytest.mark.parametrize(
    "kind, name",
    [
        ("repeat", "lut_exact12_n1_5"),
        ("repeat", "dense_exact_bigram"),
        ("distinct", "lut_exact12_n1_5"),
        ("distinct", "dense_hashed_exact12_fold"),
    ],
)
def test_fused_edge_documents_match_jax_fused(kind, name, quant):
    """One gram repeated to the width, and random bytes with a row of their
    own per window: the port's plain version against the JAX fused kernel,
    f32 within the reduction-order class, integer tables bit for bit,
    labels identical."""
    spec, jspec, w, lut, batch, lengths, lim = _edge_case(kind, name, 10)
    ft = SF.build_fused_tables(w, lut, spec, quant)
    got = _port(ft, batch, lengths, lim, spec, detect=False).numpy()
    ref = np.asarray(_jax(w, lut, jspec, quant, batch, lengths, lim, False))
    assert np.count_nonzero(ref.any(axis=1)) >= 7  # the documents score
    if quant is None:
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_array_equal(got, ref)
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


def test_row_count_table_constant_matches_the_kernel_header():
    """The wrapper's mirror of the kernels' shared-memory row-count table
    (``csrc/fused_common.cuh``): 2^kSlotBits slots, flushed at half full."""
    src = (_kernels.CSRC_DIR / "fused_common.cuh").read_text()
    bits = int(re.search(r"kSlotBits = (\d+);", src).group(1))
    assert "kMaxFill = kSlots / 2;" in src
    assert SF.FUSED_MAX_ROWS == (1 << bits) // 2


def guard_table(quant):
    """A table at the int32 guard's edge: hashed n = 1..5 whose rows of
    'a' x n are +-1 (even / odd languages), so they quantize to +-qmax, and
    the longest document of 'a' that the wrapper's windows x qmax < 2^31
    guard admits. Returns (spec, weights, that length)."""
    spec = VocabSpec(HASHED, (1, 2, 3, 4, 5), 17)
    rng = np.random.default_rng(12)
    w = (0.1 * rng.normal(size=(spec.id_space_size, L))).astype(np.float32)
    probe = np.frombuffer(b"aaaaa", np.uint8)[None, :]
    hot = [int(window_ids_numpy(probe, n, spec)[0, 0]) for n in spec.gram_lengths]
    w[hot] = np.where(np.arange(L) % 2 == 0, 1.0, -1.0)
    n_max = (2**31 - 1) // (len(spec.gram_lengths) * QUANT_DTYPES[quant][1])
    return spec, w, n_max


# The f32 class for long window sums: a fixed atol cannot hold an f32 sum of
# tens of thousands of signed terms (the JAX fused kernel itself lands up to
# 0.61 x 2^-24 x Σ|terms| from the float64 sum on the 8,192-wide random-byte
# batch), so the bound gains a term that scales with Σ|terms|.
SUM_ULP = 2.0**-23


def sum_bound_excess(got, ref, abs_sum, atol=ATOL, rtol=RTOL):
    """Largest ``|got − ref| − (atol + rtol·|ref| + 2^-23·Σ|terms|)`` over
    the scores, float64: at most 0 when ``got`` is within the bound."""
    got, ref, abs_sum = (torch.as_tensor(a).double() for a in (got, ref, abs_sum))
    return float(((got - ref).abs() - (atol + rtol * ref.abs() + SUM_ULP * abs_sum)).max())


def _f64_scores(inp, wq, scales, layout):
    """The fused scores summed in float64: the plain version's function
    without its float32 accumulator."""
    acc = torch.zeros((inp.batch.shape[0], wq.shape[1]), dtype=torch.float64, device=wq.device)
    for r, m in SF.window_rows(inp, layout):
        acc += (wq.double()[r] * m[..., None]).sum(dim=1)
    return acc * scales.double()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["edges", "repeat", "distinct", "guard"])
def test_fused_detect_kernel_matches_plain_on_the_card(kind):
    """Launches ``csrc/fused_detect.cu`` (built with nvcc on first use) and
    holds it against the plain version on the card: edge documents, one
    gram repeated to the width, random bytes 8,192 wide whose distinct rows
    flush the kernel's row counts several times, and int8/int16 at the
    int32 guard's edge. f32 within ``atol + rtol·|ref| + 2^-23·Σ|terms|``
    (the reduction-order class with a term that scales with the sum) and
    bit-identical across two launches, integer tables bit for bit, labels
    the first max of the scores. On the repeated grams, whose float32 sum
    over thousands of windows of one row drifts in the plain version, f32
    scores are held against the float64 sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU form")
    dev = torch.device("cuda", 0)
    if kind == "guard":
        cases = []
        for quant in ("int8", "int16"):
            spec, w, n_max = guard_table(quant)
            batch, lengths = pad_batch([b"a" * n_max], n_max)
            cases.append((spec, w, None, batch, lengths, None, (quant,)))
    else:
        cases = []
        for name in LAYOUTS:
            if kind == "edges":
                spec, _, w, lut, _, batch, lengths, lim = _case(name, 11)
            else:
                pad = 2048 if kind == "repeat" else 8192
                spec, _, w, lut, batch, lengths, lim = _edge_case(kind, name, 11, pad)
            cases.append((spec, w, lut, batch, lengths, lim, (None, "int16", "int8")))
    for spec, w, lut, batch, lengths, lim, quants in cases:
        for quant in quants:
            ft = SF.build_fused_tables(w, lut, spec, quant)
            wq, scales = torch.from_numpy(ft.wq).to(dev), torch.from_numpy(ft.scales).to(dev)
            for limit in (None,) if lim is None else (None, lim):
                inp = SF.prepare_fused_inputs(
                    torch.from_numpy(batch).to(dev), torch.from_numpy(lengths).to(dev),
                    None if ft.lut is None else torch.from_numpy(ft.lut).to(dev),
                    None if limit is None else torch.from_numpy(limit).to(dev),
                    spec, ft.layout,
                )
                launches = _kernels.FUSED_DETECT.launches
                got = SF.fused_detect(inp, wq, scales, ft.layout, want_labels=False)
                again = SF.fused_detect(inp, wq, scales, ft.layout, want_labels=False)
                labels, best = SF.fused_detect(inp, wq, scales, ft.layout, want_labels=True)
                torch.cuda.synchronize()
                assert _kernels.FUSED_DETECT.launches == launches + 3
                ref = SF.fused_plain(inp, wq, scales, ft.layout, want_labels=False)
                if quant is None:
                    if kind == "repeat":
                        ref = _f64_scores(inp, wq, scales, ft.layout)
                    abs_sum = SF.fused_abs_sum(inp, wq, scales, ft.layout)
                    excess = sum_bound_excess(got, ref, abs_sum)
                    assert excess <= 0, (spec, limit is not None, excess)
                    assert torch.equal(got, again)
                else:
                    assert torch.equal(got, ref)
                assert torch.equal(labels, torch.argmax(got, dim=1).to(torch.int32))
                assert torch.equal(best, got.amax(dim=1))


def _distinct_8192(name):
    """The card test's ``[distinct]`` batch (random bytes 8,192 wide, every
    window learned), all windows owned: (spec, jspec, w, lut, batch,
    lengths, lim, tables, inputs)."""
    spec, jspec, w, lut, batch, lengths, _ = _edge_case("distinct", name, 11, 8192)
    lim = np.full(len(lengths), 8192, np.int32)
    ft = SF.build_fused_tables(w, lut, spec)
    inp = SF.prepare_fused_inputs(
        torch.from_numpy(batch), torch.from_numpy(lengths),
        None if ft.lut is None else torch.from_numpy(ft.lut), torch.from_numpy(lim),
        spec, ft.layout,
    )
    return spec, jspec, w, lut, batch, lengths, lim, ft, inp


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sum_bound_catches_one_dropped_or_doubled_window(name):
    """On the 8,192-wide random-byte batch the Σ|terms| bound still fails
    a result that misses one window, or counts it twice: per document, the
    window whose weight is largest."""
    *_, ft, inp = _distinct_8192(name)
    wq, scales = torch.from_numpy(ft.wq), torch.from_numpy(ft.scales)
    ref = _f64_scores(inp, wq, scales, ft.layout)
    abs_sum = SF.fused_abs_sum(inp, wq, scales, ft.layout)
    plain = SF.fused_plain(inp, wq, scales, ft.layout, want_labels=False)
    assert sum_bound_excess(plain, ref, abs_sum) <= 0
    assert float(abs_sum.max()) > 5e3  # long sums: the case the bound is for
    for d in range(inp.batch.shape[0]):
        best = None
        for r, m in SF.window_rows(inp, ft.layout):
            rows = r[d][m[d]]
            if rows.numel():
                big = wq[rows].abs().amax(dim=1)
                k = int(torch.argmax(big))
                if best is None or float(big[k]) > float(best[0]):
                    best = (big[k], int(rows[k]))
        term = wq[best[1]].double() * scales.double()
        for sign in (-1.0, 1.0):  # dropped, doubled
            got = plain.double().clone()
            got[d] += sign * term
            assert sum_bound_excess(got, ref, abs_sum) > 0, (d, sign)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_jax_reference_f32_error_lies_within_the_sum_bound(name):
    """The JAX package's f32 gather scorer on the 8,192-wide random-byte
    batch against the float64 sum lies within the Σ|terms| bound. (The JAX
    fused kernel in interpret mode, at 16-84 s a layout, lands up to
    1.28e-3 and 0.69 x 2^-24 x Σ|terms| from the float64 sum there: past
    the fixed ``atol=1e-4, rtol=1e-5``, inside this bound.)"""
    spec, jspec, w, lut, batch, lengths, lim, ft, inp = _distinct_8192(name)
    wq, scales = torch.from_numpy(ft.wq), torch.from_numpy(ft.scales)
    ref = _f64_scores(inp, wq, scales, ft.layout)
    abs_sum = SF.fused_abs_sum(inp, wq, scales, ft.layout)
    jref = np.array(
        jax_score.score_batch(
            jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(w),
            None if lut is None else jnp.asarray(lut), spec=jspec,
            window_limit=jnp.asarray(lim),
        )
    )
    assert sum_bound_excess(torch.from_numpy(jref), ref, abs_sum) <= 0
