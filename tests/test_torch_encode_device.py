"""The port's ragged and wire forms against the JAX package's, bit for bit.

* ``DocBlock``, ``utf8_safe_lengths``, ``chunk_table``, ``gather_wire``,
  ``wire_from_docs``, ``pad_block``, ``ragged_block``, ``pack_ragged_numpy``
  and ``round_chunks`` give the JAX functions' arrays on the same inputs;
* ``encode_batch`` and ``unpack_ragged`` (torch, CPU) give the JAX jitted
  versions' batches and ``pad_batch``'s;
* edge cases: the empty document, documents of exactly ``RAGGED_CHUNK``
  bytes, the largest bucket, and a UTF-8 cap inside a multi-byte character;
* the ``out=`` buffers (pinned memory in the runner) receive the same bytes
  as fresh arrays, zeroing whatever was there.
"""

import numpy as np
import pytest
import torch

from spark_languagedetector_tpu.ops import encode_device as jed
from spark_languagedetector_tpu.ops import encoding as jenc
from spark_languagedetector_tpu_torch.ops import encode_device as ed
from spark_languagedetector_tpu_torch.ops import encoding as enc

CHUNK = enc.RAGGED_CHUNK


def _corpus(seed=0, n=40):
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(0, 256, int(rng.integers(0, 300))).tolist()) for _ in range(n)]
    docs += [
        b"", b"a", b"\x80" * 130, b"\xc3" + b"\xa9" * 299,
        b"x" * 126 + "€".encode() * 3, "é".encode() * 100,
        b"q" * CHUNK, b"r" * (2 * CHUNK), b"s" * (CHUNK - 1), b"t" * (CHUNK + 1),
    ]
    return docs


def _eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


def test_round_chunks_equals_jax():
    for c in (0, 1, 255, 256, 257, 1000, 4097):
        for step in (None, 0, 16, 256, 300, 1024):
            assert enc.round_chunks(c, step) == jenc.round_chunks(c, step)
    assert enc.RAGGED_CHUNK == jenc.RAGGED_CHUNK


def test_docblock_views_equal_jax():
    docs = _corpus()
    block, jblock = ed.DocBlock.from_bytes(docs), jed.DocBlock.from_bytes(docs)
    assert len(block) == len(jblock) == len(docs)
    assert block.total_bytes == jblock.total_bytes
    np.testing.assert_array_equal(block.offs, jblock.offs)
    np.testing.assert_array_equal(block.flat, jblock.flat)
    assert [block.doc(i) for i in range(len(block))] == docs
    with pytest.raises(ValueError):
        ed.DocBlock(np.zeros(3, np.int32), np.array([0, 3]))
    with pytest.raises(ValueError):
        ed.DocBlock(np.zeros(3, np.uint8), np.array([0, 5]))


def test_docblock_from_arrow_equals_jax():
    pa = pytest.importorskip("pyarrow")
    docs = [b"alpha", b"", b"\xc3\xa9" * 50, b"tail"]
    for typ in (pa.binary(), pa.large_binary(), pa.string()):
        arr = pa.array(docs if typ != pa.string() else [d.decode() for d in docs], type=typ)
        block, jblock = ed.DocBlock.from_arrow(arr), jed.DocBlock.from_arrow(arr)
        np.testing.assert_array_equal(block.offs, jblock.offs)
        assert [block.doc(i) for i in range(len(block))] == docs
    arr = pa.array([b"drop"] + docs, type=pa.binary()).slice(1)
    assert [ed.DocBlock.from_arrow(arr).doc(i) for i in range(len(docs))] == docs
    with pytest.raises(ValueError, match="null"):
        ed.DocBlock.from_arrow(pa.array([b"a", None]))


@pytest.mark.parametrize("cap", [0, 1, 2, 64, 127, 128, 129, 300])
def test_utf8_safe_lengths_equal_jax_and_truncate(cap):
    docs = _corpus(1)
    block = ed.DocBlock.from_bytes(docs)
    got = ed.utf8_safe_lengths(block.flat, block.starts(), block.lengths(), cap)
    ref = jed.utf8_safe_lengths(block.flat, block.starts(), block.lengths(), cap)
    np.testing.assert_array_equal(got, ref)
    if cap > 0:
        assert got.tolist() == [len(enc.truncate_utf8(d, cap)) for d in docs]


def test_utf8_cap_inside_a_multibyte_character():
    doc = "a€b".encode()  # € is 3 bytes at [1, 4)
    for cap, want in ((1, 1), (2, 1), (3, 1), (4, 4)):
        assert enc.truncate_utf8(doc, cap) == jenc.truncate_utf8(doc, cap)
        assert len(enc.truncate_utf8(doc, cap)) == want
        lens = ed.utf8_safe_lengths(np.frombuffer(doc, np.uint8), np.array([0]),
                                    np.array([len(doc)]), cap)
        assert lens.tolist() == [want]


@pytest.mark.parametrize("chunk_size,overlap", [(128, 4), (256, 2), (8192, 4), (130, 129)])
def test_chunk_table_equals_jax_and_chunk_document(chunk_size, overlap):
    docs = _corpus(2) + [b"z" * 1000, b"y" * 20000]
    block = ed.DocBlock.from_bytes(docs)
    got = ed.chunk_table(block.starts(), block.lengths(), chunk_size, overlap)
    ref = jed.chunk_table(block.starts(), block.lengths(), chunk_size, overlap)
    _eq(got, ref)
    doc_of, starts, lens, _ = got
    want = [c for d in docs for c in enc.chunk_document(d, chunk_size, overlap)]
    assert [block.flat[s : s + n].tobytes() for s, n in zip(starts, lens)] == want
    with pytest.raises(ValueError):
        ed.chunk_table(block.starts(), block.lengths(), 4, 4)


def test_wire_capacity_equals_jax():
    for total in (0, 1, 255, 256, 1000, 5000, 1 << 20):
        for rows, pad_to in ((1, 128), (16, 512), (64, 8192)):
            assert ed.wire_capacity(total, rows, pad_to) == jed.wire_capacity(total, rows, pad_to)


def test_wire_forms_equal_jax_and_fill_out_buffers():
    docs = _corpus(3)
    block = ed.DocBlock.from_bytes(docs)
    cap = ed.wire_capacity(block.total_bytes, len(docs), 512)
    _eq(ed.wire_from_docs(docs, cap), jed.wire_from_docs(docs, cap))
    _eq(ed.wire_from_docs(docs), jed.wire_from_docs(docs))
    sel = np.array([3, 0, 7, 7, len(docs) - 1])
    args = (block.flat, block.starts()[sel], block.lengths()[sel])
    _eq(ed.gather_wire(*args, 4096), jed.gather_wire(*args, 4096))
    out = np.full(cap, 0xAB, np.uint8)
    wire, starts, lens = ed.wire_from_docs(docs, cap, out=out)
    assert wire is out
    _eq((wire, starts, lens), jed.wire_from_docs(docs, cap))
    out = np.full(4096, 0xCD, np.uint8)
    assert ed.gather_wire(*args, 4096, out=out)[0] is out
    np.testing.assert_array_equal(out, jed.gather_wire(*args, 4096)[0])
    with pytest.raises(ValueError, match="capacity"):
        ed.wire_from_docs(docs, 10)
    with pytest.raises(ValueError, match="out"):
        ed.wire_from_docs(docs, cap, out=np.zeros(cap + 1, np.uint8))


@pytest.mark.parametrize("pad_to", [128, 256, 384, 8192])
@pytest.mark.parametrize("flat_step", [None, 64, 512])
def test_ragged_packers_equal_jax(pad_to, flat_step):
    docs = _corpus(4)
    ref = jenc.pack_ragged_numpy(docs, pad_to, flat_step)
    _eq(enc.pack_ragged_numpy(docs, pad_to, flat_step), ref)
    _eq(enc.ragged_layout(docs, pad_to, flat_step), jenc.ragged_layout(docs, pad_to, flat_step))
    block = ed.DocBlock.from_bytes(docs)
    _eq(ed.ragged_block(block, pad_to, flat_step), jed.ragged_block(block, pad_to, flat_step))
    _eq(enc.pack_ragged_numpy(block, pad_to, flat_step), ref)
    out = np.full_like(ref[0], 0x5A)
    got = enc.pack_ragged_numpy(docs, pad_to, flat_step, out=out)
    assert got[0] is out
    _eq(got, ref)
    out[:] = 0x5A
    _eq(ed.ragged_block(block, pad_to, flat_step, out=out), ref)
    with pytest.raises(ValueError, match="out"):
        enc.pack_ragged_numpy(docs, pad_to, flat_step, out=out[1:])


@pytest.mark.parametrize("pad_to", [128, 512, 8192])
def test_pad_block_equals_jax_and_pad_batch(pad_to):
    docs = _corpus(5)
    block = ed.DocBlock.from_bytes(docs)
    got = ed.pad_block(block, pad_to)
    _eq(got, jed.pad_block(jed.DocBlock.from_bytes(docs), pad_to))
    _eq(got, enc.pad_batch(docs, pad_to))


@pytest.mark.parametrize("pad_to", [128, 256, 1024, 8192])
def test_unpack_ragged_equals_jax_and_pad_batch(pad_to):
    docs = _corpus(6)
    flat, offs, lens = enc.pack_ragged_numpy(docs, pad_to, 64)
    got = enc.unpack_ragged(torch.from_numpy(flat), torch.from_numpy(offs),
                            torch.from_numpy(lens), pad_to)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (len(docs), pad_to)
    ref = np.asarray(jenc.unpack_ragged_jit(flat, offs, lens, pad_to))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), enc.pad_batch(docs, pad_to)[0])


@pytest.mark.parametrize("pad_to", [128, 256, 1024, 8192])
def test_encode_batch_equals_jax_and_pad_batch(pad_to):
    docs = _corpus(7)
    cap = ed.wire_capacity(sum(len(d) for d in docs), len(docs), pad_to)
    # The wire holds real data at position 0, and bytes past each document
    # belong to the next one: every lane beyond a length must read zero.
    wire, starts, lens = ed.wire_from_docs([enc.truncate_utf8(d, pad_to)[:pad_to] for d in docs],
                                           cap)
    got = ed.encode_batch(torch.from_numpy(wire), torch.from_numpy(starts),
                          torch.from_numpy(lens), pad_to)
    assert got.dtype == torch.uint8
    ref = np.asarray(jed.encode_batch_jit(wire, starts, lens, pad_to))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), enc.pad_batch([d[:pad_to] for d in
                                    (enc.truncate_utf8(x, pad_to) for x in docs)], pad_to)[0]
    )


def test_encode_batch_edge_cases():
    empty = ed.encode_batch(torch.zeros(0, dtype=torch.uint8), torch.zeros(2, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32), 128)
    assert tuple(empty.shape) == (2, 128) and not empty.any()
    docs = [b"", b"q" * CHUNK, b"\xff" * 8192]
    wire, starts, lens = ed.wire_from_docs(docs)
    got = ed.encode_batch(torch.from_numpy(wire), torch.from_numpy(starts),
                          torch.from_numpy(lens), 8192)
    np.testing.assert_array_equal(got.numpy(), enc.pad_batch(docs, 8192)[0])
    flat, offs, lens = enc.pack_ragged_numpy(docs, 8192)
    back = enc.unpack_ragged(*(torch.from_numpy(a) for a in (flat, offs, lens)), 8192)
    np.testing.assert_array_equal(back.numpy(), enc.pad_batch(docs, 8192)[0])
