"""Device-side encode: score straight from raw concatenated bytes.

Port of ``spark_languagedetector_tpu.ops.encode_device``. The padded and
ragged forms both re-materialize documents on the host — per-document
copies into a padded ``[B, S]`` plane, or chunk-aligned rows in a flat
buffer — before anything is copied to the card. The wire form carries the
raw document bytes concatenated once (a uint8 byte plane) plus one int32
offset and one int32 length per document, and the padded batch every
scoring strategy consumes is rebuilt on the device by one gather
(:func:`encode_batch`), bit-identical to ``ops.encoding.pad_batch``'s.

Host-side helpers keep the producer zero-copy: a :class:`DocBlock` views
numpy- or Arrow-backed corpora (data buffer + offsets) without
materializing per-document Python ``bytes``; :func:`utf8_safe_lengths`
applies the ``max_score_bytes`` cap to a whole block with vectorized numpy,
matching ``ops.encoding.truncate_utf8`` byte for byte; :func:`chunk_table`
is the vectorized chunk expansion; and :func:`gather_wire` /
:func:`wire_from_docs` assemble one batch's wire buffer with a single fancy
gather / a single join, straight into a caller's buffer (pinned host
memory) when given one.

Wire sizes are bucketed (:func:`wire_capacity`), mirroring the ragged
form's ``round_chunks``, so the staging buffers come in a few sizes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class DocBlock:
    """A corpus as one flat uint8 byte plane + per-doc offsets — the
    zero-copy input form for :meth:`..api.runner.BatchRunner.score`.

    ``flat`` is a 1-D uint8 view of the concatenated document bytes;
    ``offs`` is int64 ``[B + 1]`` with doc ``i`` occupying
    ``flat[offs[i]:offs[i+1]]``. Offsets are absolute positions into
    ``flat`` (an Arrow slice's offsets ride through unrebased), and
    ``owners`` pins whatever object backs the views so an Arrow buffer
    cannot be freed while a scoring call still reads it.
    """

    __slots__ = ("flat", "offs", "owners")

    def __init__(self, flat: np.ndarray, offs: np.ndarray, owners=()):
        flat = np.asarray(flat)
        if flat.dtype != np.uint8 or flat.ndim != 1:
            raise ValueError("DocBlock.flat must be a 1-D uint8 array")
        offs = np.asarray(offs)
        if offs.ndim != 1 or offs.size < 1:
            raise ValueError("DocBlock.offs must be 1-D with >= 1 entries")
        offs = offs.astype(np.int64, copy=False)
        if offs.size > 1:
            if int(offs[0]) < 0 or int(offs[-1]) > flat.size:
                raise ValueError("DocBlock.offs out of range for flat")
            if np.any(np.diff(offs) < 0):
                raise ValueError("DocBlock.offs must be non-decreasing")
        self.flat = flat
        self.offs = offs
        self.owners = tuple(owners)

    # ------------------------------------------------------ constructors ----
    @classmethod
    def from_bytes(cls, docs: Sequence[bytes]) -> "DocBlock":
        """One concat of the whole corpus — the list[bytes] on-ramp (per-doc
        Python objects already exist; the win is everything after)."""
        lens = np.fromiter(
            (len(d) for d in docs), dtype=np.int64, count=len(docs)
        )
        offs = np.zeros(len(docs) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        joined = b"".join(docs)
        flat = np.frombuffer(joined, dtype=np.uint8)
        return cls(flat, offs, owners=(joined,))

    @classmethod
    def from_arrow(cls, arr) -> "DocBlock":
        """View a pyarrow Binary/String (or Large*) array's buffers without
        copying the data plane; the array itself is retained as the owner.
        Raises ImportError when pyarrow is absent (the dep stays optional)."""
        import pyarrow as pa  # gated: zero-copy Arrow ingest is opt-in

        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        off_dtype = np.int64
        if pa.types.is_string(arr.type) or pa.types.is_binary(arr.type):
            off_dtype = np.int32
        elif not (
            pa.types.is_large_string(arr.type)
            or pa.types.is_large_binary(arr.type)
        ):
            raise TypeError(
                f"DocBlock.from_arrow needs a (large_)binary/string array, "
                f"got {arr.type}"
            )
        if arr.null_count:
            raise ValueError("DocBlock.from_arrow: nulls not supported")
        bufs = arr.buffers()  # [validity, offsets, data]
        offs_all = np.frombuffer(bufs[1], dtype=off_dtype)
        offs = offs_all[arr.offset : arr.offset + len(arr) + 1]
        data = bufs[2]
        flat = (
            np.frombuffer(data, dtype=np.uint8)
            if data is not None
            else np.zeros(0, dtype=np.uint8)
        )
        return cls(flat, offs.astype(np.int64, copy=False), owners=(arr,))

    # ------------------------------------------------------------ views ----
    def __len__(self) -> int:
        return self.offs.size - 1

    def starts(self) -> np.ndarray:
        return self.offs[:-1]

    def lengths(self) -> np.ndarray:
        return self.offs[1:] - self.offs[:-1]

    @property
    def total_bytes(self) -> int:
        return int(self.offs[-1] - self.offs[0])

    def doc(self, i: int) -> bytes:
        """Materialize one document (fallback/degraded paths only)."""
        return self.flat[int(self.offs[i]) : int(self.offs[i + 1])].tobytes()


def utf8_safe_lengths(
    flat: np.ndarray,
    starts: np.ndarray,
    lengths: np.ndarray,
    cap: int,
) -> np.ndarray:
    """Vectorized ``max_score_bytes`` cap over a byte plane: per-doc
    truncated lengths matching ``ops.encoding.truncate_utf8`` exactly —
    a cut landing on a UTF-8 continuation byte backs up to the character
    boundary, and a backtrack that would consume the whole prefix falls
    back to the hard cap (non-UTF-8 input). ``cap <= 0`` is a no-op.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    if cap <= 0:
        return lengths
    out = np.minimum(lengths, cap)
    over = np.flatnonzero(lengths > cap)
    if over.size == 0:
        return out
    starts = np.asarray(starts, dtype=np.int64)
    # Gather bytes [0..cap] of each over-cap doc in bounded slabs: the
    # backtrack loop can in principle walk to position 0 on malformed
    # input, so the whole prefix participates.
    span_cols = cap + 1
    rows_per_slab = max(1, (4 << 20) // span_cols)
    col = np.arange(span_cols, dtype=np.int64)
    for lo in range(0, over.size, rows_per_slab):
        sel = over[lo : lo + rows_per_slab]
        b = flat[starts[sel, None] + col]
        noncont = (b & 0xC0) != 0x80
        # Position 0 is a stop regardless of its byte class (the loop's
        # ``k > 0`` guard); scanning down from ``cap``, the first
        # non-continuation position is where the cut lands.
        noncont[:, 0] = True
        k = span_cols - 1 - np.argmax(noncont[:, ::-1], axis=1)
        out[sel] = np.where(k > 0, k, cap)
    return out


def chunk_table(
    starts: np.ndarray,
    lengths: np.ndarray,
    chunk_size: int,
    overlap: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ``ops.encoding.chunk_document`` over a byte plane:
    ``(doc_of, chunk_starts, chunk_lengths, window_limits)`` arrays, one
    row per chunk, in (doc, chunk-rank) order — the same expansion the
    runner's per-doc loop produces, without materializing chunk bytes.
    Non-final chunks own window starts ``[0, chunk_size - overlap)``;
    the final chunk owns all of its starts (limit = ``chunk_size``).
    """
    if chunk_size <= overlap:
        raise ValueError(
            f"chunk_size {chunk_size} must exceed overlap {overlap}"
        )
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    stride = chunk_size - overlap
    m = np.where(
        lengths <= chunk_size, 1, -(-(lengths - overlap) // stride)
    ).astype(np.int64)
    total = int(m.sum())
    n = lengths.size
    doc_of = np.repeat(np.arange(n, dtype=np.int64), m)
    first = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(m[:-1], out=first[1:])
    rank = np.arange(total, dtype=np.int64) - np.repeat(first, m)
    chunk_starts = starts[doc_of] + rank * stride
    chunk_lengths = np.minimum(chunk_size, lengths[doc_of] - rank * stride)
    is_final = rank == m[doc_of] - 1
    limits = np.where(is_final, chunk_size, stride).astype(np.int64)
    return doc_of, chunk_starts, chunk_lengths, limits


# Wire-size buckets: raw totals are rounded up to 1/16 of the batch's
# padded byte size (floor 256) — at most ~17 wire sizes per (B, S)
# geometry, and the wire never exceeds the padded form it replaces.
_WIRE_BUCKET_BASE = 256


def wire_capacity(total: int, rows: int, pad_to: int) -> int:
    """Bucketed wire-buffer size for ``total`` real bytes in a
    ``rows × pad_to`` batch geometry."""
    padded = max(rows * pad_to, 1)
    step = max(_WIRE_BUCKET_BASE, padded // 16)
    return min(-(-max(total, 1) // step) * step, padded)


def _wire_buffer(cap: int, out: np.ndarray | None) -> np.ndarray:
    if out is None:
        return np.zeros(cap, dtype=np.uint8)
    if out.shape != (cap,) or out.dtype != np.uint8:
        raise ValueError(f"out must be uint8 [{cap}]")
    out.fill(0)
    return out


def gather_wire(
    flat: np.ndarray,
    starts: np.ndarray,
    lengths: np.ndarray,
    capacity: int | None = None,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One batch's wire form off a byte plane: ``(wire uint8 [capacity],
    starts int32 [B], lengths int32 [B])`` via a single fancy gather —
    no per-document copies, overlapping source ranges (chunk overlap)
    welcome. Returned starts are exclusive length cumsums into ``wire``.
    ``out`` (uint8 [capacity]) receives the wire in place of a new array.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    n = lengths.size
    wstarts = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(lengths[:-1], out=wstarts[1:])
    total = int(lengths.sum())
    cap = total if capacity is None else int(capacity)
    if cap < total:
        raise ValueError(f"wire capacity {cap} < real bytes {total}")
    wire = _wire_buffer(cap, out)
    if total:
        delta = np.repeat(starts - wstarts, lengths)
        wire[:total] = flat[delta + np.arange(total, dtype=np.int64)]
    return wire, wstarts.astype(np.int32), lengths.astype(np.int32)


def wire_from_docs(
    byte_docs: Sequence[bytes], capacity: int | None = None,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One batch's wire form from materialized docs: a single ``join``
    (one memcpy per doc inside CPython, no padded-plane scatter) plus the
    int32 index arrays — the list[bytes] tier of the device-encode path.
    ``out`` (uint8 [capacity]) receives the wire in place of a new array.
    """
    n = len(byte_docs)
    lengths = np.fromiter((len(d) for d in byte_docs), np.int64, count=n)
    wstarts = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(lengths[:-1], out=wstarts[1:])
    total = int(lengths.sum())
    cap = total if capacity is None else int(capacity)
    if cap < total:
        raise ValueError(f"wire capacity {cap} < real bytes {total}")
    wire = _wire_buffer(cap, out)
    if total:
        wire[:total] = np.frombuffer(b"".join(byte_docs), dtype=np.uint8)
    return wire, wstarts.astype(np.int32), lengths.astype(np.int32)


def encode_batch(wire, starts, lengths, pad_to: int):
    """Device-side inverse of the wire form: tensors → uint8 ``[B, pad_to]``,
    bit-identical to ``ops.encoding.pad_batch``'s batch. One gather plus a
    validity mask — position 0 of the wire is real data (unlike the ragged
    form's reserved zero row), so every lane out of range is zeroed after
    the gather, restoring the padded form's zero tail. Starts and lengths
    arrive as int32; the index is int64."""
    import torch

    B = lengths.shape[0]
    if wire.numel() == 0:
        return torch.zeros((B, pad_to), dtype=torch.uint8, device=wire.device)
    j = torch.arange(pad_to, device=wire.device, dtype=torch.int64)[None, :]
    valid = j < lengths.to(torch.int64)[:, None]
    idx = torch.where(valid, starts.to(torch.int64)[:, None] + j, 0)
    return torch.where(valid, wire[idx], 0).to(torch.uint8)


# ------------------------------------------------ host packers over a block -
def pad_block(block: DocBlock, pad_to: int) -> tuple[np.ndarray, np.ndarray]:
    """``ops.encoding.pad_batch`` over a :class:`DocBlock`: one vectorized
    scatter instead of a per-document copy loop, bit-identical output.
    The host-pack fallback (native unavailable) stays exact for block-fed
    calls without materializing Python bytes."""
    starts = block.starts()
    lengths = np.minimum(block.lengths(), pad_to)
    n = lengths.size
    batch = np.zeros((n, pad_to), dtype=np.uint8)
    total = int(lengths.sum())
    if total:
        wstarts = np.zeros(n, dtype=np.int64)
        np.cumsum(lengths[:-1], out=wstarts[1:])
        pos = np.arange(total, dtype=np.int64)
        src = np.repeat(starts - wstarts, lengths) + pos
        row = np.repeat(np.arange(n, dtype=np.int64), lengths)
        dst = row * pad_to + (pos - np.repeat(wstarts, lengths))
        batch.reshape(-1)[dst] = block.flat[src]
    return batch, lengths.astype(np.int32)


def ragged_block(
    block: DocBlock, pad_to: int, flat_step: int | None = None,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``ops.encoding.pack_ragged_numpy`` over a :class:`DocBlock`: the
    chunk-aligned flat layout filled by one vectorized scatter (into
    ``out``, uint8 [C, 128], when given)."""
    from .encoding import RAGGED_CHUNK, _flat_buffer, round_chunks

    starts = block.starts()
    lengths = np.minimum(block.lengths(), pad_to).astype(np.int64)
    n = lengths.size
    nchunks = -(-lengths // RAGGED_CHUNK)
    offs = np.empty(n, dtype=np.int32)
    if n:
        offs[0] = 1
        np.cumsum(nchunks[:-1], dtype=np.int32, out=offs[1:])
        offs[1:] += 1
    total_chunks = int(1 + nchunks.sum())
    flat = _flat_buffer(round_chunks(total_chunks, flat_step), out)
    total = int(lengths.sum())
    if total:
        wstarts = np.zeros(n, dtype=np.int64)
        np.cumsum(lengths[:-1], out=wstarts[1:])
        pos = np.arange(total, dtype=np.int64)
        src = np.repeat(starts - wstarts, lengths) + pos
        dst = (
            np.repeat(offs.astype(np.int64) * RAGGED_CHUNK - wstarts, lengths)
            + pos
        )
        flat.reshape(-1)[dst] = block.flat[src]
    return flat, offs, lengths.astype(np.int32)
