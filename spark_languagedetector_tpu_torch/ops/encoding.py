"""Text → fixed-shape byte arrays (host side, vectorized numpy).

Port of ``spark_languagedetector_tpu.ops.encoding``. Each text is encoded to
bytes, and a micro-batch is packed into a zero-padded ``uint8 [B, S]`` array
plus an ``int32 [B]`` length vector (the padded form), or into the ragged
form: each document 128-byte-chunk-aligned in one flat ``uint8 [C, 128]``
buffer plus an int32 chunk offset per document, which
:func:`unpack_ragged` turns back into the padded batch on the device.
Padding is 0x00; validity is carried by the length vector, never by
sentinel bytes. (The raw wire form lives in :mod:`.encode_device`.)

Two string→bytes encodings exist because the reference has a train/predict
encoding mismatch: fit uses UTF-8 while predict truncates UTF-16 code units
to their low byte. ``utf8`` is the default for both paths; ``low_byte``
reproduces the reference's predict path bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

UTF8 = "utf8"
LOW_BYTE = "low_byte"
ENCODINGS = (UTF8, LOW_BYTE)

# ~1.5x growth bounds padding waste at 50% worst case; every bucket is a
# multiple of 128 bytes.
DEFAULT_LENGTH_BUCKETS: tuple[int, ...] = (
    128, 256, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192
)


def text_to_bytes(text: str, encoding: str = UTF8) -> bytes:
    if encoding == UTF8:
        return text.encode("utf-8")
    if encoding == LOW_BYTE:
        # Low byte of each UTF-16 code unit (the reference's predict path).
        return text.encode("utf-16-le")[::2]
    raise ValueError(f"unknown encoding {encoding!r}; expected one of {ENCODINGS}")


def texts_to_bytes(texts: Sequence[str], encoding: str = UTF8) -> list[bytes]:
    return [text_to_bytes(t, encoding) for t in texts]


def bucket_length(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ length; buckets sorted ascending. A length past the
    largest bucket gets a power-of-two multiple of it that covers it —
    padding never truncates silently."""
    for b in buckets:
        if length <= b:
            return b
    width = buckets[-1]
    while width < length:
        width *= 2
    return width


def pad_batch(
    byte_docs: Sequence[bytes],
    pad_to: int | None = None,
    length_buckets: Sequence[int] | None = None,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length byte strings into (uint8 [B, S], int32 lengths [B]).

    Documents longer than the padded width are truncated (callers that need
    unbounded documents chunk first). ``out``, a uint8 [B, pad_to] array
    (a view of pinned host memory, say), receives the batch in place of a
    new one.
    """
    lengths = np.fromiter(
        (len(d) for d in byte_docs), dtype=np.int32, count=len(byte_docs)
    )
    max_len = max(int(lengths.max()) if len(byte_docs) else 1, 1)
    if pad_to is None:
        pad_to = bucket_length(max_len, length_buckets or DEFAULT_LENGTH_BUCKETS)
    if out is None:
        batch = np.zeros((len(byte_docs), pad_to), dtype=np.uint8)
    else:
        batch = out
        batch.fill(0)
    for i, doc in enumerate(byte_docs):
        n = min(len(doc), pad_to)
        if n:
            batch[i, :n] = np.frombuffer(doc, dtype=np.uint8, count=n)
    np.minimum(lengths, pad_to, out=lengths)
    return batch, lengths


# --- ragged (wire-efficient) packing -----------------------------------
#
# The padded [B, S] form copies bucket-width rows to the device, padding
# included. The ragged form ships each document 128-byte-chunk-aligned in
# one flat [C, 128] uint8 buffer plus an int32 chunk offset per document;
# the device rebuilds the exact padded batch with one 128-byte-row gather
# (:func:`unpack_ragged`), so everything downstream of the copy is
# bit-identical to the padded path. Chunk row 0 is reserved all-zeros:
# chunk indices past a document's end gather it, which restores the padded
# form's zero tail. Alignment waste averages 64 bytes per document.
RAGGED_CHUNK = 128

# Flat sizes are rounded to a multiple of ``step`` (floor 256 chunks), the
# runner passing 1/16 of the batch's padded chunk count: batches of stable
# fill land on a few distinct flat sizes per (B, S) geometry.
_FLAT_BUCKET_BASE = 256


def round_chunks(c: int, step: int | None = None) -> int:
    """Smallest multiple of ``step`` >= max(c, 256) (``step`` defaults to
    256; the runner passes padded_chunks/16 for its batch geometry)."""
    step = max(int(step or 0), _FLAT_BUCKET_BASE)
    return -(-max(c, 1) // step) * step


def ragged_fit(byte_docs: Sequence[bytes], pad_to: int) -> tuple[int, int] | None:
    """``(rows_flat, flat_step)`` of the ragged form of one batch padded to
    ``pad_to``, or None when it would not be smaller than the padded batch
    (narrow buckets, full batches and small tails under the 256-chunk floor
    all lose). Flat sizes round to 1/16 of the batch's padded chunk count."""
    rows = len(byte_docs)
    if pad_to % RAGGED_CHUNK:
        return None
    step = (rows * pad_to // RAGGED_CHUNK) // 16
    lengths = np.minimum(np.fromiter(map(len, byte_docs), dtype=np.int64, count=rows), pad_to)
    total = 1 + int((-(-lengths // RAGGED_CHUNK)).sum())
    rows_flat = round_chunks(total, step)
    if rows_flat * RAGGED_CHUNK >= rows * pad_to:
        return None
    return rows_flat, step


def ragged_layout(
    byte_docs: Sequence[bytes], pad_to: int, flat_step: int | None = None,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Layout bookkeeping shared by the ragged packers: → (zeroed flat
    uint8 [C, 128], offs int32 [B], lengths int32 [B] clamped to pad_to).

    The single owner of the layout's invariants: reserved zero row 0,
    ``offs[i] = 1 + cumsum(chunks)``, truncation matching :func:`pad_batch`,
    :func:`round_chunks` bucketing. ``out``, a C-contiguous uint8 [C, 128]
    array of exactly that row count (a view of pinned memory, say), is
    zeroed and used as the flat buffer.
    """
    n = len(byte_docs)
    lengths = np.minimum(
        np.fromiter(map(len, byte_docs), dtype=np.int64, count=n), pad_to
    ).astype(np.int32)
    nchunks = -(-lengths // RAGGED_CHUNK)  # ceil; 0 for empty docs
    offs = np.empty(n, dtype=np.int32)
    if n:
        offs[0] = 1
        np.cumsum(nchunks[:-1], dtype=np.int32, out=offs[1:])
        offs[1:] += 1
    rows = round_chunks(int(1 + nchunks.sum()), flat_step)
    return _flat_buffer(rows, out), offs, lengths


def _flat_buffer(rows: int, out: np.ndarray | None) -> np.ndarray:
    if out is None:
        return np.zeros((rows, RAGGED_CHUNK), dtype=np.uint8)
    if out.shape != (rows, RAGGED_CHUNK) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous uint8 [{rows}, {RAGGED_CHUNK}]")
    out.fill(0)
    return out


def pack_ragged_numpy(
    byte_docs: Sequence[bytes], pad_to: int, flat_step: int | None = None,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Documents → (flat uint8 [C, 128], offs int32 [B], lengths int32 [B]).

    The numpy mirror of the native ``pack_ragged``. ``offs[i]`` is document
    i's first chunk row in ``flat`` (row 0 is the reserved zero chunk);
    documents longer than ``pad_to`` are truncated, as :func:`pad_batch`
    truncates. A :class:`~.encode_device.DocBlock` fills through one
    vectorized scatter instead of the per-document loop.
    """
    from .encode_device import DocBlock, ragged_block

    if isinstance(byte_docs, DocBlock):
        return ragged_block(byte_docs, pad_to, flat_step, out=out)
    flat, offs, lengths = ragged_layout(byte_docs, pad_to, flat_step, out=out)
    view = flat.reshape(-1)
    for i, doc in enumerate(byte_docs):
        ln = int(lengths[i])
        if ln:
            start = int(offs[i]) * RAGGED_CHUNK
            view[start : start + ln] = np.frombuffer(doc, np.uint8, count=ln)
    return flat, offs, lengths


def unpack_ragged(flat, offs, lengths, pad_to: int):
    """Device-side inverse of the ragged packers: tensors → uint8
    ``[B, pad_to]``, bit-identical to :func:`pad_batch`'s batch. Chunk ``j``
    of document ``i`` gathers row ``offs[i] + j`` while ``j < ceil(len_i /
    128)`` and the reserved zero row otherwise: one 128-byte-row gather.
    Offsets and lengths arrive as int32; the index is int64."""
    import torch

    nch = pad_to // RAGGED_CHUNK
    j = torch.arange(nch, device=flat.device, dtype=torch.int64)[None, :]
    lengths = lengths.to(torch.int64)
    valid = j < (lengths[:, None] + (RAGGED_CHUNK - 1)) // RAGGED_CHUNK
    idx = torch.where(valid, offs.to(torch.int64)[:, None] + j, 0)
    return flat[idx].reshape(lengths.shape[0], pad_to)


def truncate_utf8(doc: bytes, cap: int) -> bytes:
    """First ``cap`` bytes of a document, never splitting a UTF-8 character:
    if byte ``cap`` is a continuation byte the cut backs up to the character
    boundary. Non-UTF-8 input falls back to the hard cap when backtracking
    would consume the whole prefix. The ``maxScoreBytes`` primitive."""
    if cap <= 0 or len(doc) <= cap:
        return doc
    k = cap
    while k > 0 and (doc[k] & 0xC0) == 0x80:
        k -= 1
    return doc[:k] if k > 0 else doc[:cap]


def chunk_document(doc: bytes, chunk_size: int, overlap: int) -> list[bytes]:
    """Split one long document into ``chunk_size`` chunks sharing ``overlap``
    bytes (``max(gram_lengths) - 1``), so every window of the document lies
    wholly inside some chunk. A non-final chunk owns window starts
    ``[0, chunk_size - overlap)`` and the final chunk owns all of its starts
    (the scorer's ``window_limit``), so each window counts exactly once and
    the document's score is the sum of its chunks' scores.
    """
    if chunk_size <= overlap:
        raise ValueError(f"chunk_size {chunk_size} must exceed overlap {overlap}")
    if len(doc) <= chunk_size:
        return [doc]
    stride = chunk_size - overlap
    return [
        doc[start : start + chunk_size]
        for start in range(0, len(doc) - overlap, stride)
    ]
