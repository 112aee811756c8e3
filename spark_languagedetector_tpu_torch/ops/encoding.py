"""Text → fixed-shape byte arrays (host side, vectorized numpy).

Port of ``spark_languagedetector_tpu.ops.encoding`` (the padded form only;
the ragged and wire forms come with a later slice). Each text is encoded to
bytes, and a micro-batch is packed into a zero-padded ``uint8 [B, S]`` array
plus an ``int32 [B]`` length vector. Padding is 0x00; validity is carried by
the length vector, never by sentinel bytes.

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
