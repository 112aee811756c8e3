"""Byte windows and gram ids: a frozen copy of the scheme the program uses.

This is the only part of the program's semantics that the reference takes
as given, because it is the definition of a gram id and not a computation:
which byte windows a document has, and which integer each window maps to.
It was copied from the port's ``ops/vocab.py`` (``window_ids_numpy``,
``VocabSpec.gram_to_id``, ``short_doc_ids_numpy``) and is kept here so that
a change to the program cannot move it.

- Windows: for each configured length n, every n-byte window that lies
  wholly inside the document. A document shorter than the longest length
  (and not empty) also has one *partial* window, the whole document, in its
  own length's id space, once for each configured n longer than it.
- EXACT ids: ``offset(n) + big-endian base-256 value``, where the lengths
  1..max stack disjointly (``offset(1) = 0``, ``offset(2) = 256``, ...).
- HASHED ids, scheme ``exact12``: lengths 1 and 2 keep their exact ids in
  ``[0, 65792)``; longer windows take 32-bit FNV-1a of their bytes,
  ``65792 + h % (2**bits - 65792)``. Scheme ``fnv1a``: every length takes
  ``h & (2**bits - 1)``.

Everything here is plain torch on whatever device the tensors are on.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
MASK32 = 0xFFFFFFFF
EXACT12_BASE = 256 + 65536


@dataclass(frozen=True)
class Vocab:
    mode: str  # "exact" | "hashed"
    gram_lengths: tuple[int, ...]
    hash_bits: int = 20
    scheme: str = "exact12"  # hashed only: "exact12" | "fnv1a"

    @staticmethod
    def of(config: dict) -> "Vocab":
        """The vocabulary a benchmark configuration states."""
        mode = config["vocabMode"]
        if mode not in ("exact", "hashed"):
            raise ValueError(f"unknown vocab mode {mode!r}")
        scheme = config.get("hashScheme", "exact12") if mode == "hashed" else "exact"
        if mode == "hashed" and scheme not in ("exact12", "fnv1a"):
            raise ValueError(f"unknown hash scheme {scheme!r}")
        return Vocab(mode, tuple(sorted(set(int(n) for n in config["gramLengths"]))),
                     int(config.get("hashBits", 20)), scheme)

    def offset(self, n: int) -> int:
        """Exact id of the all-zero gram of length ``n``."""
        return sum(256**k for k in range(1, n))

    def _exact_value(self, n: int) -> bool:
        return self.mode == "exact" or (self.scheme == "exact12" and n <= 2)

    def ids_of_planes(self, planes: list[torch.Tensor]) -> torch.Tensor:
        """Gram ids of windows given their byte planes (int64 tensors of
        equal shape, values 0..255, ``len(planes)`` = the window length)."""
        n = len(planes)
        if self._exact_value(n):
            v = torch.zeros_like(planes[0])
            for p in planes:
                v = v * 256 + p
            return v + self.offset(n)
        h = torch.full_like(planes[0], FNV_OFFSET)
        for p in planes:
            h = ((h ^ p) * FNV_PRIME) & MASK32
        if self.scheme == "exact12":
            return EXACT12_BASE + h % ((1 << self.hash_bits) - EXACT12_BASE)
        return h & ((1 << self.hash_bits) - 1)

    def gram_id(self, gram: bytes) -> int:
        """Id of one gram (host scalar; the partial windows)."""
        t = torch.tensor(list(gram), dtype=torch.int64)[:, None]
        return int(self.ids_of_planes([t[i] for i in range(len(gram))])[0])


def flat_docs(byte_docs, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(flat uint8 [T], starts int64 [D], lengths int64 [D])`` of documents
    laid end to end on ``device``."""
    lens = torch.tensor([len(d) for d in byte_docs], dtype=torch.int64)
    flat = torch.frombuffer(bytearray(b"".join(byte_docs)) or bytearray(1), dtype=torch.uint8)
    starts = torch.cumsum(lens, 0) - lens
    return flat.to(device), starts.to(device), lens.to(device)


def window_ids(vocab: Vocab, byte_docs, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Every window of ``byte_docs``: ``(ids int64 [M], doc int64 [M])``,
    the gram id and the index of its document, partial windows included."""
    flat, starts, lens = flat_docs(byte_docs, device)
    T = int(lens.sum())
    doc_of = torch.repeat_interleave(torch.arange(len(byte_docs), device=device), lens)
    pos = torch.arange(T, device=device) - starts[doc_of]
    ids_out, doc_out = [], []
    for n in vocab.gram_lengths:
        if T < n:
            continue
        W = T - n + 1
        planes = [flat[i : i + W].long() for i in range(n)]
        valid = pos[:W] <= lens[doc_of[:W]] - n
        ids_out.append(vocab.ids_of_planes(planes)[valid])
        doc_out.append(doc_of[:W][valid])
    longest = max(vocab.gram_lengths)
    p_ids, p_docs = [], []
    for d, doc in enumerate(byte_docs):
        if 0 < len(doc) < longest:
            gid = vocab.gram_id(bytes(doc))
            reps = sum(1 for n in vocab.gram_lengths if n > len(doc))
            p_ids += [gid] * reps
            p_docs += [d] * reps
    if p_ids:
        ids_out.append(torch.tensor(p_ids, dtype=torch.int64, device=device))
        doc_out.append(torch.tensor(p_docs, dtype=torch.int64, device=device))
    if not ids_out:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return z, z
    return torch.cat(ids_out), torch.cat(doc_out)


def blocks(byte_docs, max_bytes: int):
    """``(start, stop)`` index ranges of consecutive documents holding at
    most ``max_bytes`` bytes each (a longer document alone)."""
    start, size = 0, 0
    for i, d in enumerate(byte_docs):
        if i > start and size + len(d) > max_bytes:
            yield start, i
            start, size = i, 0
        size += len(d)
    if start < len(byte_docs):
        yield start, len(byte_docs)
