"""Gram vocabulary: byte n-grams ↔ integer ids, exact and hashed modes.

PyTorch port of ``spark_languagedetector_tpu.ops.vocab`` (the id scheme is
semantics and is kept bit for bit):

- **EXACT** mode: a gram of length n maps bijectively to
  ``offset(n) + poly(bytes)`` (big-endian base-256 polynomial; the id spaces
  of lengths 1..max stack disjointly). Device ids exist for lengths ≤ 3;
  exact lengths 4..5 overflow int32 ids, so on the device they become packed
  ``(lo, hi)`` int32 keys (:func:`window_keys`) resolved by cuckoo or bucket
  membership (``ops/cuckoo.py``, ``ops/bucket.py``).
- **HASHED** mode: window bytes fold into ``2**bits`` buckets, either with
  FNV-1a over every length (``fnv1a``) or with the ``exact12`` scheme, where
  grams of length ≤ 2 keep their exact polynomial ids in ``[0, 65792)`` and
  longer grams FNV-fold into the remaining buckets.

Host ids are vectorized numpy; device ids are torch. Torch's ``uint32`` is
only partly supported, so the device FNV-1a runs in ``int64`` masked to 32
bits after every multiply — the product of a 32-bit hash and the 25-bit FNV
prime fits in 57 bits, so no step ever overflows. ``mix32``'s constants are
near 2^32, so :func:`mix32_torch` splits each multiply into 16-bit halves
(every product stays under 2^49).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

EXACT = "exact"
HASHED = "hashed"

# Hashed-mode bucket schemes (VocabSpec.hash_scheme).
FNV1A = "fnv1a"
EXACT12 = "exact12"

# Largest exact gram length (packed-key width of the cuckoo membership).
MAX_EXACT_GRAM_LEN = 5
# Largest exact gram length whose polynomial id fits a device int32.
MAX_DEVICE_ID_GRAM_LEN = 3

# exact12: grams of length <= 2 own buckets [0, _EXACT12_BASE); longer grams
# fold into the rest.
_EXACT12_BASE = 256 + 65536

# FNV-1a 32-bit constants.
_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)
_MASK32 = 0xFFFFFFFF


def exact_offsets(gram_lengths: Sequence[int]) -> dict[int, int]:
    """Disjoint id-space offsets for every gram length 1..max(gram_lengths).

    Every length below the max gets a slot because the reference's
    ``sliding`` emits a *partial* window for documents shorter than the gram
    length, so grams shorter than any configured length can be learned and
    matched.
    """
    offsets: dict[int, int] = {}
    acc = 0
    for n in range(1, max(gram_lengths) + 1):
        offsets[n] = acc
        acc += 256**n
    return offsets


def exact_space_size(gram_lengths: Sequence[int]) -> int:
    return sum(256**n for n in range(1, max(gram_lengths) + 1))


# The exact12 short-gram region IS the exact layout for lengths <= 2.
_SHORT_GRAM_OFFSETS = exact_offsets((1, 2))
if _EXACT12_BASE != exact_space_size((1, 2)):  # pragma: no cover
    raise AssertionError("exact12 layout constant drifted from exact layout")


@dataclass(frozen=True)
class VocabSpec:
    """How window bytes become integer gram ids.

    ``mode``: EXACT or HASHED. ``gram_lengths``: window sizes (sorted and
    deduplicated on construction). ``hash_bits``: log2 of the bucket count
    (HASHED only). ``hash_scheme``: "auto" resolves to exact12 when the
    bucket space can hold the short-gram region (hash_bits >= 17), else
    fnv1a.
    """

    mode: str
    gram_lengths: tuple[int, ...]
    hash_bits: int = 20
    hash_scheme: str = "auto"

    def __post_init__(self):
        if self.mode not in (EXACT, HASHED):
            raise ValueError(f"unknown vocab mode {self.mode!r}")
        glens = tuple(sorted(set(int(n) for n in self.gram_lengths)))
        if not glens or glens[0] < 1:
            raise ValueError(f"gram lengths must be >= 1, got {self.gram_lengths}")
        object.__setattr__(self, "gram_lengths", glens)
        if self.mode == EXACT and glens[-1] > MAX_EXACT_GRAM_LEN:
            raise ValueError(
                f"exact vocab supports gram lengths <= {MAX_EXACT_GRAM_LEN} "
                f"(the packed-key width for device membership); got {glens}. "
                "Use mode='hashed'."
            )
        if self.mode == HASHED and not (1 <= self.hash_bits <= 30):
            raise ValueError(f"hash_bits must be in [1, 30], got {self.hash_bits}")
        if self.hash_scheme not in ("auto", FNV1A, EXACT12):
            raise ValueError(
                f"unknown hash scheme {self.hash_scheme!r}; expected 'auto', "
                f"{FNV1A!r}, or {EXACT12!r}"
            )
        if self.mode == EXACT:
            object.__setattr__(self, "hash_scheme", FNV1A)
        elif self.hash_scheme == "auto":
            object.__setattr__(
                self,
                "hash_scheme",
                EXACT12 if (1 << self.hash_bits) > _EXACT12_BASE else FNV1A,
            )
        elif self.hash_scheme == EXACT12 and (1 << self.hash_bits) <= _EXACT12_BASE:
            raise ValueError(
                f"hash_scheme='exact12' needs hash_bits >= 17 (bucket space "
                f"must exceed {_EXACT12_BASE}); got {self.hash_bits}"
            )

    @property
    def _fold_modulus(self) -> int:
        """Bucket count available to FNV-folded (length >= 3) grams."""
        if self.hash_scheme == EXACT12:
            return (1 << self.hash_bits) - _EXACT12_BASE
        return 1 << self.hash_bits

    @property
    def id_space_size(self) -> int:
        """Total dense id space (exact) or bucket count (hashed)."""
        if self.mode == EXACT:
            return exact_space_size(self.gram_lengths)
        return 1 << self.hash_bits

    @property
    def offsets(self) -> dict[int, int]:
        if self.mode != EXACT:
            raise ValueError("offsets only exist for exact vocabs")
        return exact_offsets(self.gram_lengths)

    def gram_to_id(self, gram: bytes) -> int:
        if self.mode == EXACT:
            n = len(gram)
            if n not in self.offsets:
                raise ValueError(
                    f"gram length {n} outside 1..{max(self.gram_lengths)}"
                )
            value = 0
            for b in gram:
                value = value * 256 + b
            return self.offsets[n] + value
        if self.hash_scheme == EXACT12 and 1 <= len(gram) <= 2:
            value = 0
            for b in gram:
                value = value * 256 + b
            return _SHORT_GRAM_OFFSETS[len(gram)] + value
        h = int(_FNV_OFFSET)
        for b in gram:
            h = ((h ^ b) * int(_FNV_PRIME)) & _MASK32
        if self.hash_scheme == EXACT12:
            return _EXACT12_BASE + h % self._fold_modulus
        return h & ((1 << self.hash_bits) - 1)

    def id_to_gram(self, gram_id: int) -> bytes:
        """Inverse mapping — exact mode only (hashed buckets are lossy)."""
        if self.mode != EXACT:
            raise ValueError("hashed vocab ids cannot be decoded to bytes")
        offsets = self.offsets
        for n in sorted(offsets, reverse=True):
            if gram_id >= offsets[n]:
                value = gram_id - offsets[n]
                out = bytearray(n)
                for i in range(n - 1, -1, -1):
                    out[i] = value % 256
                    value //= 256
                return bytes(out)
        raise ValueError(f"gram id {gram_id} below all offsets")


# --- window ids: numpy on the host, torch on the device ---------------------


def window_ids_numpy(batch: np.ndarray, n: int, spec: VocabSpec) -> np.ndarray:
    """Ids of all n-windows of ``batch`` (uint8 [B, S]) → int64 [B, S-n+1].

    Validity masking is the caller's job.
    """
    B, S = batch.shape
    if S < n:  # batch narrower than the window: zero-extend (padding bytes)
        batch = np.pad(batch, ((0, 0), (0, n - S)))
        S = n
    W = S - n + 1
    if spec.mode == EXACT or (spec.hash_scheme == EXACT12 and n <= 2):
        ids = np.zeros((B, W), dtype=np.int64)
        for i in range(n):
            ids = ids * 256 + batch[:, i : i + W].astype(np.int64)
        off = spec.offsets[n] if spec.mode == EXACT else _SHORT_GRAM_OFFSETS[n]
        return ids + off
    h = np.full((B, W), _FNV_OFFSET, dtype=np.uint32)
    for i in range(n):
        h = (h ^ batch[:, i : i + W].astype(np.uint32)) * _FNV_PRIME
    if spec.hash_scheme == EXACT12:
        return (h % np.uint32(spec._fold_modulus)).astype(np.int64) + _EXACT12_BASE
    return (h & np.uint32((1 << spec.hash_bits) - 1)).astype(np.int64)


def fnv1a(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """32-bit FNV-1a over byte planes (each int64, values 0..255), as int64
    in [0, 2^32)."""
    h = torch.full_like(planes[0], int(_FNV_OFFSET))
    for p in planes:
        h = ((h ^ p) * int(_FNV_PRIME)) & _MASK32
    return h


def window_ids(batch: torch.Tensor, n: int, spec: VocabSpec) -> torch.Tensor:
    """Device window ids: uint8 [B, S] → int64 [B, S-n+1].

    The n byte planes of each window are n shifted slices of the batch,
    combined with the per-mode arithmetic; no gather.
    """
    B, S = batch.shape
    if S < n:  # batch narrower than the window: zero-extend (padding bytes)
        batch = torch.nn.functional.pad(batch, (0, n - S))
        S = n
    W = S - n + 1
    planes = [batch[:, i : i + W].long() for i in range(n)]
    if spec.mode == EXACT or (spec.hash_scheme == EXACT12 and n <= 2):
        if spec.mode == EXACT and n > MAX_DEVICE_ID_GRAM_LEN:
            raise ValueError(
                f"exact {n}-gram ids overflow int32; device membership for "
                "gram lengths > 3 goes through packed keys (window_keys) and "
                "cuckoo or bucket lookups"
            )
        ids = torch.zeros_like(planes[0])
        for p in planes:
            ids = ids * 256 + p
        off = spec.offsets[n] if spec.mode == EXACT else _SHORT_GRAM_OFFSETS[n]
        return ids + off
    h = fnv1a(planes)
    if spec.hash_scheme == EXACT12:
        return h % spec._fold_modulus + _EXACT12_BASE
    return h & ((1 << spec.hash_bits) - 1)


def prefix_hashes(batch: torch.Tensor, max_len: int, spec: VocabSpec) -> torch.Tensor:
    """Hashed-mode bucket of the k-byte prefix for k = 1..max_len →
    int64 [B, max_len+1] (column 0 is zeros/unused)."""
    B, S = batch.shape
    if S < max_len:
        batch = torch.nn.functional.pad(batch, (0, max_len - S))
    b = batch[:, :max(max_len, 1)].long()
    h = torch.full((B,), int(_FNV_OFFSET), dtype=torch.int64, device=batch.device)
    cols = [torch.zeros((B,), dtype=torch.int64, device=batch.device)]
    exact12 = spec.hash_scheme == EXACT12
    for i in range(max_len):
        h = ((h ^ b[:, i]) * int(_FNV_PRIME)) & _MASK32
        k = i + 1
        if exact12 and k == 1:
            cols.append(_SHORT_GRAM_OFFSETS[1] + b[:, 0])
        elif exact12 and k == 2:
            cols.append(_SHORT_GRAM_OFFSETS[2] + b[:, 0] * 256 + b[:, 1])
        elif exact12:
            cols.append(h % spec._fold_modulus + _EXACT12_BASE)
        else:
            cols.append(h & ((1 << spec.hash_bits) - 1))
    return torch.stack(cols, dim=1)


def partial_window_ids(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    n: int,
    window0_ids: torch.Tensor,
    spec: VocabSpec,
) -> torch.Tensor:
    """Gram id of the single partial window of each doc with len < n: int64 [B].

    Values are only meaningful where ``0 < lengths < n``; callers mask the
    rest. Exact mode: window 0's padded polynomial is
    ``poly(prefix) * 256**(n-len)`` (padding bytes are zero), so the prefix
    id is recovered with a shift into the length-``len`` id space. Hashed
    mode: FNV prefix buckets.
    """
    dev = batch.device
    if spec.mode == EXACT:
        offsets = spec.offsets
        pow256 = torch.tensor([256**k for k in range(n + 1)], device=dev)
        off_by_len = torch.tensor(
            [0] + [offsets[k] for k in range(1, n + 1)], device=dev
        )
        len_c = lengths.long().clamp(0, n)
        return off_by_len[len_c] + torch.div(
            window0_ids.long() - offsets[n], pow256[n - len_c],
            rounding_mode="floor",
        )
    prefixes = prefix_hashes(batch, n - 1, spec)
    len_c = lengths.long().clamp(0, n - 1)
    return prefixes.gather(1, len_c[:, None])[:, 0]


# --- packed gram keys (device membership for exact gram lengths > 3) --------
#
# A gram of length n <= 5 packs bijectively into two int32 halves:
#   lo = first four bytes big-endian (missing bytes are zero)
#   hi = fifth byte | (n << 8)
# The length tag in ``hi`` keeps different-length prefixes distinct (b"ab\0"
# vs b"ab"). ``lo`` is the wrapped int32 (two's complement) of the 32-bit
# big-endian value; the torch versions compute it in int64 and fold it
# explicitly.

_INT32_WRAP = 1 << 32


def _fold_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → the int32 with the same 32 bits."""
    return torch.where(v >= (1 << 31), v - _INT32_WRAP, v).to(torch.int32)


def gram_key(gram: bytes) -> tuple[int, int]:
    """Host scalar: gram bytes (1..5) → (lo, hi) packed key."""
    n = len(gram)
    if not 1 <= n <= MAX_EXACT_GRAM_LEN:
        raise ValueError(f"gram length {n} outside 1..{MAX_EXACT_GRAM_LEN}")
    lo = 0
    for i in range(4):
        lo = (lo << 8) | (gram[i] if i < n else 0)
    if lo >= 1 << 31:  # the device's wrapped int32 representation
        lo -= _INT32_WRAP
    hi = (gram[4] if n == 5 else 0) | (n << 8)
    return lo, hi


def window_keys(batch: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Device window keys: uint8 [B, S] → (lo, hi) int32 [B, S-n+1] each."""
    B, S = batch.shape
    if S < n:
        batch = torch.nn.functional.pad(batch, (0, n - S))
        S = n
    W = S - n + 1
    lo = torch.zeros((B, W), dtype=torch.int64, device=batch.device)
    for i in range(min(n, 4)):
        lo = lo | (batch[:, i : i + W].long() << (8 * (3 - i)))
    hi = torch.full((B, W), n << 8, dtype=torch.int64, device=batch.device)
    if n == 5:
        hi = hi | batch[:, 4 : 4 + W].long()
    return _fold_int32(lo), hi.to(torch.int32)


def window_keys_numpy(batch: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Host mirror of :func:`window_keys`."""
    B, S = batch.shape
    if S < n:
        batch = np.pad(batch, ((0, 0), (0, n - S)))
        S = n
    W = S - n + 1
    lo = np.zeros((B, W), dtype=np.int64)
    for i in range(4):
        plane = (
            batch[:, i : i + W].astype(np.int64)
            if i < n
            else np.zeros((B, W), np.int64)
        )
        lo = (lo << 8) | plane
    hi = (
        batch[:, 4 : 4 + W].astype(np.int64) if n == 5 else np.zeros((B, W), np.int64)
    ) | (n << 8)
    return lo.astype(np.int32), hi.astype(np.int32)


def partial_window_keys(
    batch: torch.Tensor, lengths: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed key of each doc's single partial window (len < n): (lo, hi)
    int32 [B]. The partial window is the whole document, a gram of its own
    length k (Scala ``sliding``, as :func:`partial_window_ids`). Values are
    only meaningful where ``0 < lengths < n``; callers mask."""
    B, S = batch.shape
    if S < 4:
        batch = torch.nn.functional.pad(batch, (0, 4 - S))
    # k <= n - 1 <= 4, so the fifth byte never takes part; hi is the tag.
    k = lengths.long().clamp(0, n - 1)
    lo = torch.zeros((B,), dtype=torch.int64, device=batch.device)
    for i in range(4):
        lo = (lo << 8) | torch.where(i < k, batch[:, i].long(), 0)
    return _fold_int32(lo), (k << 8).to(torch.int32)


# Murmur3-style 32-bit mixer over a packed key + seed (the cuckoo and bucket
# tables' hashes).
_MIX_C1 = 0x85EB_CA6B
_MIX_C2 = 0xC2B2_AE35
_GOLDEN = 0x9E37_79B9


def mix32(lo, hi, seed: int) -> np.ndarray:
    """uint32 mix of int32 (lo, hi) arrays + seed (numpy; int32 → uint32
    casts wrap two's-complement)."""
    u = np.uint32
    h = np.asarray(lo).astype(u) ^ u((seed * _GOLDEN) & _MASK32)
    h = (h ^ (h >> u(16))) * u(_MIX_C1)
    h = h ^ np.asarray(hi).astype(u) * u(_MIX_C2)
    h = (h ^ (h >> u(13))) * u(_MIX_C1)
    return h ^ (h >> u(16))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32) and a 32-bit constant c,
    with c split into 16-bit halves so no product reaches 2^49."""
    lo_part = h * (c & 0xFFFF)
    hi_part = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo_part + hi_part) & _MASK32


def mix32_torch(lo: torch.Tensor, hi: torch.Tensor, seed: int) -> torch.Tensor:
    """:func:`mix32` on torch int32 (lo, hi) → int64 in [0, 2^32)."""
    h = (lo.long() & _MASK32) ^ ((seed * _GOLDEN) & _MASK32)
    h = _mul32(h ^ (h >> 16), _MIX_C1)
    h = h ^ _mul32(hi.long() & _MASK32, _MIX_C2)
    h = _mul32(h ^ (h >> 13), _MIX_C1)
    return h ^ (h >> 16)


def short_doc_ids_numpy(doc: bytes, spec: VocabSpec) -> list[int]:
    """Reference partial-window rule (host): a document shorter than a gram
    length contributes ONE window of the whole document for that length,
    in the id space of ``len(doc)`` — one id per configured gram length
    > len(doc), not deduplicated (the reference looks the partial window up
    once per gram length)."""
    n_doc = len(doc)
    if n_doc == 0 or n_doc >= max(spec.gram_lengths):
        return []
    short_id = spec.gram_to_id(bytes(doc))
    return [short_id for n in spec.gram_lengths if n > n_doc]
