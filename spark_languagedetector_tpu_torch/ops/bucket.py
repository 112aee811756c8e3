"""Single-probe bucketized membership table for the row-histogram scorer.

Port of ``spark_languagedetector_tpu.ops.bucket`` (host build and host
lookup; the tables are bit-identical). Where the cuckoo table
(:mod:`ops.cuckoo`) resolves a window in two verified gathers, this table
does it in one:

* **Layout**: ``Mb`` buckets x 8 slots, one int32 [Mb, 16] row per bucket —
  slot keys in columns 0..7, slot payloads in 8..15. A window's bucket is
  ``mix32(key) & (Mb - 1)``; one row gather brings every candidate slot and
  eight compare/selects finish the lookup (``ops.score_hist._bucket_rows``).
* **Build**: single hash, no evictions — seeds are drawn from the
  ``0xB0CE7`` stream until NO bucket overflows 8 slots. ``Mb`` is sized for
  a load of at most ~1.5 keys/bucket. If every seed fails, the caller keeps
  the cuckoo (or LUT) membership.
* **Key forms**: exact vocabs store packed ``(lo, hi)`` gram keys
  (``ops.vocab.gram_key``) with payload ``hi | row << 11`` (a real hi fits
  11 bits; empty slots carry the 0x7FF sentinel no real window produces);
  hashed vocabs store the int32 bucket id itself with the row as payload
  (empty slots: id -1, unreachable since window ids are non-negative).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .vocab import mix32

SLOTS = 8
# Target keys/bucket; P(Poisson(1.5) > 8) ~ 1e-5 keeps zero-overflow seeds
# common while wasting at most ~5x slots.
_TARGET_LOAD = 1.5
_MAX_SEEDS = 64

HI_BITS = 11
HI_SENTINEL = 0x7FF  # > max real packed hi (byte | n << 8 <= 1535)


@dataclass(frozen=True)
class BucketTable:
    """Host-built single-probe table.

    ``rows``: int32 [Mb, 16] bucket rows (keys cols 0..7, payloads 8..15).
    ``kind``: 'exact' (packed-key slots) or 'hashed' (id slots).
    """

    rows: np.ndarray
    seed: int
    kind: str

    @property
    def num_buckets(self) -> int:
        return int(self.rows.shape[0])


def _size_buckets(G: int) -> int:
    Mb = 16
    while Mb * _TARGET_LOAD < G:
        Mb *= 2
    return Mb


def build_buckets_exact(
    keys_lo: np.ndarray, keys_hi: np.ndarray, *, max_seeds: int = _MAX_SEEDS
) -> BucketTable | None:
    """Place G packed keys (row order = weight-row order); None if no
    zero-overflow seed is found."""
    G = int(keys_lo.shape[0])
    if G >= 1 << (31 - HI_BITS):
        return None  # the row index would not fit the payload packing
    keys_lo = np.ascontiguousarray(keys_lo, dtype=np.int32)
    keys_hi = np.ascontiguousarray(keys_hi, dtype=np.int32)
    payload = keys_hi | (np.arange(G, dtype=np.int32) << HI_BITS)
    return _build(keys_lo, keys_hi, payload, 0, HI_SENTINEL, "exact", max_seeds)


def build_buckets_hashed(
    ids: np.ndarray, rows: np.ndarray, *, max_seeds: int = _MAX_SEEDS
) -> BucketTable | None:
    """Place G (id → weight row) pairs (ids are the device window ids; rows
    index the compact weight table); None if no zero-overflow seed is
    found."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    return _build(ids, np.zeros_like(ids), rows, -1, 0, "hashed", max_seeds)


def _build(keys_a, keys_b, payload, empty_key, empty_payload, kind, max_seeds):
    G = int(keys_a.shape[0])
    Mb = _size_buckets(max(G, 1))
    rng = np.random.default_rng(0xB0CE7)
    for _ in range(max_seeds):
        seed = int(rng.integers(1, 2**31 - 1))
        h = (mix32(keys_a, keys_b, seed) & np.uint32(Mb - 1)).astype(np.int64)
        counts = np.bincount(h, minlength=Mb)
        if counts.max(initial=0) > SLOTS:
            continue
        table = np.empty((Mb, 2 * SLOTS), dtype=np.int32)
        table[:, :SLOTS] = empty_key
        table[:, SLOTS:] = empty_payload
        order = np.argsort(h, kind="stable")
        starts = np.cumsum(counts) - counts
        slot = np.arange(G, dtype=np.int64) - starts[h[order]]
        table[h[order], slot] = keys_a[order]
        table[h[order], SLOTS + slot] = payload[order]
        return BucketTable(rows=table, seed=seed, kind=kind)
    return None


def lookup_numpy(table: BucketTable, a: np.ndarray, b: np.ndarray, miss: int):
    """Host mirror of the device lookup: keys (lo, hi) for 'exact', (id,
    zeros) for 'hashed' → weight rows (``miss`` where no slot matches)."""
    Mb = table.num_buckets
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    h = (mix32(a, b, table.seed) & np.uint32(Mb - 1)).astype(np.int64)
    e = table.rows[h]  # [..., 16]
    out = np.full(a.shape, miss, dtype=np.int32)
    for s in range(SLOTS):
        ek = e[..., s]
        ep = e[..., SLOTS + s]
        if table.kind == "exact":
            hit = (ek == a) & ((ep & ((1 << HI_BITS) - 1)) == b)
            row = ep >> HI_BITS
        else:
            hit = ek == a
            row = ep
        out = np.where(hit, row, out)
    return out
