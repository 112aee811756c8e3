"""Two-choice cuckoo table: exact gram membership at any length.

Port of ``spark_languagedetector_tpu.ops.cuckoo`` (host build and host
lookup; the tables are bit-identical). Exact gram lengths 4..5 overflow
int32 ids and a LUT over the 256^5 id space is impossible, so membership
becomes a **two-choice cuckoo table** over packed ``(lo, hi)`` int32 keys
(``ops.vocab.gram_key``):

* host build (here): every profile gram is placed at one of its two bucket
  positions ``mix32(key, seed1) % M`` / ``mix32(key, seed2) % M`` by the
  classic eviction loop; a cycle triggers a rebuild with fresh seeds from
  the same ``0xC0C0`` stream, so both packages draw the same seeds. M is a
  power of two at ≤ 40% load.
* device lookup (``ops.score._cuckoo_rows``): two slot gathers + key
  verification against the stored halves.

The miss row G carries sentinel keys (hi = -1) that no real gram can produce
(real ``hi`` is ``byte | (n << 8)`` ≥ 256), so unverified probes fall through
to the zero-weight row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .vocab import mix32

# Slots-per-gram factor; 2-choice cuckoo at ≤ 50% load succeeds w.h.p.
_LOAD_FACTOR_INV = 2.5
_MAX_EVICTIONS = 500
_MAX_REBUILDS = 20


@dataclass(frozen=True)
class CuckooTable:
    """Host-built table, ready to ship to the device.

    ``slots``: int32 [M] — row index into the compact weight table, or G
    (miss row) for empty slots. ``keys_lo``/``keys_hi``: int32 [G+1] packed
    keys per row; row G holds the non-matching sentinel.
    """

    slots: np.ndarray
    keys_lo: np.ndarray
    keys_hi: np.ndarray
    seed1: int
    seed2: int

    @property
    def num_slots(self) -> int:
        return int(self.slots.shape[0])

    def entries(self) -> np.ndarray:
        """Device form: int32 [M, 4] rows ``[key_lo, key_hi, row, 0]``, so
        one row gather resolves a whole probe. Empty slots carry the miss
        row and the sentinel ``key_hi = -1``."""
        M = self.num_slots
        out = np.zeros((M, 4), dtype=np.int32)
        out[:, 0] = self.keys_lo[self.slots]
        out[:, 1] = self.keys_hi[self.slots]
        out[:, 2] = self.slots
        return out


def build_cuckoo(keys_lo: np.ndarray, keys_hi: np.ndarray) -> CuckooTable:
    """Place G packed keys (int32 [G], row order = compact weight-table row
    order) into a two-choice cuckoo table. Raises RuntimeError only if every
    rebuild fails."""
    G = int(keys_lo.shape[0])
    M = 1 << max(4, int(np.ceil(np.log2(max(G, 1) * _LOAD_FACTOR_INV))))
    keys_lo = np.ascontiguousarray(keys_lo, dtype=np.int32)
    keys_hi = np.ascontiguousarray(keys_hi, dtype=np.int32)

    rng = np.random.default_rng(0xC0C0)
    for _ in range(_MAX_REBUILDS):
        seed1, seed2 = (int(s) for s in rng.integers(1, 2**31 - 1, size=2))
        h1 = (mix32(keys_lo, keys_hi, seed1) % np.uint32(M)).astype(np.int64)
        h2 = (mix32(keys_lo, keys_hi, seed2) % np.uint32(M)).astype(np.int64)
        slots = np.full(M, G, dtype=np.int32)
        ok = True
        for row in range(G):
            cur, bucket = row, int(h1[row])
            placed = False
            for _ in range(_MAX_EVICTIONS):
                if slots[bucket] == G:
                    slots[bucket] = cur
                    placed = True
                    break
                # Evict the occupant to its alternate bucket.
                cur, slots[bucket] = int(slots[bucket]), cur
                b1, b2 = int(h1[cur]), int(h2[cur])
                bucket = b2 if bucket == b1 else b1
            if not placed:
                ok = False
                break
        if ok:
            lo = np.concatenate([keys_lo, np.zeros(1, np.int32)])
            hi = np.concatenate([keys_hi, np.full(1, -1, np.int32)])
            return CuckooTable(
                slots=slots, keys_lo=lo, keys_hi=hi, seed1=seed1, seed2=seed2
            )
    raise RuntimeError(
        f"cuckoo build failed after {_MAX_REBUILDS} rebuilds (G={G}, M={M})"
    )


def lookup_numpy(table: CuckooTable, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host mirror of the device lookup: packed keys → compact rows (miss →
    G)."""
    M = table.num_slots
    G = table.keys_lo.shape[0] - 1
    lo = np.ascontiguousarray(lo, dtype=np.int32)
    hi = np.ascontiguousarray(hi, dtype=np.int32)
    h1 = (mix32(lo, hi, table.seed1) % np.uint32(M)).astype(np.int64)
    h2 = (mix32(lo, hi, table.seed2) % np.uint32(M)).astype(np.int64)
    r1 = table.slots[h1]
    r2 = table.slots[h2]
    hit1 = (table.keys_lo[r1] == lo) & (table.keys_hi[r1] == hi)
    hit2 = (table.keys_lo[r2] == lo) & (table.keys_hi[r2] == hi)
    return np.where(hit1, r1, np.where(hit2, r2, G))
