"""GramProfile: the trained model state, host arrays + device tensors.

Port of ``spark_languagedetector_tpu.models.profile``. The state is columnar:
a sorted gram-id vector plus a compact weight matrix, or for hashed
profiles a dense ``[V, L]`` bucket table. Membership on the device is
resolved by tables:

* when the dense ``[id_space, L]`` table fits a budget, window ids index it
  directly;
* otherwise an int32 ``[id_space]`` lookup table maps ids to rows of a
  compact ``[G+1, L]`` table whose row G is the zeros miss row;
* exact gram lengths 4..5 overflow int32 ids, so membership is a cuckoo
  table over packed gram keys (:meth:`GramProfile.device_membership`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.cuckoo import CuckooTable, build_cuckoo
from ..ops.vocab import EXACT, HASHED, MAX_DEVICE_ID_GRAM_LEN, VocabSpec, gram_key
from ..utils.debug import assert_finite
from ..utils.device import resolve_device

# Dense [id_space, L] tables at or under this size are shipped whole; larger
# ones go through the compact LUT path (the hashed 2^20 table at L=176 is
# 738MB in f32, so it compacts).
DENSE_TABLE_BUDGET_BYTES = 256 * 1024 * 1024

# Quantized weight-table dtypes: name -> (numpy dtype, symmetric range).
# Scales are per-language f32: w[r, l] ≈ q[r, l] * scale[l], so the
# dequantize multiply factors out of the window sum and is applied once per
# (doc, language).
QUANT_DTYPES: dict[str, tuple[str, int]] = {
    "int8": ("int8", 127),
    "int16": ("int16", 32767),
}

def quantize_weights(
    weights: np.ndarray, dtype: str
) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-language absmax quantization: (q [R, L], scales [L]).

    ``q = rint(w / scale)`` (half to even) with ``scale[l] = absmax(w[:, l])
    / qmax``; all-zero columns get scale 1.0 so dequantize is total.
    """
    if dtype not in QUANT_DTYPES:
        raise ValueError(
            f"unknown quantization dtype {dtype!r}; expected one of "
            f"{tuple(QUANT_DTYPES)}"
        )
    np_dtype, qmax = QUANT_DTYPES[dtype]
    w = np.asarray(weights, dtype=np.float32)
    absmax = np.abs(w).max(axis=0) if w.size else np.zeros(w.shape[1])
    scales = np.where(absmax > 0, absmax / qmax, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scales), -qmax, qmax).astype(np_dtype)
    return q, scales


def dequantize_weights(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """float32 [R, L] reconstruction ``q * scale``."""
    return q.astype(np.float32) * np.asarray(scales, dtype=np.float32)


@dataclass(frozen=True)
class GramProfile:
    """Immutable trained profile.

    ``ids``: int64 [G] ascending gram ids (compact form). A hashed profile
    may instead be dense: ``ids`` empty and ``weights`` covering all
    ``2^hash_bits`` buckets. ``weights``: float [G, L] or [V, L].
    ``languages``: decision order — index i ⇒ ``languages[i]``.
    """

    spec: VocabSpec
    languages: tuple[str, ...]
    ids: np.ndarray
    weights: np.ndarray

    def __post_init__(self):
        if self.is_dense:
            if self.spec.mode == EXACT:
                raise ValueError("exact profiles must be compact (ids + weights)")
        else:
            if self.ids.shape[0] != self.weights.shape[0]:
                raise ValueError(
                    f"ids/weights mismatch: {self.ids.shape} vs {self.weights.shape}"
                )
            if len(self.ids) > 1 and not bool(np.all(np.diff(self.ids) > 0)):
                raise ValueError("profile ids must be strictly ascending")
            if len(self.ids) and (
                int(self.ids[0]) < 0
                or int(self.ids[-1]) >= self.spec.id_space_size
            ):
                raise ValueError(
                    f"profile ids must lie in [0, {self.spec.id_space_size}); "
                    f"got range [{int(self.ids[0])}, {int(self.ids[-1])}]"
                )
        if self.weights.shape[1] != len(self.languages):
            raise ValueError(
                f"weights have {self.weights.shape[1]} columns for "
                f"{len(self.languages)} languages"
            )
        assert_finite(self.weights, "profile weights")

    @property
    def needs_cuckoo(self) -> bool:
        """True for exact vocabs with gram lengths > 3, whose ids overflow
        int32 and have no dense or LUT device form."""
        return (
            self.spec.mode == EXACT
            and max(self.spec.gram_lengths) > MAX_DEVICE_ID_GRAM_LEN
        )

    @property
    def is_dense(self) -> bool:
        """True for the dense hashed bucket-table form."""
        return (
            self.spec.mode == HASHED
            and self.ids.shape[0] == 0
            and self.weights.shape[0] == self.spec.id_space_size
        )

    @property
    def num_languages(self) -> int:
        return len(self.languages)

    @property
    def num_grams(self) -> int:
        return int(self.weights.shape[0]) if self.is_dense else int(self.ids.shape[0])

    def compacted(self) -> "GramProfile":
        """Compact form: nonzero rows only (no-op if already compact)."""
        if not self.is_dense:
            return self
        nonzero = np.flatnonzero(np.abs(self.weights).sum(axis=1))
        return GramProfile(
            spec=self.spec,
            languages=self.languages,
            ids=nonzero.astype(np.int64),
            weights=np.ascontiguousarray(self.weights[nonzero]),
        )

    def _dense_table(self) -> np.ndarray:
        if self.is_dense:
            return np.asarray(self.weights, dtype=np.float32)
        table = np.zeros(
            (self.spec.id_space_size, self.num_languages), dtype=np.float32
        )
        if len(self.ids):
            table[self.ids] = self.weights
        return table

    def host_membership(
        self, dense_budget_bytes: int = DENSE_TABLE_BUDGET_BYTES
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """(weights f32, lut int32 or None) as host arrays — the choice
        :meth:`device_arrays` uploads. ``lut`` is None when the dense table
        fits ``dense_budget_bytes`` (and is not grossly larger than the
        compact form); else the LUT maps every id to a compact row, misses
        to the zeros row G."""
        if self.needs_cuckoo:
            raise ValueError(
                "exact gram lengths > 3 have no dense/LUT form (the id space "
                "exceeds int32); use device_membership(), whose cuckoo table "
                "handles them"
            )
        L = self.num_languages
        V = self.spec.id_space_size
        dense_bytes = V * L * 4
        compact_bytes = V * 4 + (self.num_grams + 1) * L * 4
        use_dense = dense_bytes <= dense_budget_bytes and (
            (self.spec.mode == EXACT and max(self.spec.gram_lengths) <= 2)
            or dense_bytes <= 4 * compact_bytes
        )
        if use_dense:
            return self._dense_table(), None
        compact = self.compacted()
        G = compact.num_grams
        w = np.concatenate(
            [compact.weights, np.zeros((1, L), compact.weights.dtype)]
        ).astype(np.float32)
        lut = np.full(V, G, dtype=np.int32)
        lut[compact.ids] = np.arange(G, dtype=np.int32)
        return w, lut

    def device_arrays(
        self,
        device=None,
        dense_budget_bytes: int = DENSE_TABLE_BUDGET_BYTES,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(weights f32, lut int32 or None) as tensors on ``device`` (None ⇒
        the CUDA card): :meth:`host_membership`, uploaded."""
        dev = resolve_device(device)
        w, lut = self.host_membership(dense_budget_bytes)
        return (
            torch.from_numpy(w).to(dev),
            None if lut is None else torch.from_numpy(lut).to(dev),
        )

    def device_membership(
        self,
        device=None,
        dense_budget_bytes: int = DENSE_TABLE_BUDGET_BYTES,
    ) -> tuple[torch.Tensor, torch.Tensor | None, CuckooTable | None]:
        """(weights, lut, cuckoo) — the general device view, tensors on
        ``device`` (None ⇒ the CUDA card).

        Exact vocabs with gram lengths > 3 ship the compact weights plus the
        zeros miss row G and a host-built cuckoo table over the grams'
        packed keys (``lut`` None); every other form is
        :meth:`device_arrays` with ``cuckoo`` None.
        """
        if not self.needs_cuckoo:
            w, lut = self.device_arrays(device, dense_budget_bytes)
            return w, lut, None
        dev = resolve_device(device)
        keys = [gram_key(self.spec.id_to_gram(int(i))) for i in self.ids]
        table = build_cuckoo(
            np.asarray([k[0] for k in keys], dtype=np.int32),
            np.asarray([k[1] for k in keys], dtype=np.int32),
        )
        w = np.concatenate(
            [self.weights, np.zeros((1, self.num_languages), self.weights.dtype)]
        ).astype(np.float32)
        return torch.from_numpy(w).to(dev), None, table

    def host_arrays(self) -> tuple[np.ndarray, np.ndarray | None]:
        """(weights, sorted_ids) for ``ops.score.score_batch_numpy``: compact
        weights + miss row + ascending ids, or the dense table + None."""
        if self.is_dense:
            return self.weights, None
        w = np.concatenate(
            [self.weights, np.zeros((1, self.num_languages), self.weights.dtype)]
        )
        return w, self.ids

    @staticmethod
    def from_gram_map(
        gram_map: dict[bytes, "np.ndarray | list[float]"],
        languages: tuple[str, ...] | list[str],
        gram_lengths: tuple[int, ...] | list[int],
    ) -> "GramProfile":
        """Build an exact profile from a hand-written gram→weights map."""
        spec = VocabSpec(EXACT, tuple(gram_lengths))
        items = sorted(
            (
                (spec.gram_to_id(g), np.asarray(w, dtype=np.float64))
                for g, w in gram_map.items()
            ),
            key=lambda kv: kv[0],
        )
        ids = np.asarray([i for i, _ in items], dtype=np.int64)
        L = len(languages)
        weights = (
            np.stack([w for _, w in items])
            if items
            else np.zeros((0, L), dtype=np.float64)
        )
        return GramProfile(
            spec=spec, languages=tuple(languages), ids=ids, weights=weights
        )
