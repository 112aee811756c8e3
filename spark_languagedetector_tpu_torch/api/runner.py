"""Micro-batching runner: documents → padded device batches → scores or labels.

Port of ``spark_languagedetector_tpu.api.runner.BatchRunner`` for the
``score`` / ``predict_ids`` / ``predict`` path and segment mode's
``segment_cells``:

* documents are grouped into padded-length buckets and byte-budgeted
  micro-batches (``exec.core.plan_micro_batches``), so the device sees a
  small closed set of [B, S] shapes;
* documents longer than the largest bucket are chunked with
  ``max(gram_lengths) - 1`` bytes of overlap; a non-final chunk owns window
  starts ``[0, stride)`` through ``window_limit``, and the chunks' score
  rows are summed before the argmax, so chunked documents label exactly;
* ``max_score_bytes`` scores only a UTF-8-safe prefix of each document;
* in label mode the argmax runs on the device and only labels (plus the
  few score rows of chunked documents) are fetched;
* in segment mode (:meth:`BatchRunner.segment_cells`) the device returns one
  score vector per cell of ``SEGMENT_CELL`` window starts; long documents
  chunk on a cell-aligned stride, so each cell is owned by one chunk. A
  fused runner scores cells with the CUDA fused-segment kernel, every other
  strategy with the gather cell scorer (dense, LUT or cuckoo).

Strategies, chosen by ``auto`` in this order (the JAX package's accelerator
order; the choice does not depend on the device — on the CPU each strategy
runs its kernels' plain versions):

* ``"fused"``: dense and LUT profiles (the CUDA fused-detect kernel);
* ``"pallas"``: exact vocabs with gram lengths ⊆ {1, 2} over the dense
  table (bigram-score kernel up to 16 languages, bigram-histogram kernel and
  a matmul beyond);
* ``"hybrid"``: exact short-gram ids with longer grams (cuckoo profiles,
  exact n = 1..5): lengths ≤ 2 through the pallas scorer over a dense
  sub-table, the rest through ``hist`` (or the cuckoo/LUT gather when no
  bucket table could be built);
* ``"hist"``: compact-row membership (a bucket table from the cuckoo keys or
  the LUT): the row-histogram kernel and a matmul;
* ``"gather"``: the row-gather reference (dense, LUT or cuckoo), explicit
  or when nothing above applies.

A failure of a kernel raises; there is no fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..exec.core import plan_micro_batches, rows_under_byte_budget
from ..ops import bucket as bucket_ops
from ..ops import cuckoo as cuckoo_ops
from ..ops import score as score_ops
from ..ops import score_fused, score_hist, score_pallas
from ..ops.encoding import (
    DEFAULT_LENGTH_BUCKETS,
    ENCODINGS,
    UTF8,
    chunk_document,
    pad_batch,
    truncate_utf8,
)
from ..ops.vocab import EXACT, EXACT12, HASHED, VocabSpec
from ..utils.device import resolve_device

DEFAULT_BATCH_SIZE = 256
# The fused and pallas kernels keep per-document state on chip (no
# O(B·vocab) buffers), so they take much larger micro-batches.
DEFAULT_FUSED_BATCH_SIZE = 4096
# Hybrid and hist micro-batches (the JAX runner's sizes): the histograms are
# [B, 65536] and [B, Rhi·256] float32 buffers, and gram lengths ≥ 4 (three
# long-gram membership passes per document) take the smaller batch.
DEFAULT_HYBRID_BATCH_SIZE = 4096
DEFAULT_HEAVY_BATCH_SIZE = 1024
# Cap on one micro-batch's padded bytes.
MAX_BATCH_BYTES = 8 << 20
STRATEGIES = ("auto", "fused", "pallas", "hybrid", "hist", "gather")
# Segment-mode cell width: window start positions per device score vector
# (a multiple of 128; the JAX package's default).
SEGMENT_CELL = 256


@dataclass(frozen=True)
class HistState:
    """Row-histogram operands: the padded weight table (float64, for the
    contraction), Rhi, and the membership — a bucket table (``kind``
    'exact' for packed gram keys, 'hashed' for window ids) or, when
    ``bucket`` is None, the id→row LUT."""

    weights_pad: torch.Tensor
    rhi: int
    bucket: torch.Tensor | None
    seed: int
    kind: str
    lut: torch.Tensor | None


@dataclass(frozen=True)
class PallasState:
    """Bigram-scorer operands: the exact sub-spec of lengths ≤ 2, its
    weight views, and the lengths left for the long-gram part (hybrid)."""

    spec: VocabSpec
    w1: torch.Tensor
    w2: torch.Tensor
    rest: tuple[int, ...]


@dataclass
class BatchRunner:
    """Scores document collections through fixed-shape micro-batches on one
    device. One runner per (profile, configuration); reuse it across calls.

    ``weights`` / ``lut`` / ``cuckoo`` are the profile's membership
    (``GramProfile.device_membership``; arrays may be numpy or tensors).
    ``device`` None means the CUDA card and raises when there is none. After
    construction the strategy's device operands are built once: for
    ``fused``, ``table`` / ``scales`` / ``table_lut`` in the
    :func:`~..ops.score_fused.build_fused_tables` layout ``layout``; for the
    bigram strategies ``pallas_state``; for the row histogram ``hist_state``
    (None where the hybrid's long grams gather instead); for gathers
    ``table`` / ``table_lut`` and the cuckoo entries.
    """

    weights: object
    lut: object | None
    spec: VocabSpec
    cuckoo: cuckoo_ops.CuckooTable | None = None
    device: object | None = None
    batch_size: int | None = None  # None ⇒ by strategy
    length_buckets: tuple[int, ...] = DEFAULT_LENGTH_BUCKETS
    batch_bytes: int = MAX_BATCH_BYTES
    block: int = score_ops.DEFAULT_BLOCK  # gather window block
    strategy: str = "auto"
    quantization: str | None = None  # 'int8' | 'int16' fused tables
    max_score_bytes: int | None = None
    score_encoding: str = UTF8

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.length_buckets = tuple(self.length_buckets)
        if self.score_encoding not in ENCODINGS:
            raise ValueError(
                f"unknown score_encoding {self.score_encoding!r}; expected "
                f"one of {ENCODINGS}"
            )
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; expected one of {STRATEGIES}"
            )
        if self.quantization not in (None, *score_fused.QUANT_DTYPES):
            raise ValueError(
                f"unknown quantization {self.quantization!r}; expected one "
                f"of {tuple(score_fused.QUANT_DTYPES)} or None"
            )
        if self.quantization is not None and self.strategy not in ("auto", "fused"):
            raise ValueError(
                "quantization applies to the fused strategy only; got "
                f"strategy={self.strategy!r}"
            )
        w = np.asarray(torch.as_tensor(self.weights).cpu(), dtype=np.float32)
        lut = None if self.lut is None else np.asarray(torch.as_tensor(self.lut).cpu())
        if lut is not None and lut.size == 0:
            lut = None
        if lut is not None and self.cuckoo is not None:
            raise ValueError("pass a LUT or a cuckoo table for membership, not both")
        self.num_langs = w.shape[1]
        # Host membership, kept for the gather cell scorer's operands, which
        # are uploaded on the first segment request of a non-fused runner.
        self._host_weights, self._host_lut = w, lut
        self._cell_operands = None
        fused_ok = score_fused.fused_supported(
            self.spec, w.shape[0], w.shape[1], lut=lut, cuckoo=self.cuckoo
        )
        pallas_ok = (
            lut is None
            and self.cuckoo is None
            and score_pallas.pallas_supported(self.spec, w.shape[0], w.shape[1])
        )
        hybrid_ok = self._hybrid_supported()
        self.hist_state = None
        if self.strategy == "auto":
            self.strategy, self.strategy_reason = self._auto_select(
                w, lut, fused_ok, pallas_ok, hybrid_ok
            )
        else:
            self.strategy_reason = "explicit"
        if self.strategy in ("hybrid", "hist") and self.hist_state is None:
            self.hist_state = self._build_hist_state(w, lut)
        for name, ok, need in (
            ("fused", fused_ok, "dense or LUT membership (exact gram lengths "
             "<= 3, or a hashed vocab); cuckoo profiles use hybrid/hist"),
            ("pallas", pallas_ok, "an exact vocab with gram lengths <= 2 and "
             "the dense weight table"),
            ("hybrid", hybrid_ok, "exact short-gram ids (exact vocab or hashed "
             "'exact12' scheme) with gram lengths both <= 2 and > 2"),
            ("hist", self.hist_state is not None, "compact-row membership (a "
             "cuckoo table whose bucket build succeeds, or an id->row LUT)"),
        ):
            if self.strategy == name and not ok:
                raise ValueError(f"strategy={name!r} needs {need}")
        self._build_operands(w, lut)
        if self.batch_size is None:
            if self.strategy in ("fused", "pallas"):
                self.batch_size = DEFAULT_FUSED_BATCH_SIZE
            elif self.strategy in ("hybrid", "hist"):
                heavy = any(n >= 4 for n in self.spec.gram_lengths)
                self.batch_size = (
                    DEFAULT_HEAVY_BATCH_SIZE if heavy else DEFAULT_HYBRID_BATCH_SIZE
                )
            else:
                self.batch_size = DEFAULT_BATCH_SIZE

    # -- strategy selection and operands ---------------------------------------
    def _hybrid_supported(self) -> bool:
        """Gram lengths both ≤ 2 and > 2 whose short-gram ids are exact
        polynomial ids: exact vocabs, and hashed vocabs under ``exact12``
        (whose buckets [0, 65792) are exactly the short-gram ids)."""
        glens = self.spec.gram_lengths
        ids_exact12 = self.spec.mode == EXACT or (
            self.spec.mode == HASHED and self.spec.hash_scheme == EXACT12
        )
        return ids_exact12 and min(glens) <= 2 < max(glens)

    def _auto_select(self, w, lut, fused_ok, pallas_ok, hybrid_ok) -> tuple[str, str]:
        """(strategy, reason) for strategy='auto': fused → pallas → hybrid →
        hist → gather, whatever the device. Deciding on hist builds its
        operands (``hist_state``)."""
        if self.quantization is not None:
            if not fused_ok:
                raise ValueError(
                    "quantization needs the fused strategy, which does not "
                    "support this profile form (cuckoo membership)"
                )
            return "fused", "quantization requested ⇒ fused table"
        if fused_ok:
            return "fused", "dense/LUT membership ⇒ fused kernel"
        if pallas_ok:
            return "pallas", "exact short-gram dense table ⇒ bigram kernels"
        if hybrid_ok:
            return "hybrid", (
                "exact short-gram ids with long grams ⇒ bigram kernels for "
                "n <= 2, row histogram (or gather) for the rest"
            )
        self.hist_state = self._build_hist_state(w, lut)
        if self.hist_state is not None:
            return "hist", "compact-row membership ⇒ row-histogram kernel"
        return "gather", "no kernel strategy covers this profile form"

    def _build_hist_state(self, w: np.ndarray, lut: np.ndarray | None) -> HistState | None:
        """Row-histogram operands, or None where the strategy cannot apply
        (no compact membership, or a cuckoo profile whose bucket build found
        no zero-overflow seed). The bucket table comes from the cuckoo keys
        (packed-key slots) or from the LUT's learned ids (id slots); when a
        LUT's bucket build fails the LUT itself is the membership."""
        if self.cuckoo is not None:
            table = bucket_ops.build_buckets_exact(
                self.cuckoo.keys_lo[:-1], self.cuckoo.keys_hi[:-1]
            )
            if table is None:
                return None
        elif lut is not None:
            ids = np.flatnonzero(lut != w.shape[0] - 1).astype(np.int32)
            table = bucket_ops.build_buckets_hashed(ids, lut[ids])
        else:
            return None
        wp, rhi = score_hist.pad_weights(w)
        dev = self.device
        return HistState(
            weights_pad=torch.from_numpy(wp).to(dev, torch.float64),
            rhi=rhi,
            bucket=None if table is None else torch.from_numpy(table.rows).to(dev),
            seed=0 if table is None else table.seed,
            kind="hashed" if table is None else table.kind,
            lut=torch.from_numpy(lut).to(dev) if table is None else None,
        )

    def _build_pallas_state(self, w: np.ndarray, lut: np.ndarray | None) -> PallasState:
        """Bigram-scorer operands on the device. For ``pallas`` the whole
        dense table; for ``hybrid`` the dense sub-table of lengths ≤ 2,
        gathered once from the profile through the cuckoo table (every 1- and
        2-gram key looked up on the host), the LUT, or the dense table's
        first rows (the exact id layout stacks lengths ascending, so the
        sub-spec's ids are the full spec's first rows)."""
        if self.strategy == "pallas":
            table = torch.from_numpy(w).to(self.device)
            return PallasState(self.spec, *score_pallas.weight_views(table, self.spec), rest=())
        sub = tuple(n for n in self.spec.gram_lengths if n <= 2)
        rest = tuple(n for n in self.spec.gram_lengths if n > 2)
        spec12 = VocabSpec(EXACT, sub)
        V12 = spec12.id_space_size
        if self.cuckoo is not None:
            v = np.arange(256, dtype=np.uint32)
            a = np.repeat(v, 256)
            b = np.tile(v, 256)
            lo = np.concatenate([v << 24, (a << 24) | (b << 16)]).astype(np.int32)
            hi = np.concatenate(
                [np.full(256, 1 << 8, np.int32), np.full(65536, 2 << 8, np.int32)]
            )
            rows = cuckoo_ops.lookup_numpy(self.cuckoo, lo, hi)[:V12]
        elif lut is not None:
            rows = lut[:V12]
        else:
            rows = np.arange(V12)
        table = torch.from_numpy(w[rows]).to(self.device)
        return PallasState(spec12, *score_pallas.weight_views(table, spec12), rest=rest)

    def _build_operands(self, w: np.ndarray, lut: np.ndarray | None) -> None:
        """Upload what the strategy reads, once."""
        dev = self.device
        self.layout = self.scales = self.table = self.table_lut = None
        self.pallas_state = None
        self._cuckoo_entries = None
        if self.strategy == "fused":
            ft = score_fused.build_fused_tables(w, lut, self.spec, self.quantization)
            self.layout = ft.layout
            self._table_bytes = ft.table_bytes
            self.table = torch.from_numpy(ft.wq).to(dev)
            self.scales = torch.from_numpy(ft.scales).to(dev)
            self.table_lut = None if ft.lut is None else torch.from_numpy(ft.lut).to(dev)
            return
        held = []
        if self.strategy in ("pallas", "hybrid"):
            self.pallas_state = self._build_pallas_state(w, lut)
            held += [self.pallas_state.w1, self.pallas_state.w2]
        if self.hist_state is not None:
            held += [
                t for t in (self.hist_state.weights_pad, self.hist_state.bucket,
                            self.hist_state.lut) if t is not None
            ]
        elif self.strategy in ("hybrid", "gather"):
            self.table = torch.from_numpy(w).to(dev)
            held.append(self.table)
            if self.cuckoo is not None:
                self._cuckoo_entries = torch.from_numpy(self.cuckoo.entries()).to(dev)
                held.append(self._cuckoo_entries)
            elif lut is not None:
                self.table_lut = torch.from_numpy(lut).to(dev)
                held.append(self.table_lut)
        self._table_bytes = sum(t.numel() * t.element_size() for t in held)

    @property
    def max_chunk(self) -> int:
        return self.length_buckets[-1]

    def table_bytes(self) -> int:
        """Device bytes of the active strategy's tables and membership."""
        return int(self._table_bytes)

    def plan(self, sizes: Sequence[int]) -> list[tuple[np.ndarray, int]]:
        """The micro-batch plan for items of these byte sizes."""
        return plan_micro_batches(
            sizes,
            length_buckets=self.length_buckets,
            rows_for=lambda pad_to: rows_under_byte_budget(
                pad_to, self.batch_bytes, self.batch_size
            ),
        )

    # -- device work ----------------------------------------------------------
    def _to_device(self, docs: Sequence[bytes], limits: np.ndarray, pad_to: int):
        batch_np, lengths_np = pad_batch(docs, pad_to)
        batch = torch.from_numpy(batch_np).to(self.device)
        lengths = torch.from_numpy(lengths_np).to(self.device)
        window_limit = (
            None
            if bool((limits == self.max_chunk).all())
            else torch.from_numpy(limits.astype(np.int32)).to(self.device)
        )
        return batch, lengths, window_limit

    def _scores(self, batch, lengths, window_limit) -> torch.Tensor:
        if self.strategy == "fused":
            return score_fused.score_batch_fused(
                batch, lengths, self.table, self.scales, self.table_lut, window_limit,
                spec=self.spec, layout=self.layout,
            )
        if self.strategy in ("pallas", "hybrid"):
            # Lengths ≤ 2 through the bigram kernels; a hybrid's longer
            # lengths through the row histogram or the gather. Each part
            # applies its own lengths' partial-window rules, so the sum is
            # exact.
            st = self.pallas_state
            short = score_pallas.score_batch_pallas(
                batch, lengths, st.w1, st.w2, window_limit, spec=st.spec
            )
            if not st.rest:
                return short
            return short + self._long_scores(batch, lengths, window_limit, st.rest)
        return self._long_scores(batch, lengths, window_limit, None)

    def _long_scores(self, batch, lengths, window_limit, subset) -> torch.Tensor:
        """Row-histogram scores where the runner has the operands, else the
        gather (cuckoo, LUT or dense) — the hybrid's long-gram route when no
        bucket table could be built, and the explicit ``gather``."""
        h = self.hist_state
        if h is not None:
            return score_hist.score_batch_hist(
                batch, lengths, h.weights_pad, h.lut, h.bucket, window_limit,
                spec=self.spec, rhi=h.rhi, bucket_seed=h.seed, bucket_kind=h.kind,
                gram_lengths_subset=subset,
            )
        block = self.block if subset is None else min(self.block, 256)
        if self.cuckoo is not None:
            return score_ops.score_batch_cuckoo(
                batch, lengths, self.table, self._cuckoo_entries,
                seed1=self.cuckoo.seed1, seed2=self.cuckoo.seed2, spec=self.spec,
                block=block, window_limit=window_limit, gram_lengths_subset=subset,
            )
        return score_ops.score_batch(
            batch, lengths, self.table, self.table_lut, spec=self.spec,
            block=block, window_limit=window_limit, gram_lengths_subset=subset,
        )

    def _gather_cell_operands(self):
        """(table, lut, cuckoo entries) of the gather cell scorer on the
        device: the profile's own f32 membership. The gather strategies hold
        it already; the kernel strategies upload it on first use."""
        if self._cell_operands is None:
            dev = self.device
            table, lut, entries = self.table, self.table_lut, self._cuckoo_entries
            if table is None:
                table = torch.from_numpy(self._host_weights).to(dev)
                if self.cuckoo is not None:
                    entries = torch.from_numpy(self.cuckoo.entries()).to(dev)
                elif self._host_lut is not None:
                    lut = torch.from_numpy(self._host_lut).to(dev)
                self._table_bytes += sum(
                    t.numel() * t.element_size()
                    for t in (table, lut, entries) if t is not None
                )
            self._cell_operands = (table, lut, entries)
        return self._cell_operands

    def _window_scores_device(self, batch, lengths, window_limit, cell) -> torch.Tensor:
        """Gather-formulation per-cell scorer: segment mode's exactness
        oracle, and the route of every non-fused strategy (the bigram and
        row-histogram kernels have no per-cell form)."""
        table, lut, entries = self._gather_cell_operands()
        if self.cuckoo is not None:
            return score_ops.window_scores_batch_cuckoo(
                batch, lengths, table, entries,
                seed1=self.cuckoo.seed1, seed2=self.cuckoo.seed2, spec=self.spec,
                cell=cell, block=min(self.block, 1024), window_limit=window_limit,
            )
        return score_ops.window_scores_batch(
            batch, lengths, table, lut, spec=self.spec, cell=cell,
            block=min(self.block, 1024), window_limit=window_limit,
        )

    def _segment_dispatch_device(self, batch, lengths, window_limit, cell) -> torch.Tensor:
        """One packed batch → f32 [B, ceil(pad_to / cell), L] raw cell
        scores: the fused-segment kernel for a fused runner, the gather cell
        scorer for every other strategy."""
        if self.strategy == "fused":
            return score_fused.segment_batch_fused(
                batch, lengths, self.table, self.scales, self.table_lut, window_limit,
                spec=self.spec, layout=self.layout, cell=cell,
            )
        return self._window_scores_device(batch, lengths, window_limit, cell)

    def _labels(self, batch, lengths, window_limit) -> torch.Tensor:
        if self.strategy == "fused":
            labels, _ = score_fused.detect_batch_fused(
                batch, lengths, self.table, self.scales, self.table_lut, window_limit,
                spec=self.spec, layout=self.layout,
            )
            return labels
        return score_ops.argmax_language(self._scores(batch, lengths, window_limit))

    # -- public API -----------------------------------------------------------
    def score(self, byte_docs: Sequence[bytes]) -> np.ndarray:
        """float32 [N, L] scores in input order (exact over any doc length)."""
        return self._execute(byte_docs, want_labels=False)

    def predict_ids(self, byte_docs: Sequence[bytes]) -> np.ndarray:
        """int32 [N] argmax language indices in input order. The argmax runs
        on the device; only chunked documents fetch score rows, which are
        summed across chunks before their argmax."""
        return self._execute(byte_docs, want_labels=True)

    def predict(self, byte_docs: Sequence[bytes], languages: Sequence[str]) -> list[str]:
        return [languages[i] for i in self.predict_ids(byte_docs)]

    def scored_docs(self, byte_docs: Sequence[bytes]) -> list[bytes]:
        """The documents as scored: cut to ``max_score_bytes`` where set
        (UTF-8 documents at a character boundary)."""
        cap = self.max_score_bytes
        if not cap:
            return list(byte_docs)
        if self.score_encoding == UTF8:
            return [truncate_utf8(d, cap) for d in byte_docs]
        return [d[:cap] for d in byte_docs]

    def segment_cells(
        self, byte_docs: Sequence[bytes], *, cell: int | None = None
    ) -> tuple[list[np.ndarray], list[bytes]]:
        """Raw per-cell scores for span-level decoding.

        Returns ``(cells, scored_docs)``: ``cells[i]`` is float32
        ``[C_i, L]`` with ``C_i = max(1, ceil(len_i / cell))``; entry ``[c]``
        sums every window (every gram length) whose start byte lies in
        ``[c·cell, (c+1)·cell)`` of the document. ``scored_docs[i]`` is the
        byte string the cells describe (the input after ``max_score_bytes``
        truncation), so the host span decoder snaps boundaries on the
        content that was scored.

        Long documents chunk on a cell-aligned stride (the whole-doc path's
        overlap rule rounded so that chunk ownership boundaries land on cell
        boundaries), so every global cell is owned by exactly one chunk and
        the assembled cells are exact. Cells past a batch's longest owned
        range are padding and are not copied back. The whole-doc
        ``score``/``predict_ids`` paths share none of this method's device
        work.

        Left out of the port on purpose, as in ``score``: duplicate-document
        folding, dispatch threads, telemetry spans, and the retry / circuit
        breaker / degradation ladder. A failure of the kernel raises.
        """
        cell = int(cell or SEGMENT_CELL)
        if cell < 128 or cell % 128:
            raise ValueError(
                f"segment cell must be a positive multiple of 128, got {cell}"
            )
        if cell > self.max_chunk:
            raise ValueError(
                f"segment cell {cell} exceeds the largest length bucket "
                f"{self.max_chunk}"
            )
        byte_docs = self.scored_docs(byte_docs)
        L = self.num_langs
        out: list[np.ndarray] = []
        if not byte_docs:
            return [], []

        overlap = max(self.spec.gram_lengths) - 1
        # Cell-aligned chunk stride: ownership boundaries must land on cell
        # edges so each global cell belongs to exactly one chunk.
        stride = ((self.max_chunk - overlap) // cell) * cell

        # Work items: (doc index, chunk bytes, window limit, global cell
        # offset, owned cell count).
        doc_idx: list[int] = []
        chunks: list[bytes] = []
        limits: list[int] = []
        cell_offs: list[int] = []
        takes: list[int] = []
        for i, doc in enumerate(byte_docs):
            n_cells = max(1, -(-len(doc) // cell))
            out.append(np.zeros((n_cells, L), dtype=np.float32))
            if len(doc) <= self.max_chunk:
                doc_idx.append(i)
                chunks.append(doc)
                limits.append(self.max_chunk)
                cell_offs.append(0)
                takes.append(n_cells)
                continue
            if stride < cell:
                # Only a document that needs chunking needs the stride;
                # single-chunk documents segment even when max_chunk leaves
                # no room for one.
                raise ValueError(
                    f"document of {len(doc)} bytes needs chunking, but "
                    f"segment cell {cell} leaves no cell-aligned chunk "
                    f"stride under max_chunk {self.max_chunk} "
                    f"(overlap {overlap})"
                )
            parts = chunk_document(doc, stride + overlap, overlap)
            for j, part in enumerate(parts):
                doc_idx.append(i)
                chunks.append(part)
                off = j * stride // cell
                cell_offs.append(off)
                if j < len(parts) - 1:
                    limits.append(stride)
                    takes.append(stride // cell)
                else:
                    limits.append(self.max_chunk)
                    takes.append(n_cells - off)
        limits_arr = np.asarray(limits, dtype=np.int64)

        for sel, pad_to in self.plan([len(c) for c in chunks]):
            batch, lengths, window_limit = self._to_device(
                [chunks[k] for k in sel], limits_arr[sel], pad_to
            )
            cells = self._segment_dispatch_device(batch, lengths, window_limit, cell)
            # Cells past the longest owned range of the batch are padding.
            host = cells[:, : max(takes[k] for k in sel)].cpu().numpy()
            for r, k in enumerate(sel):
                off, take = cell_offs[k], takes[k]
                out[doc_idx[k]][off : off + take] = host[r, :take]
        return out, byte_docs

    def _execute(self, byte_docs: Sequence[bytes], *, want_labels: bool) -> np.ndarray:
        byte_docs = self.scored_docs(byte_docs)
        N = len(byte_docs)
        L = self.num_langs
        out = (
            np.zeros(N, dtype=np.int32) if want_labels
            else np.zeros((N, L), dtype=np.float32)
        )
        if N == 0:
            return out

        # Expand long docs into chunks: (doc index, bytes, owned starts).
        overlap = max(self.spec.gram_lengths) - 1
        stride = self.max_chunk - overlap
        doc_idx: list[int] = []
        chunks: list[bytes] = []
        limits: list[int] = []
        chunk_rank: dict[int, int] = {}  # chunked doc → row of chunk_acc
        for i, doc in enumerate(byte_docs):
            if len(doc) <= self.max_chunk:
                doc_idx.append(i)
                chunks.append(doc)
                limits.append(self.max_chunk)  # no-op limit
                continue
            chunk_rank[i] = len(chunk_rank)
            parts = chunk_document(doc, self.max_chunk, overlap)
            for j, part in enumerate(parts):
                doc_idx.append(i)
                chunks.append(part)
                limits.append(stride if j < len(parts) - 1 else self.max_chunk)
        doc_idx_arr = np.asarray(doc_idx, dtype=np.int64)
        limits_arr = np.asarray(limits, dtype=np.int64)
        chunk_acc = (
            np.zeros((len(chunk_rank), L), dtype=np.float32)
            if want_labels and chunk_rank else None
        )

        for sel, pad_to in self.plan([len(c) for c in chunks]):
            batch, lengths, window_limit = self._to_device(
                [chunks[k] for k in sel], limits_arr[sel], pad_to
            )
            docs_of = doc_idx_arr[sel]
            if not want_labels:
                scores = self._scores(batch, lengths, window_limit).cpu().numpy()
                np.add.at(out, docs_of, scores)
                continue
            pos = np.flatnonzero([int(d) in chunk_rank for d in docs_of])
            if pos.size == 0:
                out[docs_of] = self._labels(batch, lengths, window_limit).cpu().numpy()
                continue
            # A batch holding chunks: argmax on the device for whole docs,
            # and the chunk rows' scores fetched for the cross-chunk sum.
            scores = self._scores(batch, lengths, window_limit)
            am = score_ops.argmax_language(scores).cpu().numpy()
            sub = scores[torch.from_numpy(pos).to(scores.device)].cpu().numpy()
            whole = np.ones(len(sel), dtype=bool)
            whole[pos] = False
            out[docs_of[whole]] = am[whole]
            np.add.at(chunk_acc, [chunk_rank[int(docs_of[p])] for p in pos], sub)

        if chunk_acc is not None:
            for i, r in chunk_rank.items():
                out[i] = int(np.argmax(chunk_acc[r]))
        return out
