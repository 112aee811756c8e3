"""Micro-batching runner: documents → padded device batches → scores or labels.

Port of ``spark_languagedetector_tpu.api.runner.BatchRunner`` for the
``score`` / ``predict_ids`` / ``predict`` path:

* documents are grouped into padded-length buckets and byte-budgeted
  micro-batches (``exec.core.plan_micro_batches``), so the device sees a
  small closed set of [B, S] shapes;
* documents longer than the largest bucket are chunked with
  ``max(gram_lengths) - 1`` bytes of overlap; a non-final chunk owns window
  starts ``[0, stride)`` through ``window_limit``, and the chunks' score
  rows are summed before the argmax, so chunked documents label exactly;
* ``max_score_bytes`` scores only a UTF-8-safe prefix of each document;
* in label mode the argmax runs on the device and only labels (plus the
  few score rows of chunked documents) are fetched.

Strategies: ``"fused"`` (the default wherever ``fused_supported``; the CUDA
kernel on the card, its plain version on the CPU) and ``"gather"`` (the
row-gather reference, explicit only). A failure of the fused kernel raises;
there is no fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..exec.core import plan_micro_batches, rows_under_byte_budget
from ..ops import score as score_ops
from ..ops import score_fused
from ..ops.encoding import (
    DEFAULT_LENGTH_BUCKETS,
    ENCODINGS,
    UTF8,
    chunk_document,
    pad_batch,
    truncate_utf8,
)
from ..ops.vocab import VocabSpec
from ..utils.device import resolve_device

DEFAULT_BATCH_SIZE = 256
# The fused kernel keeps per-document state on chip (no O(B·vocab) buffers),
# so it takes much larger micro-batches.
DEFAULT_FUSED_BATCH_SIZE = 4096
# Cap on one micro-batch's padded bytes.
MAX_BATCH_BYTES = 8 << 20
STRATEGIES = ("auto", "fused", "gather")


@dataclass
class BatchRunner:
    """Scores document collections through fixed-shape micro-batches on one
    device. One runner per (profile, configuration); reuse it across calls.

    ``weights`` / ``lut`` are the profile's membership arrays
    (``GramProfile.host_membership``, numpy or tensors). ``device`` None
    means the CUDA card and raises when there is none. After construction
    ``table`` / ``scales`` / ``table_lut`` hold the strategy's device
    operands (for ``fused``, the :func:`~..ops.score_fused.build_fused_tables`
    layout in ``layout``).
    """

    weights: object
    lut: object | None
    spec: VocabSpec
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
        self.num_langs = w.shape[1]
        fused_ok = score_fused.fused_supported(
            self.spec, w.shape[0], w.shape[1], lut=lut, cuckoo=None
        )
        if self.strategy == "auto":
            if not fused_ok:
                raise NotImplementedError(
                    "this profile form (cuckoo membership) has no strategy "
                    "in the PyTorch port yet"
                )
            self.strategy = "fused"
            self.strategy_reason = "dense/LUT membership ⇒ fused kernel"
        else:
            self.strategy_reason = "explicit"
        if self.strategy == "fused":
            if not fused_ok:
                raise ValueError(
                    "strategy='fused' needs dense or LUT membership (exact "
                    "gram lengths <= 3, or a hashed vocab)"
                )
            ft = score_fused.build_fused_tables(w, lut, self.spec, self.quantization)
            self.layout = ft.layout
            self._table_bytes = ft.table_bytes
            self.table = torch.from_numpy(ft.wq).to(self.device)
            self.scales = torch.from_numpy(ft.scales).to(self.device)
            self.table_lut = None if ft.lut is None else torch.from_numpy(ft.lut).to(self.device)
        else:
            self.layout = None
            self._table_bytes = w.nbytes + (0 if lut is None else lut.nbytes)
            self.table = torch.from_numpy(w).to(self.device)
            self.scales = None
            self.table_lut = None if lut is None else torch.from_numpy(lut).to(self.device)
        if self.batch_size is None:
            self.batch_size = (
                DEFAULT_FUSED_BATCH_SIZE if self.strategy == "fused"
                else DEFAULT_BATCH_SIZE
            )

    @property
    def max_chunk(self) -> int:
        return self.length_buckets[-1]

    def table_bytes(self) -> int:
        """Device bytes of the active strategy's table (and LUT for gather)."""
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
        return score_ops.score_batch(
            batch, lengths, self.table, self.table_lut, spec=self.spec,
            block=self.block, window_limit=window_limit,
        )

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

    def _execute(self, byte_docs: Sequence[bytes], *, want_labels: bool) -> np.ndarray:
        if self.max_score_bytes:
            cap = self.max_score_bytes
            if self.score_encoding == UTF8:
                byte_docs = [truncate_utf8(d, cap) for d in byte_docs]
            else:
                byte_docs = [d[:cap] for d in byte_docs]
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
