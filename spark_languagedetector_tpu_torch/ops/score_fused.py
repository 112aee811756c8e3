"""The fused kernels: window → id → row → accumulate → scale (→ argmax).

Port of ``spark_languagedetector_tpu.ops.score_fused``: whole-document
scoring and segment mode's per-cell scoring. The TPU kernels they replace
are ``ops/score_fused.py::_build_fused_kernel`` and
``::_build_fused_segment_kernel``; here each is hand-written CUDA C++ for
Hopper (``csrc/fused_detect.cu`` and ``csrc/fused_segment.cu``, whose
headers say what bounds them on the card and what their design does about
that; ``csrc/fused_common.cuh`` holds what the two share: each block
counts its windows per distinct table row in shared memory, then reads
each distinct row once, the TPU kernel's Σ count × w[row] shape).

The table layout is semantics and is kept: :func:`build_fused_tables` lays a
profile out so that

* a dense table (exact gram lengths ≤ 3, or any hashed vocab) is scored
  entirely from the byte plane: window ids are computed in the kernel
  (``POLY``, ``FNV_MASK`` or ``FNV_FOLD``) and are their own rows;
* an exact12 LUT profile is laid out [dense short-gram region of 65,792
  rows ∥ compact long-gram rows]: lengths 1..2 stay inline, lengths ≥ 3 are
  resolved through the re-based LUT into a rows plane;
* any other LUT profile resolves every length through the rows plane.

The TPU layout's (8, 128) padding, shifted byte planes and streamed table
tiles were Mosaic workarounds and are gone.

Beside each kernel sits its plain PyTorch version (:func:`fused_plain`,
:func:`fused_segment_plain`), the same function on the same inputs.
:func:`fused_detect` and :func:`fused_segment` are the wrappers: they take
the plain version only for tensors on the CPU; on a CUDA tensor they launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..models.profile import QUANT_DTYPES, quantize_weights
from ._kernels import FUSED_DETECT, FUSED_SEGMENT, check_operand
from .score import _splice_partial_windows
from .vocab import (
    _EXACT12_BASE,
    _SHORT_GRAM_OFFSETS,
    EXACT,
    EXACT12,
    HASHED,
    MAX_DEVICE_ID_GRAM_LEN,
    VocabSpec,
    partial_window_ids,
    window_ids,
)

# Inline window-id kinds (FusedLayout.inline entries).
POLY = "poly"  # p1 = id-space offset of the length's region
FNV_MASK = "fnv_mask"  # p1 = 2^hash_bits - 1
FNV_FOLD = "fnv_fold"  # p1 = fold base (_EXACT12_BASE), p2 = fold modulus
_KIND_CODE = {POLY: 0, FNV_MASK: 1, FNV_FOLD: 2}
_DTYPE_CODE = {torch.float32: 0, torch.int16: 1, torch.int8: 2}
_TORCH_DTYPE = {None: torch.float32, "int16": torch.int16, "int8": torch.int8}

_MAX_INLINE = 8  # csrc/fused_common.cuh kMaxInline
_MAX_LANGS = 4096  # 1024 threads x 4 columns per thread
# A kernel block counts its windows per distinct row in a shared-memory hash
# table and flushes it (a gather of the rows held) before it could hold more
# than FUSED_MAX_ROWS rows (csrc/fused_common.cuh kMaxFill, half its kSlots).
FUSED_MAX_ROWS = 1024


@dataclass(frozen=True)
class FusedLayout:
    """Plan of one fused table.

    ``inline``: ``(n, kind, p1, p2)`` per gram length whose ids the kernel
    computes from the byte plane. ``rows_lengths``: gram lengths whose rows
    arrive precomputed as the rows plane. ``rows``: row count of the table.
    ``spec``: the vocab the table was laid out for; the plain version takes
    its window ids from it, independently of the ``inline`` plan.
    """

    inline: tuple[tuple[int, str, int, int], ...]
    rows_lengths: tuple[int, ...]
    rows: int
    n_langs: int
    quant: str | None
    spec: VocabSpec


@dataclass(frozen=True)
class FusedTables:
    """Host-built operands of the fused kernel: ``wq`` [rows, L] quantized
    (or f32) table, ``scales`` f32 [L] per-language scales (ones for f32),
    ``lut`` int32 [id_space] fused-row membership or None when every length
    is inline. ``table_bytes`` is the table's size as stored, ``f32_bytes``
    the same rows in f32."""

    layout: FusedLayout
    wq: np.ndarray
    scales: np.ndarray
    lut: np.ndarray | None
    table_bytes: int
    f32_bytes: int


def fused_supported(
    spec: VocabSpec, num_rows: int, num_langs: int, *, lut, cuckoo
) -> bool:
    """True when the fused kernel covers this profile form: dense tables and
    LUT-compact profiles. Packed-key cuckoo membership (exact gram lengths
    4..5) is not covered."""
    if cuckoo is not None:
        return False
    if spec.mode == EXACT and max(spec.gram_lengths) > MAX_DEVICE_ID_GRAM_LEN:
        return False
    return True


def _hashed_inline_entry(spec: VocabSpec, n: int) -> tuple[int, str, int, int]:
    """Inline plan entry for gram length ``n`` of a hashed vocab whose
    buckets index the fused table directly."""
    if spec.hash_scheme == EXACT12 and n <= 2:
        return (n, POLY, _SHORT_GRAM_OFFSETS[n], 0)
    if spec.hash_scheme == EXACT12:
        return (n, FNV_FOLD, _EXACT12_BASE, spec._fold_modulus)
    return (n, FNV_MASK, (1 << spec.hash_bits) - 1, 0)


def build_fused_tables(
    weights, lut, spec: VocabSpec, quantization: str | None = None
) -> FusedTables:
    """Fused-table layout + operands from a profile's membership arrays
    (``GramProfile.host_membership``). Host work, once per profile."""
    w = np.asarray(weights, dtype=np.float32)
    R0, L = w.shape
    lut_np = None if lut is None else np.asarray(lut)
    if lut_np is not None and lut_np.size == 0:
        lut_np = None

    if lut_np is None:
        if spec.mode == EXACT and max(spec.gram_lengths) > MAX_DEVICE_ID_GRAM_LEN:
            raise ValueError(
                "fused kernel: exact gram lengths > "
                f"{MAX_DEVICE_ID_GRAM_LEN} have no int32 id plane"
            )
        if R0 != spec.id_space_size:
            raise ValueError(
                "fused kernel: a dense table must cover the id space "
                f"({spec.id_space_size} rows, got {R0})"
            )
        if spec.mode == EXACT:
            inline = tuple((n, POLY, spec.offsets[n], 0) for n in spec.gram_lengths)
        else:
            inline = tuple(_hashed_inline_entry(spec, n) for n in spec.gram_lengths)
        rows_lengths: tuple[int, ...] = ()
        table = w
        lut_fused = None
    elif (
        spec.mode == HASHED
        and spec.hash_scheme == EXACT12
        and any(n <= 2 for n in spec.gram_lengths)
    ):
        short = tuple(n for n in spec.gram_lengths if n <= 2)
        long = tuple(n for n in spec.gram_lengths if n > 2)
        # Rows = [dense short-gram region | compact long-gram rows]: short
        # buckets are their own row index, long buckets remap into the rows
        # they actually hit.
        dense12 = w[lut_np[:_EXACT12_BASE]]
        inline = tuple((n, POLY, _SHORT_GRAM_OFFSETS[n], 0) for n in short)
        rows_lengths = long
        if long:
            long_refs = lut_np[_EXACT12_BASE:]
            long_rows = np.unique(long_refs)
            rank = np.zeros(R0, dtype=np.int64)
            rank[long_rows] = np.arange(len(long_rows))
            lut_fused = np.empty(spec.id_space_size, dtype=np.int32)
            # Short buckets stay identity: long-gram *partial* windows are
            # 1-2 byte prefixes whose buckets land in the short region.
            lut_fused[:_EXACT12_BASE] = np.arange(_EXACT12_BASE)
            lut_fused[_EXACT12_BASE:] = (_EXACT12_BASE + rank[long_refs]).astype(
                np.int32
            )
            table = np.concatenate([dense12, w[long_rows]])
        else:
            lut_fused = None
            table = dense12
    else:
        inline = ()
        rows_lengths = spec.gram_lengths
        table = w
        lut_fused = lut_np.astype(np.int32)

    R = table.shape[0]
    if quantization is not None:
        q, scales = quantize_weights(table, quantization)
        itemsize = np.dtype(QUANT_DTYPES[quantization][0]).itemsize
    else:
        q, scales = table, np.ones(L, dtype=np.float32)
        itemsize = 4
    layout = FusedLayout(
        inline=inline,
        rows_lengths=rows_lengths,
        rows=R,
        n_langs=L,
        quant=quantization,
        spec=spec,
    )
    return FusedTables(
        layout,
        np.ascontiguousarray(q),
        scales,
        lut_fused,
        R * L * itemsize,
        R * L * 4,
    )


# ------------------------------------------------- kernel inputs -----------


class FusedInputs(NamedTuple):
    """Per-batch operands of the kernel and of its plain version.

    ``batch`` uint8 [B, S] byte plane; ``lengths`` / ``lim`` int32 [B]
    (``lim``: window starts < lim are owned); ``prow`` int32 [B, n_inline]
    partial-window rows of the inline lengths (used where 0 < len < n);
    ``rows`` int32 [B, K, W] rows plane of the LUT lengths (-1 = masked) or
    None when every length is inline.
    """

    batch: torch.Tensor
    lengths: torch.Tensor
    lim: torch.Tensor
    prow: torch.Tensor
    rows: torch.Tensor | None


def _inline_partial_rows(
    batch: torch.Tensor, lengths: torch.Tensor, spec: VocabSpec,
    layout: FusedLayout,
) -> torch.Tensor:
    """int32 [B, n_inline] partial-window rows per inline length (meaningful
    only where 0 < len < n; the kernel ignores the rest)."""
    B = batch.shape[0]
    cols = []
    for n, _, _, _ in layout.inline:
        if spec.mode == EXACT:
            w0 = window_ids(batch[:, :n], n, spec)[:, 0]
        else:
            w0 = torch.zeros((B,), dtype=torch.int64, device=batch.device)
        cols.append(partial_window_ids(batch, lengths, n, w0, spec))
    if not cols:
        return torch.zeros((B, 0), dtype=torch.int32, device=batch.device)
    return torch.stack(cols, dim=1).to(torch.int32).contiguous()


def _rows_plane(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    lut: torch.Tensor | None,
    window_limit: torch.Tensor | None,
    spec: VocabSpec,
    layout: FusedLayout,
) -> torch.Tensor:
    """int32 [B, K, W] fused-table rows of the LUT-resolved lengths, -1 where
    a window is masked or past the segment's end (W = S - min(n) + 1)."""
    B, S = batch.shape
    W = max(S - min(layout.rows_lengths) + 1, 1)
    plane = torch.full(
        (B, len(layout.rows_lengths), W), -1, dtype=torch.int32, device=batch.device
    )
    for k, n in enumerate(layout.rows_lengths):
        ids = window_ids(batch, n, spec)
        rows = ids if lut is None else lut[ids].long()
        pids = partial_window_ids(batch, lengths, n, ids[:, 0], spec)
        prow = pids if lut is None else lut[pids].long()
        prow = torch.where(lengths > 0, prow, -1)
        rows, mask = _splice_partial_windows(rows, prow, lengths, n, window_limit)
        plane[:, k, : rows.shape[1]] = torch.where(mask, rows, -1).to(torch.int32)
    return plane


def prepare_fused_inputs(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    lut: torch.Tensor | None,
    window_limit: torch.Tensor | None,
    spec: VocabSpec,
    layout: FusedLayout,
) -> FusedInputs:
    """Everything the kernel reads besides the table, on the batch's device."""
    B, S = batch.shape
    lengths = lengths.to(torch.int32).contiguous()
    lim = (
        torch.full((B,), S, dtype=torch.int32, device=batch.device)
        if window_limit is None
        else window_limit.to(torch.int32).contiguous()
    )
    rows = (
        _rows_plane(batch, lengths, lut, window_limit, spec, layout)
        if layout.rows_lengths
        else None
    )
    return FusedInputs(
        batch.contiguous(),
        lengths,
        lim,
        _inline_partial_rows(batch, lengths, spec, layout),
        rows,
    )


# ------------------------------------------------- plain version -----------


def window_rows(inp: FusedInputs, layout: FusedLayout):
    """Yield (rows int64 [B, W], mask bool [B, W]) per gram length: the
    table rows the kernel sums for each window, and which windows count
    (owned full windows, plus the partial window of a short document).

    The inline lengths' ids come from the vocab's :func:`window_ids`, not
    from the layout's ``(kind, p1, p2)`` plan that the kernel reads, so a
    comparison with the kernel checks the plan too."""
    batch, lengths, lim, prow, rows = inp
    len64 = lengths.long()
    for j, (n, *_) in enumerate(layout.inline):
        ids = window_ids(batch, n, layout.spec)
        starts = torch.arange(ids.shape[1], device=batch.device)[None, :]
        mask = (starts <= (len64[:, None] - n)) & (starts < lim.long()[:, None])
        short = len64 < n
        ids[:, 0] = torch.where(short, prow[:, j].long(), ids[:, 0])
        mask[:, 0] = mask[:, 0] | (short & (len64 > 0))
        yield ids, mask
    if rows is not None:
        for k in range(rows.shape[1]):
            r = rows[:, k].long()
            yield r.clamp(min=0), r >= 0


def _plain_block(B: int, L: int) -> int:
    """Window block of the plain sum: bounds the gathered [B, block, L]
    slab at about 2^26 elements."""
    return max(16, (1 << 26) // max(1, B * L))


def fused_plain(
    inp: FusedInputs,
    wq: torch.Tensor,
    scales: torch.Tensor,
    layout: FusedLayout,
    *,
    want_labels: bool,
):
    """Plain PyTorch version of the fused kernel on the same inputs: ids →
    rows → mask → Σ wq[rows] → × scales (→ first-max argmax).

    f32 tables sum in f32; int8/int16 tables sum exactly in int64 and are
    scaled once, which is what the kernel's int32 sum gives whenever it
    cannot overflow (the wrapper checks that). Returns f32 [B, L] scores,
    or (labels int32 [B], best f32 [B]) when ``want_labels``.
    """
    B = inp.batch.shape[0]
    L = wq.shape[1]
    integer = wq.dtype != torch.float32
    acc = torch.zeros(
        (B, L), dtype=torch.int64 if integer else torch.float32, device=wq.device
    )
    block = _plain_block(B, L)
    for r, m in window_rows(inp, layout):
        for s in range(0, r.shape[1], block):
            g = wq[r[:, s : s + block]] * m[:, s : s + block, None].to(wq.dtype)
            acc.add_(g.sum(dim=1, dtype=acc.dtype))
    scores = acc.to(torch.float32) * scales.to(torch.float32)
    if want_labels:
        # torch.argmax returns the first maximal index.
        return torch.argmax(scores, dim=1).to(torch.int32), scores.amax(dim=1)
    return scores


def fused_abs_sum(
    inp: FusedInputs, wq: torch.Tensor, scales: torch.Tensor, layout: FusedLayout
) -> torch.Tensor:
    """Σ|terms| per (document, language), float64 [B, L]: the plain
    version's window walk over ``|wq[row]|`` times ``|scales|``.

    An f32 sum of these terms in any order lies within a few units of
    ``2^-24 · Σ|terms|`` of the exact sum, whatever the score itself is, so
    f32 scores are held to ``atol + rtol·|ref| + 2^-23 · Σ|terms|``: a
    bound that grows with the sum where a fixed ``atol`` cannot."""
    acc = torch.zeros(
        (inp.batch.shape[0], wq.shape[1]), dtype=torch.float64, device=wq.device
    )
    w_abs = wq.double().abs()
    for r, m in window_rows(inp, layout):
        acc += (w_abs[r] * m[..., None]).sum(dim=1)
    return acc * scales.double().abs()


# ------------------------------------------------- CUDA kernel -------------


def _check_fused_operands(
    kernel: str,
    inp: FusedInputs,
    wq: torch.Tensor,
    scales: torch.Tensor,
    layout: FusedLayout,
    windows_per_sum: int,
):
    """What both C entry points assume of their operands, checked: CUDA,
    dtype, shape and contiguity of every tensor, the layout's limits, and
    that an int32 sum of ``windows_per_sum`` windows per gram length cannot
    overflow (the kernels sum count × q over distinct rows, and the counts
    add up to the windows, so the same bound holds). Returns the tail of
    both launches' arguments: ``(K, W, R, L, dtype code, n_inline, the
    inline plan's four arrays)``."""
    batch, lengths, lim, prow, rows = inp
    dev = batch.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {dev}")
    B = batch.shape[0]
    R, L = layout.rows, layout.n_langs
    check_operand(kernel, batch, "batch", torch.uint8, 2, dev)
    check_operand(kernel, lengths, "lengths", torch.int32, 1, dev)
    check_operand(kernel, lim, "lim", torch.int32, 1, dev)
    check_operand(kernel, prow, "prow", torch.int32, 2, dev)
    check_operand(kernel, wq, "wq", _TORCH_DTYPE[layout.quant], 2, dev)
    check_operand(kernel, scales, "scales", torch.float32, 1, dev)
    n_inline = len(layout.inline)
    K = len(layout.rows_lengths)
    if tuple(wq.shape) != (R, L) or tuple(scales.shape) != (L,):
        raise ValueError(
            f"{kernel}: table {tuple(wq.shape)} / scales {tuple(scales.shape)} "
            f"disagree with the layout ({R}, {L})"
        )
    if lengths.shape[0] != B or lim.shape[0] != B or tuple(prow.shape) != (B, n_inline):
        raise ValueError(f"{kernel}: per-document operands disagree with the batch")
    if K:
        if rows is None:
            raise ValueError(f"{kernel}: the layout needs a rows plane")
        check_operand(kernel, rows, "rows", torch.int32, 3, dev)
        if rows.shape[0] != B or rows.shape[1] != K:
            raise ValueError(f"{kernel}: rows plane disagrees with the layout")
        W = rows.shape[2]
    else:
        W = 0
    if n_inline > _MAX_INLINE or L > _MAX_LANGS:
        raise ValueError(
            f"{kernel} takes at most {_MAX_INLINE} inline lengths and "
            f"{_MAX_LANGS} languages; got {n_inline} and {L}"
        )
    if layout.quant is not None:
        # int32 accumulation: every window of every length at the int max
        # must stay below 2^31.
        qmax = QUANT_DTYPES[layout.quant][1]
        if (n_inline + K) * max(windows_per_sum, 1) * qmax >= 2**31:
            raise ValueError(
                f"{kernel}: {n_inline + K} lengths x {windows_per_sum} windows x "
                f"{qmax} could overflow the int32 accumulator"
            )
    ints = ctypes.c_int * max(n_inline, 1)
    uints = ctypes.c_uint * max(n_inline, 1)
    return (
        K, W, R, L, _DTYPE_CODE[wq.dtype], n_inline,
        ints(*[e[0] for e in layout.inline]),
        ints(*[_KIND_CODE[e[1]] for e in layout.inline]),
        uints(*[e[2] for e in layout.inline]),
        uints(*[e[3] for e in layout.inline]),
    )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def fused_kernel(
    inp: FusedInputs,
    wq: torch.Tensor,
    scales: torch.Tensor,
    layout: FusedLayout,
    *,
    want_labels: bool,
):
    """Launch ``csrc/fused_detect.cu`` on the batch's CUDA stream (no
    synchronisation). Same inputs and outputs as :func:`fused_plain`."""
    batch, lengths, lim, prow, rows = inp
    B, S = batch.shape
    tail = _check_fused_operands("fused kernel", inp, wq, scales, layout, S)
    dev = batch.device
    labels = best = scores = None
    if want_labels:
        labels = torch.empty((B,), dtype=torch.int32, device=dev)
        best = torch.empty((B,), dtype=torch.float32, device=dev)
    else:
        scores = torch.empty((B, layout.n_langs), dtype=torch.float32, device=dev)
    if B == 0:
        return (labels, best) if want_labels else scores
    with torch.cuda.device(dev):
        FUSED_DETECT.launch(
            _ptr(batch), _ptr(lengths), _ptr(lim), _ptr(prow), _ptr(rows),
            _ptr(wq), _ptr(scales), _ptr(scores), _ptr(labels), _ptr(best),
            B, S, *tail, torch.cuda.current_stream(dev).cuda_stream,
        )
    return (labels, best) if want_labels else scores


def fused_detect(
    inp: FusedInputs,
    wq: torch.Tensor,
    scales: torch.Tensor,
    layout: FusedLayout,
    *,
    want_labels: bool,
):
    """The wrapper: the plain version for tensors on the CPU, the CUDA
    kernel for tensors on the card (it raises rather than fall back)."""
    if inp.batch.device.type == "cpu":
        return fused_plain(inp, wq, scales, layout, want_labels=want_labels)
    return fused_kernel(inp, wq, scales, layout, want_labels=want_labels)


def score_batch_fused(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    lut: torch.Tensor | None = None,
    window_limit: torch.Tensor | None = None,
    *,
    spec: VocabSpec,
    layout: FusedLayout,
) -> torch.Tensor:
    """float32 [B, L] scores via the fused kernel.

    Same contract as :func:`ops.score.score_batch` (masking, the Scala
    ``sliding`` partial-window rule, ``window_limit`` chunk ownership) with
    the table built by :func:`build_fused_tables` and already on the batch's
    device. Scores carry the per-language scale, so chunked documents sum
    across dispatches like every other strategy.
    """
    inp = prepare_fused_inputs(batch, lengths, lut, window_limit, spec, layout)
    return fused_detect(inp, wq, scales, layout, want_labels=False)


def detect_batch_fused(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    lut: torch.Tensor | None = None,
    window_limit: torch.Tensor | None = None,
    *,
    spec: VocabSpec,
    layout: FusedLayout,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels int32 [B], best float32 [B]) with the argmax in the kernel:
    first maximum wins, all-miss documents label 0."""
    inp = prepare_fused_inputs(batch, lengths, lut, window_limit, spec, layout)
    return fused_detect(inp, wq, scales, layout, want_labels=True)


# ------------------------------------------------- segment mode ------------
#
# Per-cell scores: the same chain with one sum per ``cell``-wide span of
# window START positions instead of one per document. A window starting at
# byte s lands in cell s // cell whatever its gram length.


def _check_cell(cell: int) -> None:
    if cell < 128 or cell % 128:
        raise ValueError(
            f"fused segment cell width must be a positive multiple of 128 "
            f"(lane tiling), got {cell}"
        )


def fused_segment_plain(
    inp: FusedInputs,
    wq: torch.Tensor,
    scales: torch.Tensor,
    layout: FusedLayout,
    cell: int,
) -> torch.Tensor:
    """Plain PyTorch version of the fused segment kernel on the same inputs:
    f32 [B, ceil(S / cell), L], entry ``[b, c]`` the scaled sum of the table
    rows of every counted window (:func:`window_rows`) whose start lies in
    ``[c·cell, (c+1)·cell)``. A short document's partial window is window 0,
    so it lands in cell 0. A cell that starts at or past ``len`` or ``lim``
    is all zeros. f32 tables sum in f32; int8/int16 tables sum exactly in
    int64 and are scaled once per (document, cell, language)."""
    B, S = inp.batch.shape
    L = wq.shape[1]
    C = -(-S // cell)
    integer = wq.dtype != torch.float32
    acc = torch.zeros(
        (B, C, L), dtype=torch.int64 if integer else torch.float32, device=wq.device
    )
    block = min(cell, _plain_block(B, L))
    for r, m in window_rows(inp, layout):
        for c in range(-(-r.shape[1] // cell)):
            for s in range(c * cell, min((c + 1) * cell, r.shape[1]), block):
                e = min(s + block, (c + 1) * cell)
                g = wq[r[:, s:e]] * m[:, s:e, None].to(wq.dtype)
                acc[:, c].add_(g.sum(dim=1, dtype=acc.dtype))
    starts = torch.arange(C, device=wq.device)[None, :] * cell
    live = (starts < inp.lengths.long()[:, None]) & (starts < inp.lim.long()[:, None])
    out = acc.to(torch.float32) * scales.to(torch.float32)
    return torch.where(live[..., None], out, torch.zeros_like(out))


def fused_segment_kernel(
    inp: FusedInputs,
    wq: torch.Tensor,
    scales: torch.Tensor,
    layout: FusedLayout,
    cell: int,
) -> torch.Tensor:
    """Launch ``csrc/fused_segment.cu`` on the batch's CUDA stream (no
    synchronisation). Same inputs and output as :func:`fused_segment_plain`;
    the kernel writes every element of the output, zeros included."""
    _check_cell(cell)
    batch, lengths, lim, prow, rows = inp
    B, S = batch.shape
    tail = _check_fused_operands("fused segment kernel", inp, wq, scales, layout, cell)
    dev = batch.device
    C = -(-S // cell)
    out = torch.empty((B, C, layout.n_langs), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    with torch.cuda.device(dev):
        FUSED_SEGMENT.launch(
            _ptr(batch), _ptr(lengths), _ptr(lim), _ptr(prow), _ptr(rows),
            _ptr(wq), _ptr(scales), _ptr(out),
            B, S, cell, C, *tail, torch.cuda.current_stream(dev).cuda_stream,
        )
    return out


def fused_segment(
    inp: FusedInputs,
    wq: torch.Tensor,
    scales: torch.Tensor,
    layout: FusedLayout,
    cell: int,
) -> torch.Tensor:
    """The wrapper: the plain version for tensors on the CPU, the CUDA
    kernel for tensors on the card (it raises rather than fall back)."""
    if inp.batch.device.type == "cpu":
        return fused_segment_plain(inp, wq, scales, layout, cell)
    return fused_segment_kernel(inp, wq, scales, layout, cell)


def segment_batch_fused(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    lut: torch.Tensor | None = None,
    window_limit: torch.Tensor | None = None,
    *,
    spec: VocabSpec,
    layout: FusedLayout,
    cell: int,
) -> torch.Tensor:
    """float32 [B, ceil(S / cell), L] per-cell scores via the fused segment
    kernel.

    The segment-mode twin of :func:`score_batch_fused`: same window ids,
    masking, partial-window splice, ``window_limit`` chunk ownership and
    quantized scales, but a window's contribution lands in the cell of its
    start position, so the host span decoder can see where each language
    lives. Summing a row's cells restores the whole-doc score up to f32
    reduction order.
    """
    _check_cell(cell)
    inp = prepare_fused_inputs(batch, lengths, lut, window_limit, spec, layout)
    return fused_segment(inp, wq, scales, layout, cell)
