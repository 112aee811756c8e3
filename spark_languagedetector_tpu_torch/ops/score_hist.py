"""Row-histogram scoring: the n >= 3 accumulate as histogram x table.

Port of ``spark_languagedetector_tpu.ops.score_hist``. Instead of gathering
one weight row per window, each document's windows are first counted per
compact weight row, then contracted with the table in one matmul:

    scores[b] = sum_w W[r_bw] = hist_b @ W,  hist_b[r] = #{w : r_bw == r}

Membership (window → compact row) is the single-probe bucket table
(``ops.bucket``, one [16]-int row gather per window) built from the cuckoo
keys or from the id→row LUT, or the LUT itself. Masked and missing windows
point at a zero weight row (``miss``), which the histogram leaves out.

The histogram is the hand-written CUDA kernel ``csrc/row_hist.cu`` (the port
of the TPU's ``_build_kernel``) on the card and its plain PyTorch version
(:func:`row_hist_plain`) on the CPU; :func:`row_hist` is the wrapper. The
contraction ``hist @ W`` runs in float64: the counts are exact integers and
the product is rounded to float32 once, so no TF32 or reduced-precision
matmul setting of the process can reach it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..telemetry import REGISTRY
from ._kernels import ROW_HIST, check_operand
from .bucket import HI_BITS, SLOTS
from .score import _splice_partial_windows
from .vocab import (
    VocabSpec,
    mix32_torch,
    partial_window_ids,
    partial_window_keys,
    window_ids,
    window_keys,
)

# Window-axis block of the bucket lookup: bounds the gathered [B, block, 16]
# int32 temporary (64 MB at B = 1,024).
MEMBER_BLOCK = 1024
# Rows whose uint32 counts fit one block's shared memory (227 KB); larger
# tables take the kernel's global-atomic path (csrc/row_hist.cu).
SHARED_MEMORY_ROWS = 232448 // 4
# Float counts are exact below 2^24 windows per document.
_MAX_EXACT_COUNT = 1 << 24


def pad_weights(weights, rhi: int | None = None) -> tuple[np.ndarray, int]:
    """Compact [G+1, L] table → ([Rhi*256, L] f32 zero-padded, Rhi).

    Rows past the table are never counted (no window resolves there), so
    zero padding is inert. Rhi is rounded up to a multiple of 8, as the JAX
    package does, so the last row is always a zero row (the miss row).
    """
    R, L = weights.shape
    if rhi is None:
        ceil_hi = -(-R // 256)
        rhi = -(-ceil_hi // 8) * 8
    padded = np.zeros((rhi * 256, L), dtype=np.float32)
    padded[:R] = np.asarray(weights, dtype=np.float32)
    return padded, rhi


# ------------------------------------------------------------ membership ---


def _bucket_decode(
    l: torch.Tensor, h_k: torch.Tensor, e: torch.Tensor, rows: torch.Tensor, kind: str
) -> torch.Tensor:
    """Fold gathered bucket rows e [..., 16] into verified weight rows."""
    for s in range(SLOTS):
        ek = e[..., s]
        ep = e[..., SLOTS + s]
        if kind == "exact":
            hit = (ek == l) & ((ep & ((1 << HI_BITS) - 1)) == h_k)
            row = ep >> HI_BITS
        else:
            hit = ek == l
            row = ep
        rows = torch.where(hit, row.long(), rows)
    return rows


def _bucket_rows(
    lo: torch.Tensor,
    hi: torch.Tensor,
    table: torch.Tensor,
    miss: int,
    seed: int,
    kind: str,
) -> torch.Tensor:
    """Single-probe verified bucket lookup (``ops.bucket.BucketTable``):
    keys [B, W] → int64 weight rows, ``miss`` where no slot matches. One
    bucket-row gather per window, in window blocks of MEMBER_BLOCK."""
    Mb = table.shape[0]
    B, W = lo.shape
    out = torch.empty((B, W), dtype=torch.int64, device=lo.device)
    for s in range(0, W, MEMBER_BLOCK):
        l = lo[:, s : s + MEMBER_BLOCK]
        h = hi[:, s : s + MEMBER_BLOCK]
        e = table[mix32_torch(l, h, seed) & (Mb - 1)]
        miss_rows = torch.full(l.shape, miss, dtype=torch.int64, device=lo.device)
        out[:, s : s + MEMBER_BLOCK] = _bucket_decode(l, h, e, miss_rows, kind)
    return out


# ------------------------------------------------------------ the kernel ---


def row_hist_plain(
    rows: torch.Tensor, vmax: torch.Tensor, W: int, rhi: int, miss: int
) -> torch.Tensor:
    """Plain PyTorch version of the row-histogram kernel: float32
    [B, rhi*256] counts of each row id over the windows of ``rows`` (int32
    [B, K*W]) whose segment-local start is < ``vmax[b]``; the ``miss`` row
    and ids outside [0, rhi*256) are not counted."""
    B, KW = rows.shape
    R = rhi * 256
    r = rows.long()
    local = torch.arange(KW, device=rows.device) % W
    valid = (
        (local[None, :] < vmax.long()[:, None]) & (r >= 0) & (r < R) & (r != miss)
    )
    doc = torch.arange(B, device=rows.device)[:, None]
    idx = (doc * R + r)[valid]
    return torch.bincount(idx, minlength=B * R).reshape(B, R).to(torch.float32)


def row_hist_kernel(
    rows: torch.Tensor, vmax: torch.Tensor, W: int, rhi: int, miss: int
) -> torch.Tensor:
    """Launch ``csrc/row_hist.cu`` on the current CUDA stream (no
    synchronisation). Same inputs and output as :func:`row_hist_plain`.
    A launch past :data:`SHARED_MEMORY_ROWS` rows takes the kernel's
    global-atomic path and adds one to ``score/hist/global_atomic``."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"row_hist kernel needs CUDA tensors, got {dev}")
    check_operand("row_hist kernel", rows, "rows", torch.int32, 2, dev)
    check_operand("row_hist kernel", vmax, "vmax", torch.int32, 1, dev)
    B, KW = rows.shape
    if W <= 0 or KW % W or vmax.shape[0] != B:
        raise ValueError(
            f"row_hist kernel: rows {tuple(rows.shape)} / vmax "
            f"{tuple(vmax.shape)} disagree with the segment width {W}"
        )
    if KW >= _MAX_EXACT_COUNT:
        raise ValueError(f"row_hist kernel: {KW} windows per document could "
                         "exceed exact float counts")
    R = rhi * 256
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    if B == 0 or KW == 0:
        return out.zero_()
    if R > SHARED_MEMORY_ROWS:
        REGISTRY.incr("score/hist/global_atomic")
    with torch.cuda.device(dev):
        ROW_HIST.launch(
            rows.data_ptr(), vmax.data_ptr(), out.data_ptr(), B, KW // W, W, R, miss,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return out


def row_hist(
    rows: torch.Tensor, vmax: torch.Tensor, W: int, rhi: int, miss: int
) -> torch.Tensor:
    """The wrapper: the plain version for tensors on the CPU, the CUDA
    kernel for tensors on the card (it raises rather than fall back)."""
    if rows.device.type == "cpu":
        return row_hist_plain(rows, vmax, W, rhi, miss)
    return row_hist_kernel(rows, vmax, W, rhi, miss)


# ------------------------------------------------------------- scoring ----


def hist_rows_plane(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    miss: int,
    lut: torch.Tensor | None = None,
    bucket: torch.Tensor | None = None,
    window_limit: torch.Tensor | None = None,
    *,
    spec: VocabSpec,
    bucket_seed: int = 0,
    bucket_kind: str = "exact",
    gram_lengths_subset: tuple[int, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The row-histogram kernel's inputs for one batch: (rows int32
    [B, K*W], vmax int32 [B], W). Each length's windows resolve to weight
    rows through the bucket table (packed keys for 'exact' tables, window
    ids for 'hashed' ones) or the LUT; masked windows and the padded tail
    of each segment point at ``miss``."""
    if (lut is None) == (bucket is None):
        raise ValueError("pass exactly one of bucket (preferred) or lut for membership")
    B, S = batch.shape
    lens = spec.gram_lengths if gram_lengths_subset is None else gram_lengths_subset
    W = max(S - n + 1 if S >= n else 1 for n in lens)
    segs = []
    for n in lens:
        if bucket is not None and bucket_kind == "exact":
            lo, hi = window_keys(batch, n)
            rows = _bucket_rows(lo, hi, bucket, miss, bucket_seed, bucket_kind)
            plo, phi = partial_window_keys(batch, lengths, n)
            prows = _bucket_rows(
                plo[:, None], phi[:, None], bucket, miss, bucket_seed, bucket_kind
            )[:, 0]
        elif bucket is not None:
            ids = window_ids(batch, n, spec)
            rows = _bucket_rows(
                ids, torch.zeros_like(ids), bucket, miss, bucket_seed, bucket_kind
            )
            pids = partial_window_ids(batch, lengths, n, ids[:, 0], spec)[:, None]
            prows = _bucket_rows(
                pids, torch.zeros_like(pids), bucket, miss, bucket_seed, bucket_kind
            )[:, 0]
        else:
            ids = window_ids(batch, n, spec)
            rows = lut[ids].long()
            prows = lut[partial_window_ids(batch, lengths, n, ids[:, 0], spec)].long()
        prows = torch.where(lengths > 0, prows, miss)
        rows, mask = _splice_partial_windows(rows, prows, lengths, n, window_limit)
        rows = torch.where(mask, rows, miss)
        segs.append(torch.nn.functional.pad(rows, (0, W - rows.shape[1]), value=miss))
    rows_all = torch.cat(segs, dim=1).to(torch.int32).contiguous()
    # Every counted start is < min(len, limit); the partial window sits at
    # start 0, counted whenever len > 0.
    vmax = torch.clamp(lengths.long(), max=W)
    if window_limit is not None:
        vmax = torch.minimum(vmax, window_limit.long())
    return rows_all, vmax.to(torch.int32).contiguous(), W


def score_batch_hist(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    weights_pad: torch.Tensor,
    lut: torch.Tensor | None = None,
    bucket: torch.Tensor | None = None,
    window_limit: torch.Tensor | None = None,
    *,
    spec: VocabSpec,
    rhi: int,
    bucket_seed: int = 0,
    bucket_kind: str = "exact",
    gram_lengths_subset: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Histogram-strategy scores, float32 [B, L], for a padded batch.

    Same contract as ``ops.score.score_batch`` / ``score_batch_cuckoo``
    (masking, the Scala ``sliding`` partial-window rule, ``window_limit``,
    subset), with the weight table pre-padded by :func:`pad_weights` and held
    as float64, the dtype of the contraction. Membership is the bucket table
    when ``bucket`` is given (``bucket_kind`` 'exact': packed gram keys from
    a cuckoo profile; 'hashed': int32 window ids from a LUT profile), else
    the id→row ``lut``.
    """
    if weights_pad.dtype != torch.float64:
        raise ValueError(f"weights_pad must be float64, got {weights_pad.dtype}")
    miss = weights_pad.shape[0] - 1  # a zero row (pad_weights)
    rows, vmax, W = hist_rows_plane(
        batch, lengths, miss, lut, bucket, window_limit, spec=spec,
        bucket_seed=bucket_seed, bucket_kind=bucket_kind,
        gram_lengths_subset=gram_lengths_subset,
    )
    hist = row_hist(rows, vmax, W, rhi, miss)
    return torch.matmul(hist.to(torch.float64), weights_pad).to(torch.float32)
