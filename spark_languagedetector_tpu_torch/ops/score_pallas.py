"""Bigram scoring for exact vocabs with gram lengths ⊆ {1, 2}.

Port of ``spark_languagedetector_tpu.ops.score_pallas`` (the name is the JAX
module's; nothing here is Pallas). Two hand-written CUDA kernels, each with
its plain PyTorch version beside it and a wrapper that takes the plain
version only for tensors on the CPU:

* :func:`bigram_score` (``csrc/bigram_score.cu``, the port of the TPU's
  fused ``_build_kernel``): unigram and bigram scores of up to
  ``MAX_PALLAS_LANGS`` languages, the weight rows summed in the kernel;
* :func:`bigram_hist` (``csrc/bigram_hist.cu``, the port of
  ``_build_hist_kernel``): per-document [256, 256] byte-pair counts for any
  language count, contracted afterwards by :func:`_score_from_hist`.

:func:`score_batch_pallas` picks between them by language count and applies
the Scala ``sliding`` rule for 1-byte documents under n = 2, as the JAX
wrapper does. The histogram contractions run in float64 over exact integer
counts and round to float32 once, so no TF32 or reduced-precision matmul
setting of the process can reach them.
"""

from __future__ import annotations

import torch

from ._kernels import BIGRAM_HIST, BIGRAM_SCORE, check_operand
from .vocab import EXACT, VocabSpec

# Language ceiling of the bigram-score kernel (its per-thread sums live in
# registers); more languages take the histogram kernel and a matmul.
MAX_PALLAS_LANGS = 16
# Window block of the plain versions' sums: bounds the gathered
# [B, block, L] slab.
DEFAULT_BLOCK = 2048


def pallas_supported(spec: VocabSpec, num_rows: int, num_langs: int) -> bool:
    """True when the pallas strategy applies: exact vocab, gram lengths ⊆
    {1, 2}, dense weight table over the full id space (unigram-only vocabs
    only up to MAX_PALLAS_LANGS languages, as in the JAX package)."""
    if num_langs > MAX_PALLAS_LANGS and 2 not in spec.gram_lengths:
        return False
    return (
        spec.mode == EXACT
        and max(spec.gram_lengths) <= 2
        and num_rows == spec.id_space_size
    )


def weight_views(weights, spec: VocabSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense [V, L] table → (w1 [256, L], w2 [65536, L]) float32, contiguous,
    on the table's device. Both kernels and the histogram contraction read
    w2 in this layout (row ``b0 * 256 + b1``). For gram_lengths == (1,) w2
    is zeros. Call once per profile."""
    w = torch.as_tensor(weights).to(torch.float32)
    w1 = w[:256].contiguous()
    if 2 in spec.gram_lengths:
        off = spec.offsets[2]
        w2 = w[off : off + 65536].contiguous()
    else:
        w2 = torch.zeros((65536, w.shape[1]), dtype=torch.float32, device=w.device)
    return w1, w2


def _windows(batch: torch.Tensor, start: int, stop: int):
    """(first byte, next byte, start index) of the windows in [start, stop):
    int64 [B, n] planes; the next byte past the padded width is 0."""
    stop = min(stop, batch.shape[1])
    b0 = batch[:, start:stop].long()
    nxt = batch[:, start + 1 : stop + 1]
    b1 = torch.nn.functional.pad(nxt, (0, b0.shape[1] - nxt.shape[1]))
    s = torch.arange(start, stop, device=batch.device)[None, :]
    return b0, b1.long(), s


# ---------------------------------------------------- bigram histogram -----


def bigram_hist_plain(
    batch: torch.Tensor, lengths: torch.Tensor, lim: torch.Tensor, mask_n: int
) -> torch.Tensor:
    """Plain PyTorch version of the bigram-histogram kernel: float32
    [B, 65536] counts of (byte, next byte) over window starts s <= len -
    mask_n and s < lim."""
    B, S = batch.shape
    b0, b1, s = _windows(batch, 0, S)
    mask = (s <= lengths.long()[:, None] - mask_n) & (s < lim.long()[:, None])
    doc = torch.arange(B, device=batch.device)[:, None]
    idx = (doc * 65536 + b0 * 256 + b1)[mask]
    return torch.bincount(idx, minlength=B * 65536).reshape(B, 65536).to(torch.float32)


def bigram_hist_kernel(
    batch: torch.Tensor, lengths: torch.Tensor, lim: torch.Tensor, mask_n: int
) -> torch.Tensor:
    """Launch ``csrc/bigram_hist.cu`` on the current CUDA stream (no
    synchronisation). Same inputs and output as :func:`bigram_hist_plain`."""
    dev = batch.device
    if dev.type != "cuda":
        raise ValueError(f"bigram_hist kernel needs CUDA tensors, got {dev}")
    check_operand("bigram_hist kernel", batch, "batch", torch.uint8, 2, dev)
    check_operand("bigram_hist kernel", lengths, "lengths", torch.int32, 1, dev)
    check_operand("bigram_hist kernel", lim, "lim", torch.int32, 1, dev)
    B, S = batch.shape
    if lengths.shape[0] != B or lim.shape[0] != B or mask_n not in (1, 2):
        raise ValueError("bigram_hist kernel: per-document operands or mask_n disagree")
    out = torch.empty((B, 65536), dtype=torch.float32, device=dev)
    if B == 0 or S == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        BIGRAM_HIST.launch(
            batch.data_ptr(), lengths.data_ptr(), lim.data_ptr(), out.data_ptr(),
            B, S, mask_n, torch.cuda.current_stream(dev).cuda_stream,
        )
    return out


def bigram_hist(
    batch: torch.Tensor, lengths: torch.Tensor, lim: torch.Tensor, mask_n: int
) -> torch.Tensor:
    """The wrapper: the plain version for tensors on the CPU, the CUDA
    kernel for tensors on the card (it raises rather than fall back)."""
    if batch.device.type == "cpu":
        return bigram_hist_plain(batch, lengths, lim, mask_n)
    return bigram_hist_kernel(batch, lengths, lim, mask_n)


# ------------------------------------------------------- bigram score -----


def bigram_score_plain(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    lim: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    has1: bool,
    has2: bool,
) -> torch.Tensor:
    """Plain PyTorch version of the bigram-score kernel: float32 [B, L] sums
    of w2[byte*256 + next] over starts s <= len-2 (if has2) and of w1[byte]
    over starts s <= len-1 (if has1), both only where s < lim."""
    B, S = batch.shape
    acc = torch.zeros((B, w1.shape[1]), dtype=torch.float32, device=batch.device)
    len64 = lengths.long()[:, None]
    lim64 = lim.long()[:, None]
    for start in range(0, S, DEFAULT_BLOCK):
        b0, b1, s = _windows(batch, start, start + DEFAULT_BLOCK)
        owned = s < lim64
        if has2:
            m2 = (s <= len64 - 2) & owned
            acc += (w2[b0 * 256 + b1] * m2[..., None]).sum(dim=1)
        if has1:
            m1 = (s <= len64 - 1) & owned
            acc += (w1[b0] * m1[..., None]).sum(dim=1)
    return acc


def bigram_score_kernel(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    lim: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    has1: bool,
    has2: bool,
) -> torch.Tensor:
    """Launch ``csrc/bigram_score.cu`` on the current CUDA stream (no
    synchronisation). Same inputs and output as :func:`bigram_score_plain`."""
    dev = batch.device
    if dev.type != "cuda":
        raise ValueError(f"bigram_score kernel needs CUDA tensors, got {dev}")
    name = "bigram_score kernel"
    check_operand(name, batch, "batch", torch.uint8, 2, dev)
    check_operand(name, lengths, "lengths", torch.int32, 1, dev)
    check_operand(name, lim, "lim", torch.int32, 1, dev)
    check_operand(name, w1, "w1", torch.float32, 2, dev)
    check_operand(name, w2, "w2", torch.float32, 2, dev)
    B, S = batch.shape
    L = w1.shape[1]
    if tuple(w1.shape) != (256, L) or tuple(w2.shape) != (65536, L):
        raise ValueError(
            f"{name}: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} must be "
            f"[256, L] / [65536, L]"
        )
    if not 1 <= L <= MAX_PALLAS_LANGS:
        raise ValueError(f"{name} takes 1..{MAX_PALLAS_LANGS} languages, got {L}")
    if lengths.shape[0] != B or lim.shape[0] != B:
        raise ValueError(f"{name}: per-document operands disagree with the batch")
    out = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B == 0 or S == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        BIGRAM_SCORE.launch(
            batch.data_ptr(), lengths.data_ptr(), lim.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), out.data_ptr(), B, S, L, int(has1), int(has2),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return out


def bigram_score(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    lim: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    has1: bool,
    has2: bool,
) -> torch.Tensor:
    """The wrapper: the plain version for tensors on the CPU, the CUDA
    kernel for tensors on the card (it raises rather than fall back)."""
    if batch.device.type == "cpu":
        return bigram_score_plain(batch, lengths, lim, w1, w2, has1, has2)
    return bigram_score_kernel(batch, lengths, lim, w1, w2, has1, has2)


# ------------------------------------------------------------- scoring ----


def _score_from_hist(
    hist: torch.Tensor,
    batch: torch.Tensor,
    lengths: torch.Tensor,
    lim: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    has1: bool,
    has2: bool,
) -> torch.Tensor:
    """[B, 65536] bigram histograms → float32 [B, L] scores (float64
    contraction). The unigram histogram is the histogram's row sum plus the
    last byte's n=1 window (start len-1 passes the n=1 mask but not the
    bigram mask) when this chunk owns that start."""
    B = hist.shape[0]
    h = hist.to(torch.float64)
    scores = torch.zeros((B, w1.shape[1]), dtype=torch.float64, device=hist.device)
    if has2:
        scores += torch.matmul(h, w2.to(torch.float64))
    if has1:
        h1 = h.reshape(B, 256, 256).sum(dim=2)
        if has2:
            len64 = lengths.long()
            last = batch[
                torch.arange(B, device=batch.device),
                (len64 - 1).clamp(0, batch.shape[1] - 1),
            ].long()
            ok = (len64 >= 1) & (len64 - 1 < lim.long())
            h1 += torch.nn.functional.one_hot(last, 256) * ok[:, None]
        scores += torch.matmul(h1, w1.to(torch.float64))
    return scores.to(torch.float32)


def score_batch_pallas(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    window_limit: torch.Tensor | None = None,
    *,
    spec: VocabSpec,
) -> torch.Tensor:
    """float32 [B, L] scores for a padded uint8 batch of an exact vocab with
    gram lengths ⊆ {1, 2}; ``w1``/``w2`` from :func:`weight_views`. Up to
    MAX_PALLAS_LANGS languages run :func:`bigram_score`, more run
    :func:`bigram_hist` and a matmul."""
    if spec.mode != EXACT or max(spec.gram_lengths) > 2:
        raise ValueError(
            "score_batch_pallas supports exact-mode vocabularies with gram "
            f"lengths <= 2 only; got mode={spec.mode!r} "
            f"gram_lengths={spec.gram_lengths!r}"
        )
    has1 = 1 in spec.gram_lengths
    has2 = 2 in spec.gram_lengths
    B, S = batch.shape
    batch = batch.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    lim = (
        torch.full((B,), S, dtype=torch.int32, device=batch.device)
        if window_limit is None
        else window_limit.to(torch.int32).contiguous()
    )
    if w1.shape[1] > MAX_PALLAS_LANGS:
        hist = bigram_hist(batch, lengths, lim, 2 if has2 else 1)
        out = _score_from_hist(hist, batch, lengths, lim, w1, w2, has1, has2)
    else:
        out = bigram_score(batch, lengths, lim, w1, w2, has1, has2)
    if has2:
        # Partial-window rule: a 1-byte document under gram length 2
        # contributes its single byte once, in the length-1 id space.
        # Chunking never produces 1-byte rows, so the limit cannot apply.
        out = out + torch.where((lengths == 1)[:, None], w1[batch[:, 0].long()], 0.0)
    return out
