"""Sequence parallelism: one long document spread over the mesh's data axis.

Port of ``spark_languagedetector_tpu.parallel.sequence``. A long document
becomes a [D, C] grid of overlapping chunks (overlap = max(gram_lengths) -
1, ownership through window limits, as ``ops.encoding.chunk_document``
cuts them) laid out over the ``data`` ranks; each rank scores its chunk
rows with the gather scorer (``ops.score.score_batch(window_limit=...)``)
and the document's score is the sum of the [L] partial vectors — the
bag-of-grams analog of ring attention, where the reduction is a plain sum.

Two formulations of the same sum:

  * :func:`score_long_document` — one ``psum`` over the data line;
  * :func:`ring_score_chunks` — the partial [L] sums travel the ring D-1
    hops (``batch_isend_irecv``), accumulating at every stop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.encoding import chunk_document
from ..ops.score import score_batch
from ..ops.vocab import VocabSpec
from .mesh import DATA_AXIS, Mesh, pad_to_multiple


def chunk_grid(
    doc: bytes, num_shards: int, chunk_size: int, gram_lengths: tuple[int, ...]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lay one document out as [num_chunks_padded, chunk_size] rows plus
    lengths and per-row owned-window limits, padded to a multiple of
    ``num_shards`` rows so the grid shards evenly over the data axis."""
    overlap = max(gram_lengths) - 1
    parts = chunk_document(doc, chunk_size, overlap)
    stride = chunk_size - overlap
    rows = len(parts)
    padded_rows = pad_to_multiple(rows, num_shards)
    batch = np.zeros((padded_rows, chunk_size), dtype=np.uint8)
    lengths = np.zeros(padded_rows, dtype=np.int32)
    limits = np.zeros(padded_rows, dtype=np.int32)
    for i, part in enumerate(parts):
        batch[i, : len(part)] = np.frombuffer(part, dtype=np.uint8)
        lengths[i] = len(part)
        limits[i] = stride if i < rows - 1 else chunk_size
    return batch, lengths, limits


def _operand(x, device, dtype=None):
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    t = t.to(device=device, dtype=dtype or t.dtype)
    return t if t.numel() else None


def _local_sum(mesh: Mesh, batch, lengths, limits, weights, lut, spec: VocabSpec) -> torch.Tensor:
    """This rank's rows of the grid, scored and summed: f32 [L]."""
    dev = mesh.device
    b = mesh.shard_rows(_operand(batch, dev, torch.uint8))
    ln = mesh.shard_rows(_operand(lengths, dev, torch.int32))
    lim = mesh.shard_rows(_operand(limits, dev, torch.int32))
    per_chunk = score_batch(
        b, ln, _operand(weights, dev, torch.float32), _operand(lut, dev), spec=spec,
        window_limit=lim,
    )
    return per_chunk.sum(dim=0)


def make_long_doc_scorer(mesh: Mesh, spec: VocabSpec, chunk_size: int = 8192):
    """Scorer for arbitrarily long single documents:
    ``fn(doc: bytes, weights, lut|None) -> np.ndarray [L]`` on every rank."""
    n_data = mesh.shape[DATA_AXIS]

    def score(doc: bytes, weights, lut=None) -> np.ndarray:
        batch, lengths, limits = chunk_grid(doc, n_data, chunk_size, spec.gram_lengths)
        local = _local_sum(mesh, batch, lengths, limits, weights, lut, spec)
        return mesh.psum(local, DATA_AXIS).cpu().numpy()

    return score


def score_long_document(
    doc: bytes,
    weights,
    lut,
    spec: VocabSpec,
    mesh: Mesh,
    chunk_size: int = 8192,
) -> np.ndarray:
    """Exact [L] score of one document of any length, computed across the
    mesh's data axis (thin wrapper over :func:`make_long_doc_scorer`)."""
    return make_long_doc_scorer(mesh, spec, chunk_size)(doc, weights, lut)


def ring_score_chunks(
    batch,
    lengths,
    limits,
    weights,
    lut,
    spec: VocabSpec,
    mesh: Mesh,
) -> torch.Tensor:
    """The same sum as a ring: each of the D data ranks scores its chunk
    rows, then the partial [L] sums travel D-1 hops, each rank adding what
    arrives. Returns the total [L] on every rank."""
    local = _local_sum(mesh, batch, lengths, limits, weights, lut, spec)
    acc, moving = local, local
    for _ in range(mesh.shape[DATA_AXIS] - 1):
        moving = mesh.ring_shift(moving, DATA_AXIS)
        acc = acc + moving
    return acc
