"""Scoring and fit over a mesh of ranks.

Port of ``spark_languagedetector_tpu.parallel.sharded``. The JAX package
annotates shardings and lets GSPMD insert the collectives; here every rank
runs the single-device ops on its own part and calls the collectives of
:class:`~.mesh.Mesh` itself, in one order on every rank:

* **scoring** (:func:`make_sharded_scorer`): the batch splits over
  ``data``; the weight table is replicated, or striped by rows over
  ``vocab`` (:func:`stripe_operands`). With a striped table a vocab rank
  looks up the windows whose ids fall in its stripe and adds zero for the
  others (a LUT over the id space whose misses hit a zeros row), and a
  ``psum`` over the vocab line gives the full sum. Every rank returns the
  whole batch (an ``all_gather`` over ``data``).
* **fit** (:func:`make_sharded_fit_step`): counts are integer sums, so each
  rank counts its batch shard into its own int32 ``[V, L]`` table, and the
  tables are reduced once, at the finalize (:func:`reduce_counts`), not at
  every step: a reduce-scatter over the table axis gives each rank its
  stripe of the summed counts. The rank's own table is never overwritten
  by the reduction, so a finalize never folds the same counts in twice,
  and an incremental accumulator may update and finalize again.
* **finalize** (:func:`make_sharded_finalize_topk`): each rank weights its
  stripe and takes its local top-k with global ids, one ``all_gather`` over
  the table axis concatenates the candidates, and the boundary plateau is
  re-ranked by the candidates' real ids, so ties keep the single-device
  fit's lowest-id order across any stripe boundary.

The JAX package stripes the fit table only when ``jax.process_count() ==
1``, because of how XLA schedules collectives across processes. The port
has no such schedule: its ranks take the place of JAX's devices, and every
rank issues the same collectives in the same order, so the table is
striped whenever V divides by the shard count.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

from ..ops import fit_tpu
from ..ops.score import DEFAULT_BLOCK, score_batch
from ..ops.vocab import VocabSpec
from ..resilience import faults
from ..telemetry import span
from .mesh import DATA_AXIS, VOCAB_AXIS, Mesh, table_axis, table_shards


def _on(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def stripe_operands(mesh: Mesh, weights) -> tuple[torch.Tensor, torch.Tensor]:
    """This vocab rank's stripe of a dense ``[V, L]`` table as gather
    operands: ``(table [V/n + 1, L], lut int32 [V])``, the stripe's rows
    plus a zeros miss row, and an id → row map that sends every id outside
    the stripe to the miss row."""
    n = mesh.shape[VOCAB_AXIS]
    V = int(weights.shape[0])
    if V % n:
        raise ValueError(f"a {V}-row table does not stripe over vocab={n}")
    rows = V // n
    off = mesh.coord(VOCAB_AXIS) * rows
    w = _on(weights, mesh.device, torch.float32)
    table = torch.cat([w[off : off + rows], w.new_zeros((1, w.shape[1]))])
    ids = torch.arange(V, device=mesh.device)
    lut = torch.where((ids >= off) & (ids < off + rows), ids - off, rows).to(torch.int32)
    return table, lut


def striped_scores(mesh: Mesh, batch, lengths, table, lut, *, spec: VocabSpec,
                   block: int = DEFAULT_BLOCK, window_limit=None) -> torch.Tensor:
    """Scores of a batch against a vocab-striped table: each rank's stripe
    through the LUT gather, then a ``psum`` over the vocab line."""
    part = score_batch(batch, lengths, table, lut, spec=spec, block=block,
                       window_limit=window_limit)
    return mesh.psum(part, VOCAB_AXIS)


def make_sharded_scorer(
    mesh: Mesh,
    spec: VocabSpec,
    *,
    shard_vocab: bool = False,
    block: int = DEFAULT_BLOCK,
):
    """Scorer over the mesh: ``fn(batch [B,S] u8, lengths [B] i32, weights,
    lut|None) -> scores [B, L] f32`` on every rank, with B divisible by the
    data-axis size. ``weights`` is the dense ``[V, L]`` table (``lut``
    None; stripes over ``vocab`` with ``shard_vocab``) or the compact
    ``[G+1, L]`` table with its int32 id→row ``lut`` (replicated)."""
    ndata = int(mesh.shape[DATA_AXIS])
    steps = itertools.count()

    def scorer(batch, lengths, weights, lut=None):
        dev = mesh.device
        b = mesh.shard_rows(_on(batch, dev, torch.uint8))
        ln = mesh.shard_rows(_on(lengths, dev, torch.int32))
        with span("shard_score", shards=ndata, rows_per_shard=int(b.shape[0]),
                  step=next(steps)) as sp:
            if shard_vocab:
                if lut is not None:
                    raise ValueError("only the dense table stripes over vocab")
                table, slut = stripe_operands(mesh, weights)
                local = striped_scores(mesh, b, ln, table, slut, spec=spec, block=block)
            else:
                local = score_batch(
                    b, ln, _on(weights, dev, torch.float32),
                    None if lut is None else _on(lut, dev), spec=spec, block=block,
                )
            out = mesh.all_gather(local, DATA_AXIS)
            sp.fence(out)
        return out

    return scorer


def make_sharded_fit_step(mesh: Mesh, spec: VocabSpec, num_langs: int):
    """Distributed fit accumulation step.

    ``fn(batch [B,S], lengths [B], lang_ids [B], counts_acc [V, L],
    mult=None, *, presharded=False) -> counts_acc``: the rank counts its
    data shard of the batch (the whole batch it was given when
    ``presharded``) into ``counts_acc``, its own table, in place. No
    collective runs here: :func:`reduce_counts` sums the ranks' tables at
    the finalize, which also decides whether the sum stripes (JAX's
    ``shard_table`` switch of the step has no counterpart).

    The ``shard_step`` fault site fires before anything else, as in JAX:
    every rank running the same plan fails the same step together.
    """
    ndata = int(mesh.shape[DATA_AXIS])
    steps = itertools.count()

    def step(batch, lengths, lang_ids, counts_acc, mult=None, *, presharded: bool = False):
        faults.inject("shard_step")
        dev = counts_acc.device
        parts = [_on(batch, dev, torch.uint8), _on(lengths, dev, torch.int32),
                 _on(lang_ids, dev, torch.int32)]
        if mult is not None:
            parts.append(_on(mult, dev, torch.int32))
        if not presharded:
            parts = [mesh.shard_rows(p) for p in parts]
        b = parts[0]
        with span("shard_step", shards=ndata, rows_per_shard=int(b.shape[0]),
                  step=next(steps)) as sp:
            out = fit_tpu.fit_dense_step(
                *parts[:3], counts_acc, parts[3] if mult is not None else None,
                spec=spec, num_langs=num_langs,
            )
            sp.fence(out)
        return out

    return step


def table_is_sharded(mesh: Mesh, vocab_size: int) -> bool:
    """Whether a ``[V, L]`` table stripes over the mesh's table axis: more
    than one shard, and V divisible by their count (else the unsharded
    finalize runs, as in JAX)."""
    n = table_shards(mesh)
    return n > 1 and vocab_size % n == 0


def reduce_counts(mesh: Mesh, local: torch.Tensor, *, table_sharded: bool) -> torch.Tensor:
    """The ranks' count tables summed, as a new tensor (``local`` is left
    as it is): this rank's stripe ``[V/n, L]`` of the table axis when
    ``table_sharded``, else the whole table.

    The data axis carries the batch shards; ranks of one vocab line counted
    the same shard. With the data axis as table axis, one reduce-scatter
    over it; with a vocab table axis, a ``psum`` over the data line, then
    the vocab coordinate's stripe."""
    ax = table_axis(mesh)
    if table_sharded and ax == DATA_AXIS:
        return mesh.reduce_scatter(local, DATA_AXIS)
    total = mesh.psum(local, DATA_AXIS)
    if not table_sharded:
        return total
    rows = total.shape[0] // mesh.shape[VOCAB_AXIS]
    off = mesh.coord(VOCAB_AXIS) * rows
    return total[off : off + rows].clone()


def stripe_offset(mesh: Mesh, stripe_rows: int) -> int:
    """First global row of this rank's stripe of the table axis."""
    return mesh.coord(table_axis(mesh)) * stripe_rows


def shard_topk_candidates(masked: torch.Tensor, k: int, id_offset: int, *,
                          block: int = fit_tpu.TOPK_BLOCK):
    """One stripe's top-k candidates (values [L, k], global ids [L, k])
    under the (value desc, id asc) order; a stripe wider than ``block``
    walks in blocks, as :func:`..ops.fit_tpu.top_k_rows_blocked` does."""
    wT = masked.T
    Vs = wT.shape[1]
    if Vs <= block:
        return fit_tpu._block_top_k(wT, k, id_offset)
    cand = [
        fit_tpu._block_top_k(wT[:, s : s + block], min(k, wT[:, s : s + block].shape[1]),
                             id_offset + s)
        for s in range(0, Vs, block)
    ]
    cv = torch.cat([c[0] for c in cand], dim=1)
    ci = torch.cat([c[1] for c in cand], dim=1)
    return fit_tpu._candidates_top_k(cv, ci, k)


def make_sharded_finalize(
    mesh: Mesh,
    *,
    profile_size: int,
    weight_mode: str = "parity",
    shard_vocab: bool = True,
):
    """Full-table finalize: a rank's own counts ``[V, L]`` → (weights
    ``[V, L]``, top-k row ids ``[L, k]``), both on every rank. The legacy
    form that materializes and returns the whole weight table (each rank
    weights its stripe, an ``all_gather`` over the table axis assembles
    it); the fit's winner-rows-only finalize is
    :func:`make_sharded_finalize_topk`."""

    def finalize(counts):
        V = int(counts.shape[0])
        sharded = shard_vocab and table_is_sharded(mesh, V)
        nshards = table_shards(mesh) if sharded else 1
        with span("shard_finalize", shards=nshards) as sp:
            reduced = reduce_counts(mesh, counts, table_sharded=sharded)
            weights = fit_tpu.weights_from_counts(reduced, weight_mode=weight_mode)
            k = min(profile_size, V)
            if sharded:
                weights = mesh.all_gather(weights, table_axis(mesh))
                top = make_sharded_finalize_topk(
                    mesh, profile_size=k, weight_mode=weight_mode
                )(reduced)
            else:
                top = fit_tpu.top_k_rows(
                    fit_tpu.masked_candidate_weights(reduced, weight_mode=weight_mode), k=k
                )
            sp.fence(weights, top)
        return weights, top

    return finalize


@lru_cache(maxsize=16)
def make_sharded_finalize_topk(
    mesh: Mesh,
    *,
    profile_size: int,
    weight_mode: str = "parity",
    block: int = fit_tpu.TOPK_BLOCK,
):
    """Distributed reduce half of the fit: this rank's stripe of the summed
    counts ``[V/n, L]`` → the per-language top-k row ids ``[L, k]``, the
    same on every rank:

      1. the stripe's masked candidate weights and its local top-k under
         the (value desc, id asc) order, ids lifted to global gram ids
         (:func:`shard_topk_candidates`, blocked past ``block`` rows);
      2. one ``all_gather`` over the table axis: ``n·k·L`` candidate pairs
         instead of the ``V·L`` table;
      3. the final selection re-ranks the boundary plateau by the
         candidates' real ids (``ops.fit_tpu._candidates_top_k``), so the
         merge keeps the host fit's lowest-id tie order for any stripes.

    Exact by the ``top_k_rows_blocked`` argument with blocks = stripes.
    Memoized on (mesh, k, weight_mode, block), as JAX memoizes its compiled
    program, so a refit loop reuses one finalize per live mesh.
    """
    ax = table_axis(mesh)
    nshards = table_shards(mesh)

    def topk(stripe: torch.Tensor) -> torch.Tensor:
        rows = int(stripe.shape[0])
        kk = min(profile_size, rows)
        with span("shard_finalize_topk", shards=nshards) as sp:
            masked = fit_tpu.masked_candidate_weights(stripe, weight_mode=weight_mode)
            bv, bi = shard_topk_candidates(masked, kk, mesh.coord(ax) * rows, block=block)
            # [L, k] per rank → [n·L, k] gathered → [L, n·k] in stripe order.
            L = bv.shape[0]
            cv = mesh.all_gather(bv.contiguous(), ax).reshape(nshards, L, kk)
            ci = mesh.all_gather(bi.contiguous(), ax).reshape(nshards, L, kk)
            cv = cv.permute(1, 0, 2).reshape(L, nshards * kk)
            ci = ci.permute(1, 0, 2).reshape(L, nshards * kk)
            top = fit_tpu._candidates_top_k(cv, ci, min(profile_size, rows * nshards))[1]
            sp.fence(top)
        return top

    return topk


def training_step(
    mesh: Mesh,
    spec: VocabSpec,
    num_langs: int,
    profile_size: int,
    *,
    shard_vocab: bool = True,
    weight_mode: str = "parity",
):
    """One full distributed training step: count this rank's shard, then
    the full-table finalize. ``step(batch, lengths, lang_ids, counts_acc)
    -> (this rank's counts, weights [V, L], top rows [L, k])``."""
    fit_step = make_sharded_fit_step(mesh, spec, num_langs)
    finalize = make_sharded_finalize(
        mesh, profile_size=profile_size, weight_mode=weight_mode,
        shard_vocab=shard_vocab,
    )

    def step(batch, lengths, lang_ids, counts_acc):
        counts = fit_step(batch, lengths, lang_ids, counts_acc)
        weights, top_rows = finalize(counts)
        return counts, weights, top_rows

    return step
