"""Device fit: dense gram counting, weighting and top-k in torch ops.

Port of ``spark_languagedetector_tpu.ops.fit_tpu``. Counts
accumulate in an int32 ``[V, L]`` table by ``index_put_(accumulate=True)``
(exact in any order, so the table does not depend on batching or thread
scheduling); weighting is ``log1p`` in float32; the per-language top-k is
``torch.topk`` with the boundary plateau re-ranked so that ties go to the
lowest gram id, as the host fit breaks them. ``torch.topk`` promises no
order among equal values, and parity weights take only |L|+1 values, so
the plateaus are huge: the re-rank is an integer top-k over ``-id``
restricted to the plateau (never float keys, inexact past 2^24).

Only the winners' count rows come back to the host, and their weights are
recomputed there in float64 from the exact integer counts, so the profile
is bit-identical to :func:`.fit.fit_profile_numpy`'s.

The stages record the JAX package's spans: ``fit/count`` around the count
pass (with the ``fit/count`` fault site at every count step),
``fit/finalize`` around the weighting and top-k, and ``fit/collect`` around
the winners' copy to the host, whose bytes add to the ``fit/collect_bytes``
counter and the ``langdetect_fit_collect_bytes`` gauge.

On a mesh (``mesh=``, :mod:`..parallel`), as JAX's ``device_fit_context``
sets it up: every rank plans the same batches, counts its data shard of
each into its own table (the ``shard_step`` of
:func:`..parallel.sharded.make_sharded_fit_step`), and the finalize sums
the tables once (:func:`..parallel.sharded.reduce_counts`) — into one
stripe per rank of the table axis when V divides by the shard count, and
then takes the sharded top-k (:func:`..parallel.sharded.make_sharded_finalize_topk`);
else into the whole table on every rank and the single-device top-k.
Counts added outside the batches (chunk-split straddles, the caller's
extras) go into the tables of the ranks at data coordinate 0, so the sum
holds them once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..resilience import faults
from ..telemetry import REGISTRY, span
from ..telemetry import cost
from ..utils.debug import check_finite
from ..utils.device import resolve_device
from ..utils.logging import get_logger, log_event
from .vocab import EXACT, VocabSpec, partial_window_ids, window_ids

# Beyond this many table elements the finalize walks the vocab axis in
# blocks (:func:`finalize_topk_blocked`) instead of materializing the
# masked [V, L] weights and one [L, V] top-k: config 3's exact-trigram
# table is 16.8M x 50 = 842M elements.
TOPK_SORT_BUDGET_ELEMS = 256 * 1024 * 1024
TOPK_BLOCK = 1 << 21

_log = get_logger("ops.fit_tpu")


def fit_dense_step(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    lang_ids: torch.Tensor,
    counts_acc: torch.Tensor,
    mult: torch.Tensor | None = None,
    *,
    spec: VocabSpec,
    num_langs: int,
) -> torch.Tensor:
    """One accumulation step, ``counts_acc[id, lang] += windows`` of one
    padded batch, in place (a streaming fit keeps one table on the device);
    returns ``counts_acc``.

    ``batch`` uint8 [B, S]; ``lengths``, ``lang_ids`` int32 [B]; ``mult``
    optional int32 [B] per-row multiplicity (a deduplicated row counts as
    often as its duplicates did). Full windows start at ``<= len - n``; a
    document shorter than n (and not empty) has one partial window, the
    whole document, with its id in its own length class (Scala
    ``sliding``).
    """
    if counts_acc.shape[1] != num_langs:
        raise ValueError(f"count table has {counts_acc.shape[1]} languages, not {num_langs}")
    len64 = lengths.long()
    langs = lang_ids.long()
    for n in spec.gram_lengths:
        ids = window_ids(batch, n, spec)
        starts = torch.arange(ids.shape[1], device=batch.device)[None, :]
        mask = starts <= (len64[:, None] - n)
        short = len64 < n
        ids[:, 0] = torch.where(
            short, partial_window_ids(batch, lengths, n, ids[:, 0], spec), ids[:, 0]
        )
        mask[:, 0] |= short & (len64 > 0)
        rows = ids[mask]
        cols = langs[:, None].expand_as(ids)[mask]
        if mult is None:
            vals = torch.ones(rows.shape, dtype=counts_acc.dtype, device=counts_acc.device)
        else:
            vals = mult.to(counts_acc.dtype)[:, None].expand_as(ids)[mask]
        counts_acc.index_put_((rows, cols), vals, accumulate=True)
    return counts_acc


def gram_counts_dense(
    batch: torch.Tensor,
    lengths: torch.Tensor,
    lang_ids: torch.Tensor,
    mult: torch.Tensor | None = None,
    *,
    spec: VocabSpec,
    num_langs: int,
) -> torch.Tensor:
    """int32 [V, L] window occurrence counts of one padded batch
    (V = ``spec.id_space_size``)."""
    counts = torch.zeros(
        (spec.id_space_size, num_langs), dtype=torch.int32, device=batch.device
    )
    return fit_dense_step(
        batch, lengths, lang_ids, counts, mult, spec=spec, num_langs=num_langs
    )


def weights_from_counts(counts: torch.Tensor, *, weight_mode: str = "parity") -> torch.Tensor:
    """[V, L] counts → [V, L] float32 weights.

    parity: log1p(present / #langs containing) (the reference's formula);
    counts: log1p(count / total occurrences of the gram).
    """
    if weight_mode == "parity":
        present = (counts > 0).float()
        nlangs = present.sum(dim=1, keepdim=True)
        ratio = torch.where(nlangs > 0, present / nlangs.clamp(min=1), 0.0)
    else:
        totals = counts.sum(dim=1, keepdim=True)
        ratio = torch.where(
            totals > 0, counts.float() / totals.clamp(min=1).float(), 0.0
        )
    return torch.log1p(ratio)


def masked_candidate_weights(counts: torch.Tensor, *, weight_mode: str) -> torch.Tensor:
    """[V, L] weights with the rows no language saw set to -inf (not
    candidates: the reference's table holds only grams seen in training)."""
    w = weights_from_counts(counts, weight_mode=weight_mode)
    return w.masked_fill_(~(counts.sum(dim=1) > 0)[:, None], float("-inf"))


def _block_top_k(blk: torch.Tensor, k: int, id_offset: int):
    """(values [L, k], global ids int64 [L, k]) of one vocab block [L, W]
    under the (value desc, id asc) order.

    A value top-k finds the k-th value w*; the entries above it win
    outright and fill a sorted prefix. The remaining slots take the
    plateau ``== w*`` lowest id first, from an integer top-k over ``-id``
    with non-members at the integer minimum. The plateau always has
    enough members for those slots."""
    W = blk.shape[1]
    vals, idx = torch.topk(blk, k, dim=1)
    w_star = vals[:, k - 1 : k]
    n_above = (blk > w_star).sum(dim=1, keepdim=True)
    iota = torch.arange(W, dtype=torch.int64, device=blk.device)[None, :]
    plateau_key = torch.where(
        blk == w_star, -iota, torch.iinfo(torch.int64).min
    )
    _, pidx = torch.topk(plateau_key, k, dim=1)
    j = torch.arange(k, device=blk.device)[None, :]
    shifted = (j - n_above).clamp(0, k - 1)
    rows = torch.where(j < n_above, idx, torch.gather(pidx, 1, shifted))
    return torch.gather(blk, 1, rows), rows + id_offset


def _candidates_top_k(cv: torch.Tensor, ci: torch.Tensor, k: int):
    """Top-k over (value, real id) candidate pairs [L, C] under the (value
    desc, id asc) order: the values above the boundary, then the boundary
    plateau re-ranked by the candidates' real ids, not their positions.
    Returns (values [L, k], ids [L, k])."""
    fvals, fidx = torch.topk(cv, k, dim=1)
    w_star = fvals[:, k - 1 : k]
    n_above = (cv > w_star).sum(dim=1, keepdim=True)
    plateau_key = torch.where(cv == w_star, -ci, torch.iinfo(torch.int64).min)
    pvals, _ = torch.topk(plateau_key, k, dim=1)
    # Slots past the plateau's size are never selected (see
    # top_k_rows_blocked), so their wrapped negation does not matter.
    plateau_ids = -pvals
    j = torch.arange(k, device=cv.device)[None, :]
    shifted = (j - n_above).clamp(0, k - 1)
    ids = torch.where(
        j < n_above, torch.gather(ci, 1, fidx), torch.gather(plateau_ids, 1, shifted)
    )
    vals = torch.where(j < n_above, fvals, w_star.expand_as(fvals))
    return vals, ids


def top_k_rows(weights: torch.Tensor, *, k: int) -> torch.Tensor:
    """Per-language top-k row indices over a [V, L] table: int64 [L, k],
    ties to the lowest row (:func:`_block_top_k` over one block)."""
    return _block_top_k(weights.T, k, 0)[1]


def top_k_rows_blocked(
    weights: torch.Tensor, *, k: int, block: int = TOPK_BLOCK
) -> torch.Tensor:
    """Two-stage top-k over the vocab axis: per-block winners under the
    (value desc, id asc) order, then a selection over the candidates.

    Exact: a member of the global top-k has at most k-1 entries ahead of it
    in the order, so at most k-1 in its block, and survives its block's
    top-k; a block's plateau share (lowest ids first) covers what the
    global selection needs from it.
    """
    wT = weights.T
    V = wT.shape[1]
    if V <= block:
        return top_k_rows(weights, k=k)
    cand = [
        _block_top_k(wT[:, s : s + block], min(k, wT[:, s : s + block].shape[1]), s)
        for s in range(0, V, block)
    ]
    cv = torch.cat([c[0] for c in cand], dim=1)
    ci = torch.cat([c[1] for c in cand], dim=1)
    return _candidates_top_k(cv, ci, k)[1]


def finalize_topk_blocked(
    counts: torch.Tensor, *, weight_mode: str, k: int, block: int = TOPK_BLOCK
) -> torch.Tensor:
    """Count table → top-k rows [L, k] without the full [V, L] weight
    table: block by block along the vocab axis, each block's weights and
    candidate mask from its count slice, its top-k kept; then one selection
    over the candidates.

    The tail block slides back to stay in bounds (no padded copy of the
    table): the lanes it re-reads from its predecessor mask to -inf and
    take the sentinel id V. A -inf candidate surfaces only for a language
    with fewer than k seen grams, and the caller drops ids >= V and unseen
    rows, so the profile is unaffected.
    """
    V = counts.shape[0]
    block = min(block, V)
    lane = torch.arange(block, device=counts.device)
    cand_v, cand_i = [], []
    for i in range(-(-V // block)):
        start = min(i * block, V - block)
        cblk = counts[start : start + block]
        w = weights_from_counts(cblk, weight_mode=weight_mode)
        keep = (cblk.sum(dim=1) > 0) & (start + lane >= i * block)
        blk = w.masked_fill_(~keep[:, None], float("-inf")).T
        bv, bi = _block_top_k(blk, min(k, block), start)
        cand_v.append(bv)
        cand_i.append(torch.where(bi >= i * block, bi, V))
    return _candidates_top_k(torch.cat(cand_v, dim=1), torch.cat(cand_i, dim=1), k)[1]


def accumulate_counts(
    counts: torch.Tensor,
    byte_docs,
    lang_arr,
    *,
    spec: VocabSpec,
    num_langs: int,
    batch_rows: int | None = None,
    extra_counts=None,
    mesh=None,
) -> torch.Tensor:
    """One pipelined counting pass on the table's device, ``counts +=
    counts(byte_docs)``: plan, pack and copy ahead (:mod:`.fit_pipeline`),
    count each batch. The windows chunk-splitting severed and the caller's
    ``extra_counts`` (ids, langs, counts) are added once at the end. On a
    ``mesh`` every rank passes the same documents and counts its data
    shard of each batch into ``counts``, its own table (see the module
    docstring).

    The table is updated in place, so a pass that raises leaves it partly
    updated (the incremental refit's accumulator treats that as poisoned).
    """
    from .fit_pipeline import iter_device_batches, plan_fit_batches

    device = counts.device
    items, item_langs, plan, straddle, item_mult = plan_fit_batches(
        byte_docs, lang_arr, spec, batch_rows=batch_rows
    )
    if mesh is None:
        step, shards = fit_dense_step, 1
    else:
        from ..parallel.mesh import DATA_AXIS
        from ..parallel.sharded import make_sharded_fit_step

        sharded = make_sharded_fit_step(mesh, spec, num_langs)
        shards = int(mesh.shape[DATA_AXIS])

        def step(batch, lengths, langs, acc, mult, **_):
            return sharded(batch, lengths, langs, acc, mult, presharded=True)

    with span(
        "fit/count", docs=len(byte_docs), backend="device", shards=shards,
        batches=len(plan),
    ) as count_span:
        batches = iter_device_batches(
            items, item_langs, plan, item_mult=item_mult, device=device, mesh=mesh
        )
        # The loop's real step shapes, for the count pass's cost gauges.
        step_shapes: dict[tuple[int, int], int] = {}
        try:
            for batch, lengths, langs, mult, _, _ in batches:
                faults.inject("fit/count")  # chaos: one call per count step
                counts = step(
                    batch, lengths, langs, counts, mult, spec=spec, num_langs=num_langs
                )
                shape = (int(batch.shape[0]), int(batch.shape[1]))
                step_shapes[shape] = step_shapes.get(shape, 0) + 1
        finally:
            # A failed step stops the packer before the error leaves, so a
            # replay of the fit starts from a clean slate.
            batches.close()
        count_span.fence(counts)
    cost.record_fit_count_cost(spec, num_langs, step_shapes, platform=device.type)
    extras = [e for e in (straddle, extra_counts) if e is not None]
    if mesh is not None and mesh.coord("data") != 0:
        extras = []
    if extras:
        e_ids, e_langs, e_counts = (
            torch.from_numpy(np.concatenate([np.asarray(e[c], dtype=np.int64) for e in extras]))
            for c in range(3)
        )
        if e_ids.numel():
            counts.index_put_(
                (e_ids.to(device), e_langs.to(device)),
                e_counts.to(device=device, dtype=counts.dtype),
                accumulate=True,
            )
    return counts


def finalize_counts(
    counts: torch.Tensor,
    *,
    num_langs: int,
    profile_size: int,
    weight_mode: str = "parity",
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Count table → (sorted gram ids [G], float64 weights [G, L]).

    Weighting and the per-language top-k run on the table's device (the
    blocked walk past :data:`TOPK_SORT_BUDGET_ELEMS` elements); only the
    winners' ids and int32 count rows cross to the host, where their
    weights are recomputed in float64 exactly as the host fit computes
    them. The bytes that cross (the ``[L, k]`` winner ids and the winners'
    count rows, not the ``V·L·4`` table) add to the ``fit/collect_bytes``
    counter and set the ``langdetect_fit_collect_bytes`` gauge.

    On a ``mesh`` ``counts`` is this rank's own table; the ranks' tables
    are summed into new tensors first (the module docstring), so ``counts``
    keeps only this rank's counts and a later finalize sums them again.
    The winners' count rows come from the stripes that hold them, summed
    over the table axis; every rank returns the same profile.
    """
    V = int(counts.shape[0])
    k = min(profile_size, V)
    sharded, nshards, table = False, 1, counts
    if mesh is not None:
        from ..parallel import sharded as sharded_ops
        from ..parallel.mesh import table_axis, table_shards

        sharded = sharded_ops.table_is_sharded(mesh, V)
        nshards = table_shards(mesh) if sharded else 1
        table = sharded_ops.reduce_counts(mesh, counts, table_sharded=sharded)
    with span("fit/finalize", backend="device", k=k, vocab=V, shards=nshards) as fin_span:
        if sharded:
            top = sharded_ops.make_sharded_finalize_topk(
                mesh, profile_size=k, weight_mode=weight_mode
            )(table)
        elif V * num_langs > TOPK_SORT_BUDGET_ELEMS:
            top = finalize_topk_blocked(table, weight_mode=weight_mode, k=k)
        else:
            top = top_k_rows(masked_candidate_weights(table, weight_mode=weight_mode), k=k)
        fin_span.fence(top)
    top_np = np.unique(top.cpu().numpy().reshape(-1))
    top_np = top_np[top_np < V]  # blocked-walk sentinels
    with span("fit/collect", winners=int(top_np.size)) as col_span:
        sel = torch.from_numpy(top_np).to(table.device)
        if sharded:
            # Each rank fills the winners its stripe holds; the sum over
            # the table axis assembles every row.
            rows_per = int(table.shape[0])
            off = sharded_ops.stripe_offset(mesh, rows_per)
            mine = (sel >= off) & (sel < off + rows_per)
            part = torch.zeros((len(top_np), num_langs), dtype=table.dtype,
                               device=table.device)
            part[mine] = table[sel[mine] - off]
            counts_sel_dev = mesh.psum(part, table_axis(mesh))
        else:
            counts_sel_dev = table[sel]
        counts_sel = counts_sel_dev.cpu().numpy().astype(np.int64)
        collect_bytes = (
            top.numel() * top.element_size()
            + counts_sel_dev.numel() * counts_sel_dev.element_size()
        )
        col_span.set(bytes=collect_bytes, table_bytes=V * num_langs * 4)
        REGISTRY.incr("fit/collect_bytes", collect_bytes)
        REGISTRY.set_gauge(
            "langdetect_fit_collect_bytes", float(collect_bytes), program="fit/collect"
        )
        occurred = counts_sel.sum(axis=1) > 0
        rows = top_np[occurred]  # dense row index == gram id
        counts_rows = counts_sel[occurred]
        if weight_mode == "parity":
            present = counts_rows > 0
            nlangs = present.sum(axis=1, keepdims=True)
            ratio = np.where(present, 1.0 / np.maximum(nlangs, 1), 0.0)
        else:
            totals = counts_rows.sum(axis=1, keepdims=True)
            ratio = counts_rows / np.maximum(totals, 1)
        weights = np.log1p(ratio.astype(np.float64))
    check_finite([weights], "fitted weight table")
    return rows.astype(np.int64), weights


def fit_profile_device(
    byte_docs,
    lang_indices,
    num_langs: int,
    spec: VocabSpec,
    profile_size: int,
    weight_mode: str = "parity",
    batch_rows: int | None = None,
    extra_counts=None,
    device=None,
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Full device fit on ``device`` (None ⇒ the CUDA card), or over
    ``mesh`` on its ranks' devices: (sorted gram ids [G], float64 weights
    [G, L]), bit-identical to the host fit.

    Counts are int32 on the device, exact up to 2^31-1 occurrences per
    (gram, language). The top-k selection runs at float32 precision, which
    can pick another winner only where two grams' weights differ by less
    than one f32 ulp ('counts' mode; parity weights take |L|+1 values).
    ``extra_counts`` (ids, langs, counts) are added to the table once.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    counts = torch.zeros((spec.id_space_size, num_langs), dtype=torch.int32, device=dev)
    counts = accumulate_counts(
        counts, byte_docs, np.asarray(lang_indices, dtype=np.int32),
        spec=spec, num_langs=num_langs, batch_rows=batch_rows,
        extra_counts=extra_counts, mesh=mesh,
    )
    return finalize_counts(
        counts, num_langs=num_langs, profile_size=profile_size,
        weight_mode=weight_mode, mesh=mesh,
    )


def fit_profile_device_split(
    byte_docs,
    lang_indices,
    num_langs: int,
    spec: VocabSpec,
    profile_size: int,
    weight_mode: str = "parity",
    batch_rows: int | None = None,
    device=None,
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Device fit for exact vocabs with gram lengths > 3 (on ``device``, or
    the low part over ``mesh``).

    No dense table holds the 256^4..256^5 id space, so the counts split by
    the resulting gram's length (a 2-byte document's partial window for
    n = 5 is a 2-gram): grams of length <= 3 are counted by the device fit
    over the (1..3) sub-spec (whose ids equal the full spec's), with short
    documents' partial windows of the long classes added as extra counts;
    grams of length >= 4 by the exact host path. A gram's weight depends
    only on its own counts, so each part weights exactly, and the profile
    is the joint per-language top-k over both parts' top-k. With no gram
    length <= 3 there is nothing to count on the device: the whole fit runs
    on the host (as in the JAX package), and an event says so.
    """
    from . import fit as fit_ops

    low_lengths = tuple(n for n in spec.gram_lengths if n <= 3)
    long_lengths = tuple(n for n in spec.gram_lengths if n > 3)
    if not long_lengths:
        raise ValueError("split fit is for specs with gram lengths > 3")
    if not low_lengths:
        log_event(_log, "fit/device_split_all_host", gram_lengths=list(spec.gram_lengths))
        return fit_ops.fit_profile_numpy(
            byte_docs, lang_indices, num_langs, spec, profile_size, weight_mode
        )
    spec_low = VocabSpec(EXACT, low_lengths)
    lang_arr = np.asarray(lang_indices, dtype=np.int64)
    corr: dict[tuple[int, int], int] = {}
    for doc, lang in zip(byte_docs, lang_arr):
        n_doc = len(doc)
        if 0 < n_doc <= 3:
            reps = sum(1 for n in long_lengths if n > n_doc)
            if reps:
                key = (spec_low.gram_to_id(bytes(doc)), int(lang))
                corr[key] = corr.get(key, 0) + reps
    extra = None
    if corr:
        e = np.asarray([(i, l, c) for (i, l), c in corr.items()], dtype=np.int64)
        extra = (e[:, 0], e[:, 1], e[:, 2])
    ids_low, w_low = fit_profile_device(
        byte_docs, lang_arr, num_langs, spec_low, profile_size, weight_mode,
        batch_rows=batch_rows, extra_counts=extra, device=device, mesh=mesh,
    )
    gc = fit_ops.extract_gram_counts(
        byte_docs, lang_arr, num_langs, spec,
        gram_lengths_subset=long_lengths, min_partial_gram_len=4,
    )
    ids_high, w_high = fit_ops.select_top_grams(
        *fit_ops.compute_weights(gc, weight_mode), profile_size
    )
    ids, weights = fit_ops.select_top_grams(
        np.concatenate([ids_low, ids_high]),
        np.concatenate([w_low, w_high]),
        profile_size,
    )
    order = np.argsort(ids)
    return ids[order], np.ascontiguousarray(weights[order])
