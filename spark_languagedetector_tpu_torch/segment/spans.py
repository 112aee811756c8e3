"""Window votes → byte-offset spans (the host half of segmentation).

The device hands back one raw score vector per CELL (a fixed span of
window start positions — ``api.runner.SEGMENT_CELL`` bytes). This module
turns a document's cell matrix into a span list:

1. **smooth** — a box average over the cell axis widens the effective
   decision window without another device pass: per-cell n-gram votes are
   noisy exactly at the code-switch boundaries where they matter;
2. **decode** — per-cell winner (first-maximum, the reference tie rule)
   and margin (top1 − top2 of the smoothed vector), the decoder's
   confidence signal;
3. **merge** — run-length encode the winners, heal sub-``min_span`` runs
   into the neighbor with the stronger adjacent margin (a lone mis-voted
   cell inside a long run is a gap to heal, not a span), convert to byte
   offsets, and snap every interior boundary to a UTF-8 character start
   so a span never splits a multi-byte character.

Invariants: the returned
spans partition ``[0, doc_len)`` exactly — no gaps, no overlaps — every
interior boundary is a UTF-8 character start (for UTF-8 inputs), and
every span is at least ``min_span_bytes`` long unless the whole document
is shorter. Pure functions, no device work, deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Span:
    """One decoded span: byte offsets ``[start, end)``, the winning
    language index, and the mean smoothed margin of its cells (the
    pre-calibration confidence signal; calibrated probabilities are
    attached by :mod:`.api`)."""

    start: int
    end: int
    lang_id: int
    margin: float


def smooth_cells(cells: np.ndarray, width: int) -> np.ndarray:
    """Box average over the cell axis: float64 [C, L] → [C, L].

    ``width`` is the full window in cells (values < 2 are the identity);
    edges average over the clipped window, so every output row is a true
    mean of real cells. Deterministic float64 — the decoder's argmax must
    not depend on summation order.
    """
    cells = np.asarray(cells, dtype=np.float64)
    if width < 2 or cells.shape[0] < 2:
        return cells
    half = width // 2
    csum = np.cumsum(cells, axis=0, dtype=np.float64)
    csum = np.concatenate([np.zeros((1, cells.shape[1])), csum], axis=0)
    C = cells.shape[0]
    lo = np.maximum(np.arange(C) - half, 0)
    hi = np.minimum(np.arange(C) + half + 1, C)
    return (csum[hi] - csum[lo]) / (hi - lo)[:, None]


def decode_cells(smoothed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(winners int64 [C], margins float64 [C]) of a smoothed cell matrix.

    Winner = first maximum (reference tie behavior); margin = top1 − top2
    (0.0 for single-language models)."""
    winners = np.argmax(smoothed, axis=1)
    if smoothed.shape[1] < 2:
        return winners, np.zeros(smoothed.shape[0], dtype=np.float64)
    part = -np.partition(-smoothed, 1, axis=1)
    return winners, (part[:, 0] - part[:, 1]).astype(np.float64)


def snap_utf8(doc: bytes, pos: int) -> int:
    """Largest p ≤ pos that is a UTF-8 character start (continuation
    bytes 0b10xxxxxx back the boundary off; at most 3 steps for valid
    UTF-8, capped at 4 so arbitrary bytes can't walk the boundary far)."""
    p = pos
    steps = 0
    while 0 < p < len(doc) and (doc[p] & 0xC0) == 0x80 and steps < 4:
        p -= 1
        steps += 1
    return p


def merge_spans(
    winners: np.ndarray,
    margins: np.ndarray,
    *,
    cell: int,
    doc_len: int,
    doc: bytes,
    min_span_bytes: int,
) -> list[Span]:
    """Cell votes → byte-offset spans partitioning ``[0, doc_len)``.

    Runs shorter than ``min_span_bytes`` are healed into the neighboring
    run whose boundary-adjacent margin is stronger (smallest run first,
    so one noisy cell can't cascade); boundaries then snap to UTF-8
    character starts. A snap that empties a span drops the span (its
    bytes go to the neighbor) — the partition invariant always wins over
    span count.
    """
    if doc_len <= 0:
        return []
    n_cells = -(-doc_len // cell)
    winners = np.asarray(winners[:n_cells])
    margins = np.asarray(margins[:n_cells], dtype=np.float64)

    # Run-length encode: [cell_start, cell_end, lang_id].
    runs: list[list[int]] = []
    for c, w in enumerate(winners.tolist()):
        if runs and runs[-1][2] == w:
            runs[-1][1] = c + 1
        else:
            runs.append([c, c + 1, int(w)])

    def run_bytes(r) -> int:
        return min(r[1] * cell, doc_len) - r[0] * cell

    # Heal short runs (gap healing + min-span in one rule). Shortest
    # first: a single mis-voted cell between two long same-language runs
    # merges away and the flanks then coalesce.
    while len(runs) > 1:
        k = min(range(len(runs)), key=lambda i: (run_bytes(runs[i]), i))
        if run_bytes(runs[k]) >= min_span_bytes:
            break
        left = runs[k - 1] if k > 0 else None
        right = runs[k + 1] if k + 1 < len(runs) else None
        if left is not None and right is not None:
            # Merge toward the stronger boundary-adjacent margin.
            into_left = margins[runs[k][0] - 1] >= margins[runs[k][1]]
        else:
            into_left = right is None
        if into_left:
            left[1] = runs[k][1]
            del runs[k]
            if k < len(runs) and runs[k - 1][2] == runs[k][2]:
                runs[k - 1][1] = runs[k][1]
                del runs[k]
        else:
            right[0] = runs[k][0]
            del runs[k]
            if k > 0 and runs[k - 1][2] == runs[k][2]:
                runs[k - 1][1] = runs[k][1]
                del runs[k]

    # Cell runs → byte boundaries: run i starts at its first cell's byte
    # offset, snapped to a character start (run 0 pins to 0); run i ends
    # where run i+1 starts. A snap that empties a run drops it — its
    # bytes already belong to the neighbors — so the emitted spans always
    # partition [0, doc_len) exactly.
    starts = [0] + [
        snap_utf8(doc, min(r[0] * cell, doc_len)) for r in runs[1:]
    ]
    starts = [min(s, doc_len) for s in starts]
    spans: list[Span] = []
    for i, r in enumerate(runs):
        start = starts[i]
        end = starts[i + 1] if i + 1 < len(runs) else doc_len
        if end <= start:
            continue
        m = margins[r[0]:r[1]]
        spans.append(Span(
            start=start,
            end=end,
            lang_id=r[2],
            margin=float(m.mean()) if m.size else 0.0,
        ))
    # Adjacent spans that ended up same-language (possible after a
    # dropped boundary) merge so the output is canonical.
    merged: list[Span] = []
    for s in spans:
        if merged and merged[-1].lang_id == s.lang_id:
            prev = merged.pop()
            merged.append(Span(
                prev.start, s.end, s.lang_id,
                (prev.margin * (prev.end - prev.start)
                 + s.margin * (s.end - s.start)) / (s.end - prev.start),
            ))
        else:
            merged.append(s)
    return merged
