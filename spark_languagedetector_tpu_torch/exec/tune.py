"""Offline shape autotuner: replay a telemetry capture, emit a profile.

Port of ``spark_languagedetector_tpu.exec.tune``: the same capture and the
same constraints give the same :class:`~.profile.TuningProfile` in both
packages, content ``version`` included, and either package's capture
tunes in either::

    python -m spark_languagedetector_tpu_torch.exec.tune telemetry.jsonl \
        [-o profile.json] [--max-shapes N] [--min-width 128] \
        [--max-batch-ms MS] [--p99-ms MS]

A runner pays for the padded shapes it dispatches, so its throughput
turns on how well the planner fills a small set of bucket widths. The
capture already holds the signals; this turns them into the measured
defaults a runner, stream or server loads at startup
(``LANGDETECT_TUNING_PROFILE``):

  * **length buckets**: the chunk-length distribution (``exec/len/<edge>``
    counters, 64-byte bins) solved exactly by dynamic programming: at most
    ``--max-shapes`` widths, multiples of 128 (the packers' ragged chunk),
    minimizing total padded bytes. The built-in top bucket, the chunking
    boundary, keeps its slot.
  * **byte budgets**: under ``--max-batch-ms``, the measured wire rate
    (real bytes over the batch latency) bounds the per-transfer budget;
    without it the budgets keep their defaults.
  * **serve flush window and rows**: from the observed arrival rate and
    coalescing distribution, the window below half of ``--p99-ms``.
  * **serve cache** and **device encode**: only where the capture proves
    duplicate mass or a padding tax.

Deterministic: the version hashes the tuned values, and ``created`` is the
capture's last event timestamp, not the wall clock.
"""

from __future__ import annotations

import sys

from ..telemetry.report import load_events
from .profile import TuningProfile, content_version

LEN_BIN_PREFIX = "exec/len/"
LEN_BIN = 64  # recording granularity (api.runner); widths align to 128
WIDTH_ALIGN = 128
DEFAULT_MAX_SHAPES = 11  # len(DEFAULT_LENGTH_BUCKETS): no more shapes than today
DEFAULT_MIN_WIDTH = 128
SERVE_WAIT_FLOOR_MS = 1.0
SERVE_WAIT_CAP_MS = 50.0


# ------------------------------------------------------------- signals ------
def capture_signals(events: list[dict]) -> dict:
    """The tuner's view of one capture: last-snapshot counters and
    histograms, plus the event timestamp range (arrival rates)."""
    counters: dict = {}
    hists: dict = {}
    ts_min = ts_max = None
    for ev in events:
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            ts_min = ts if ts_min is None else min(ts_min, ts)
            ts_max = ts if ts_max is None else max(ts_max, ts)
        if ev.get("event") != "telemetry.snapshot":
            continue
        c = ev.get("counters")
        if isinstance(c, dict):
            counters = c
        h = ev.get("histograms")
        if isinstance(h, dict):
            hists = h
    bins: dict[int, int] = {}
    for name, val in counters.items():
        if not isinstance(name, str) or not name.startswith(LEN_BIN_PREFIX):
            continue
        try:
            edge = int(name[len(LEN_BIN_PREFIX):])
        except ValueError:
            continue
        if isinstance(val, (int, float)) and val > 0:
            bins[edge] = bins.get(edge, 0) + int(val)
    return {
        "counters": counters,
        "histograms": hists,
        "len_bins": dict(sorted(bins.items())),
        "span_s": (
            max(0.0, ts_max - ts_min) if ts_min is not None else 0.0
        ),
        "events": len(events),
    }


# ------------------------------------------------------- bucket solver ------
def padded_bytes(bins: dict[int, int], buckets: list[int]) -> int:
    """Total padded bytes the lattice pays for the binned distribution
    (each item pads to the smallest bucket >= its bin's upper edge)."""
    total = 0
    bi = 0
    buckets = sorted(buckets)
    for edge in sorted(bins):
        while bi < len(buckets) and buckets[bi] < edge:
            bi += 1
        width = buckets[min(bi, len(buckets) - 1)]
        total += bins[edge] * max(width, edge if bi >= len(buckets) else 0)
    return total


def solve_buckets(
    bins: dict[int, int],
    *,
    max_shapes: int = DEFAULT_MAX_SHAPES,
    min_width: int = DEFAULT_MIN_WIDTH,
) -> list[int]:
    """Exact DP over the binned length distribution: at most ``max_shapes``
    bucket widths (multiples of :data:`WIDTH_ALIGN`, >= ``min_width``)
    minimizing total padded bytes. O(B^2 * K) over B <= ~128 candidate
    edges — milliseconds."""
    if not bins:
        raise ValueError("capture carries no exec/len/* length distribution")
    # Candidate widths: every observed bin edge rounded up to the
    # alignment (merging counts that land on the same candidate), floored
    # at min_width. The DP picks the subset; the largest candidate must be
    # chosen (something has to cover the longest item).
    merged: dict[int, int] = {}
    for edge, count in bins.items():
        width = max(-(-edge // WIDTH_ALIGN) * WIDTH_ALIGN, min_width)
        merged[width] = merged.get(width, 0) + count
    edges = sorted(merged)
    counts = [merged[e] for e in edges]
    B = len(edges)
    K = max(1, min(int(max_shapes), B))
    # prefix[i] = total count of bins[0..i)
    prefix = [0]
    for c in counts:
        prefix.append(prefix[-1] + c)
    INF = float("inf")
    # dp[j][k]: min padded bytes covering edges[0..j] with k buckets where
    # edges[j] is the widest chosen bucket so far.
    dp = [[INF] * (K + 1) for _ in range(B)]
    back = [[-1] * (K + 1) for _ in range(B)]
    for j in range(B):
        dp[j][1] = prefix[j + 1] * edges[j]
        for k in range(2, K + 1):
            for i in range(j):
                if dp[i][k - 1] == INF:
                    continue
                cost = dp[i][k - 1] + (prefix[j + 1] - prefix[i + 1]) * edges[j]
                if cost < dp[j][k]:
                    dp[j][k] = cost
                    back[j][k] = i
    best_k = min(range(1, K + 1), key=lambda k: dp[B - 1][k])
    chosen = []
    j, k = B - 1, best_k
    while j >= 0 and k >= 1:
        chosen.append(edges[j])
        j, k = back[j][k], k - 1
        if j < 0:
            break
    return sorted(chosen)


# --------------------------------------------------------- serve solver -----
def solve_serve(signals: dict, *, p99_ms: float | None) -> dict:
    """Measured serve flush parameters, or {} when the capture carries no
    serving traffic. The window targets "coalesce a typical burst to the
    row bound": rows the arrival stream delivers in the window ~= the
    per-dispatch row cap, clamped to [1, 50]ms and below half the p99
    budget (the other half pays for dispatch)."""
    hists = signals["histograms"]
    counters = signals["counters"]
    rows_h = hists.get("serve/rows_per_dispatch") or {}
    if not rows_h.get("count"):
        return {}
    # Row bound: the observed p90 coalesced size rounded up to a power of
    # two — big enough that measured traffic never truncates a flush,
    # small enough that one dispatch stays inside the compiled lattice.
    p90_rows = max(1.0, float(rows_h.get("p90") or rows_h.get("mean") or 1.0))
    max_rows = 32
    while max_rows < p90_rows and max_rows < 4096:
        max_rows *= 2
    total_rows = float(counters.get("serve/coalesced_rows") or 0.0)
    span_s = signals["span_s"]
    arrival_rows_per_s = total_rows / span_s if span_s > 0 else 0.0
    if arrival_rows_per_s > 0:
        wait_ms = max_rows / arrival_rows_per_s * 1e3
    else:
        wait_ms = SERVE_WAIT_CAP_MS
    if p99_ms is not None:
        wait_ms = min(wait_ms, p99_ms / 2.0)
    wait_ms = min(max(wait_ms, SERVE_WAIT_FLOOR_MS), SERVE_WAIT_CAP_MS)
    return {
        "serve_max_rows": int(max_rows),
        "serve_queue_rows": int(max_rows * 16),
        "serve_max_wait_ms": round(wait_ms, 3),
    }


# ---------------------------------------------------------- cache solver ----
def solve_cache(signals: dict) -> dict:
    """Serve-cache sizing from the capture's observed duplicate mass.

    Emits ``cache_rows``/``cache_bytes`` only when the capture proves
    both (a) serve-cache traffic (``cache/lookups`` > 0 — the replay went
    through a batcher with the cache on) and (b) actual duplicate mass:
    either in the dedup counters (repeats inside a dispatch) or as cache
    hits (repeats ACROSS dispatches — the steady-state shape once the
    cache is warm, where repeats never reach the runner and the dedup
    counters therefore read all-unique). An all-unique capture keeps the
    built-in defaults through normal config fallback rather than
    recording an unmeasured guess as "tuned".

    Sizing: every miss during the capture window is one distinct
    (version, mode, document) entry the cache had to hold, so the row
    bound is the misses count with 2x headroom, rounded up to a power of
    two (clamped [1024, 2^20]); the byte bound multiplies rows by the
    measured mean SERVED-document size plus a flat result/overhead
    allowance (clamped [1MB, 1GB]). The document size comes from the
    cache's own traffic — ``cache/bytes_saved`` counts the hit documents'
    bytes, so ``bytes_saved / hits`` is exactly the mean size of what the
    cache stores; the dedup byte counters are NOT used here because they
    aggregate the fit path too, which would bias the entry size toward
    whatever corpus the capture happened to fit. Deterministic over the
    capture.
    """
    counters = signals["counters"]
    lookups = float(counters.get("cache/lookups") or 0.0)
    hits = float(counters.get("cache/hits") or 0.0)
    rows_in = float(counters.get("dedup/rows_in") or 0.0)
    rows_unique = float(counters.get("dedup/rows_unique") or 0.0)
    dedup_mass = rows_in > 0 and rows_unique < rows_in
    if lookups <= 0 or not (dedup_mass or hits > 0):
        return {}
    misses = max(1.0, lookups - hits)
    rows = 1024
    while rows < 2 * misses and rows < (1 << 20):
        rows *= 2
    saved = float(counters.get("cache/bytes_saved") or 0.0)
    mean_doc = saved / hits if hits > 0 else 0.0
    per_entry = int(mean_doc) + 512  # result row + key/entry overhead
    cache_bytes = 1 << 20
    while cache_bytes < rows * per_entry and cache_bytes < (1 << 30):
        cache_bytes *= 2
    return {"cache_rows": int(rows), "cache_bytes": int(cache_bytes)}


# ----------------------------------------------------------- wire solver ----
def solve_wire(signals: dict) -> dict:
    """Device-encode stamping from the capture's measured padding tax.

    Emits ``device_encode: True`` when the capture proves either (a) the
    replayed deployment already ran the wire path
    (``score/encoded_batches`` > 0 — keep what worked), or (b) scoring
    traffic padded badly: whole-run fill ``score/real_bytes /
    score/capacity_bytes`` below 0.85, meaning ≥15% of every transfer was
    padding the device-encode wire form would simply not ship. A capture
    with no scoring traffic (or dense, well-filled batches where the
    padded path's single pre-padded put is already near-optimal) emits
    nothing — the knob's built-in default stands through normal config
    fallback rather than recording an unmeasured guess as "tuned".
    """
    counters = signals["counters"]
    if float(counters.get("score/encoded_batches") or 0.0) > 0:
        return {"device_encode": True}
    real = float(counters.get("score/real_bytes") or 0.0)
    capacity = float(counters.get("score/capacity_bytes") or 0.0)
    if capacity <= 0:
        return {}
    if real / capacity < 0.85:
        return {"device_encode": True}
    return {}


# --------------------------------------------------------- budget solver ----
def solve_budgets(signals: dict, *, max_batch_ms: float | None) -> dict:
    """Per-transfer byte budgets. Without a latency constraint the
    profile carries NO budget fields — the defaults stand through normal
    config fallback (recording an unmeasured value as "tuned" would lie
    in the /varz provenance and pin a stale default forever); with
    ``--max-batch-ms``, the measured wire rate bounds the budget to the
    largest power-of-two MB whose transfer fits the target."""
    if max_batch_ms is None:
        return {}
    counters = signals["counters"]
    real = float(counters.get("score/real_bytes") or 0.0)
    hists = signals["histograms"]
    lat = hists.get("score/batch_latency_s") or {}
    per_batch_s = float(lat.get("mean") or 0.0)
    batches = float(lat.get("count") or 0.0)
    if real <= 0 or per_batch_s <= 0 or batches <= 0:
        return {}  # constraint given but unmeasurable: stay on defaults
    bytes_per_s = (real / batches) / per_batch_s
    budget = 1 << 20
    while budget * 2 <= bytes_per_s * (max_batch_ms / 1e3) and budget < (
        32 << 20
    ):
        budget *= 2
    return {"batch_bytes": int(budget), "fit_batch_bytes": int(budget)}


# --------------------------------------------------------------- solve ------
def solve(
    events: list[dict],
    *,
    max_shapes: int = DEFAULT_MAX_SHAPES,
    min_width: int = DEFAULT_MIN_WIDTH,
    max_batch_ms: float | None = None,
    p99_ms: float | None = None,
) -> TuningProfile:
    """One capture -> one validated profile (see the module docstring)."""
    from ..ops.encoding import DEFAULT_LENGTH_BUCKETS

    signals = capture_signals(events)
    bins = signals["len_bins"]
    # The DP solves the interior widths; the TOP bucket is special — it is
    # the chunking boundary (BatchRunner.max_chunk), and the exec/len
    # distribution is recorded post-chunking, clamped at the live lattice's
    # top. Shrinking it below the built-in max would (a) re-chunk every
    # longer doc into many small pieces (extra dispatches + overlap
    # rescoring) and (b) ratchet: a narrow live lattice caps what future
    # captures can observe, so re-tuning could never widen it back. One
    # shape slot is therefore reserved for the default top bucket whenever
    # the observed lengths don't reach it; an unused bucket costs nothing.
    default_top = DEFAULT_LENGTH_BUCKETS[-1]
    buckets = solve_buckets(
        bins, max_shapes=max(1, max_shapes - 1), min_width=min_width
    )
    if buckets[-1] < default_top:
        buckets = buckets + [default_top]
    tuned: dict = {"length_buckets": buckets}
    tuned.update(solve_budgets(signals, max_batch_ms=max_batch_ms))
    tuned.update(solve_serve(signals, p99_ms=p99_ms))
    tuned.update(solve_cache(signals))
    tuned.update(solve_wire(signals))

    before = padded_bytes(bins, list(DEFAULT_LENGTH_BUCKETS))
    after = padded_bytes(bins, buckets)
    real = sum(edge * count for edge, count in bins.items())  # upper bound
    constraints = {
        "max_shapes": int(max_shapes),
        "min_width": int(min_width),
        "max_batch_ms": max_batch_ms,
        "p99_ms": p99_ms,
    }
    counters = signals["counters"]
    rows_in = float(counters.get("dedup/rows_in") or 0.0)
    rows_unique = float(counters.get("dedup/rows_unique") or 0.0)
    source = {
        "events": signals["events"],
        "capture_span_s": round(signals["span_s"], 3),
        "items": int(sum(bins.values())),
        "len_bins": len(bins),
        # Observed duplicate mass (the cache solver's evidence): fraction
        # of submitted rows the dedup layer collapsed during the capture.
        "duplicate_mass": (
            round(1.0 - rows_unique / rows_in, 6) if rows_in > 0 else 0.0
        ),
        # Whole-run wire fill (the wire solver's evidence): real scored
        # bytes over the capacity that actually shipped.
        "score_wire_fill": (
            round(
                float(counters.get("score/real_bytes") or 0.0)
                / float(counters.get("score/capacity_bytes") or 0.0),
                6,
            )
            if float(counters.get("score/capacity_bytes") or 0.0) > 0
            else None
        ),
        "padded_bytes_default_lattice": int(before),
        "padded_bytes_tuned_lattice": int(after),
        "predicted_padded_reduction": (
            round(1.0 - after / before, 6) if before else 0.0
        ),
        "binned_real_bytes_upper": int(real),
    }
    ts_max = 0.0
    for ev in events:
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            ts_max = max(ts_max, float(ts))
    return TuningProfile(
        tuned=tuned,
        source=source,
        constraints=constraints,
        created=ts_max,
        version=content_version(tuned),
    )


# ----------------------------------------------------------------- CLI ------
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_path = None
    max_shapes = DEFAULT_MAX_SHAPES
    min_width = DEFAULT_MIN_WIDTH
    max_batch_ms = p99_ms = None
    paths: list[str] = []
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a in ("-h", "--help"):
                raise ValueError
            if a in ("-o", "--out"):
                out_path = argv[i + 1]
                i += 2
            elif a == "--max-shapes":
                max_shapes = int(argv[i + 1])
                i += 2
            elif a == "--min-width":
                min_width = int(argv[i + 1])
                i += 2
            elif a == "--max-batch-ms":
                max_batch_ms = float(argv[i + 1])
                i += 2
            elif a == "--p99-ms":
                p99_ms = float(argv[i + 1])
                i += 2
            elif a.startswith("-"):
                raise ValueError(f"unknown option {a!r}")
            else:
                paths.append(a)
                i += 1
        if len(paths) != 1 or max_shapes < 1 or min_width < WIDTH_ALIGN:
            raise ValueError
    except (ValueError, IndexError) as e:
        msg = f"error: {e}\n" if str(e) else ""
        print(
            msg + "usage: python -m spark_languagedetector_tpu_torch.exec.tune "
            "<telemetry.jsonl> [-o profile.json] [--max-shapes N] "
            "[--min-width 128] [--max-batch-ms MS] [--p99-ms MS]",
            file=sys.stderr,
        )
        return 2
    try:
        events = load_events(paths[0])
    except OSError as e:
        print(f"cannot read capture: {e}", file=sys.stderr)
        return 2
    try:
        profile = solve(
            events, max_shapes=max_shapes, min_width=min_width,
            max_batch_ms=max_batch_ms, p99_ms=p99_ms,
        )
    except ValueError as e:
        print(f"cannot tune from this capture: {e}", file=sys.stderr)
        return 2
    src = profile.source
    print(f"profile {profile.version} from {paths[0]}")
    print(
        f"  items {src['items']} across {src['len_bins']} length bins, "
        f"capture span {src['capture_span_s']}s"
    )
    print(
        f"  length_buckets -> {list(profile.tuned['length_buckets'])}"
    )
    print(
        f"  predicted padded-byte reduction vs default lattice: "
        f"{src['predicted_padded_reduction']:.1%}"
    )
    for key in sorted(profile.tuned):
        if key != "length_buckets":
            print(f"  {key} -> {profile.tuned[key]}")
    if out_path:
        profile.save(out_path)
        print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
