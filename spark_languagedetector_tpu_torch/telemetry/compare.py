"""Regression guard: diff two telemetry captures per stage, exit nonzero.

Port of ``spark_languagedetector_tpu.telemetry.compare``, with the same
flags, exit codes and tracked metrics, so a capture of either package can
be held against a capture of the other::

    python -m spark_languagedetector_tpu_torch.telemetry.compare \
        baseline.jsonl candidate.jsonl [--threshold 0.25] \
        [--metrics p50,p90,p99] [--min-seconds 0.0]

For every span path present in both captures, the wall-time percentiles
and the fenced device totals are compared; so are the last snapshot's
plain histograms (fill, waste, stall, the serving latency legs), its
recovery counters (retries, breaker trips, DLQ rows, sheds, failovers),
the tracked gauges (``langdetect_table_bytes``,
``langdetect_fit_collect_bytes``, the re-derived bytes utilization) and
the fill ratios taken from exact counters. Any metric that moved past
``--threshold`` (relative, in the worse direction: slower, less filled,
more wasted) fails the run with exit code 1; 2 is a usage or input error.
Stages present in only one capture are reported, never failed.

Standard library and the registry's Histogram only, like the report CLI.
"""

from __future__ import annotations

import math
import sys

from .registry import Histogram
from .report import load_events

DEFAULT_THRESHOLD = 0.25
# --metrics replaces this set wholesale: a user passing "--metrics p50"
# has opted out of everything else, device metrics included.
DEFAULT_METRICS = ("p50", "p90", "p99", "device_total_s", "device_p99")

# Snapshot histograms where higher is better (matched by substring);
# everything else (stall seconds, latency, padding waste, retries)
# regresses upward. ``serve/fill_ratio`` regresses when it drops,
# ``serve/padding_waste`` when it rises, ``cache/hit_rate`` when the serve
# cache stops hitting on the same replayed traffic.
_HIGHER_BETTER = ("fill_ratio", "hit_rate")

# Tracked gauges (last snapshot), keyed to a short stable name: a profile
# silently de-quantized (table bytes x4), a program's memory traffic grown,
# or a fit collect falling back to the whole [V, L] table regresses here
# even when every latency percentile held.
_TRACKED_GAUGES = {
    "langdetect_table_bytes": "table_bytes",
    "langdetect_fit_collect_bytes": "fit_collect_bytes",
}

# Cold-start histograms: their p50 is diffed beside the mean and p99, so
# one first-ever load blowing out the p99 cannot mask the typical load.
_COLD_START_HISTOGRAMS = ("scale/spawn_ready_s", "zoo/cold_load_s")

# Recovery counters diffed as reliability regressions; one appearing
# against a zero baseline regresses whatever the threshold. Only counters
# of rejection or recovery belong here: throughput and good-news counters
# (serve/coalesced_rows, fleet/readmissions) legitimately grow.
_RELIABILITY_COUNTER_PREFIXES = ("resilience/", "serve/shed", "zoo/shed")
_RELIABILITY_COUNTERS = (
    "score/retries",
    "stream/retries",
    "serve/deadline_rejects",
    "serve/dispatch_errors",
    "serve/client_retries",
    "fleet/failovers",
    "fleet/ejections",
    "fleet/shed_requests",
    "fleet/swap_aborts",
    "zoo/cross_tenant_rejects",
    "zoo/load_errors",
    "artifacts/load_errors",
    "scale/spawn_failures",
    "scale/restarts",
    "fleet/agg_scrape_failures",
    "fleet/retry_budget_exhausted",
    "fleet/deadline_rejects",
    "fleet/quarantined_signatures",
    "fleet/quarantine_rejects",
    "serve/client_deadline_gaveups",
)

# Informational counters: shown like the reliability set, never a
# regression. Paging under a residency budget, capacity following
# traffic, scrape rounds, alert transitions and hedges are the system
# doing its job.
_INFORMATIONAL_COUNTERS = (
    "zoo/evictions",
    "zoo/cold_loads",
    "scale/ups",
    "scale/downs",
    "scale/orphans_reaped",
    "fleet/agg_scrapes",
    "slo/alerts",
    "fleet/dispatches",
    "fleet/hedges",
    "fleet/hedge_wins",
)

# Whole-run ratios re-derived from the last snapshot's exact counters (the
# per-batch histograms are sampled reservoirs). Names holding "fill_ratio"
# or "hit_rate" regress downward; the rest (unique rows over rows in, the
# segment reject rate, wire bytes per document) regress upward.
_TRACKED_RATIOS = {
    "fill_ratio[score/wire]": ("score/real_bytes", "score/capacity_bytes"),
    "fill_ratio[fit/wire]": ("fit/real_bytes", "fit/capacity_bytes"),
    "fill_ratio[serve/coalesce]": (
        "serve/coalesced_rows", "serve/dispatch_capacity_rows"
    ),
    "cache/hit_rate": ("cache/hits", "cache/lookups"),
    "dedup/unique_ratio": ("dedup/rows_unique", "dedup/rows_in"),
    "segment/reject_rate": ("segment/rejects", "segment/docs"),
    "score/wire_bytes_per_doc": ("score/wire_bytes", "score/wire_docs"),
}


def _tracked_metrics(events: list[dict], stages: dict) -> dict[str, float]:
    """Gauge-derived contract metrics from a capture's LAST snapshot.

    ``table_bytes[...]`` is the raw gauge per label set;
    ``est_bytes_utilization[<program>]`` is re-derived exactly like
    ``Registry.stage_summary`` joins it: program_bytes_accessed per call /
    measured per-call seconds (fenced device mean preferred) / the
    platform peak — so the guard sees the same number the bench telemetry
    block reports.
    """
    gauges: dict = {}
    counters: dict = {}
    for ev in events:
        if ev.get("event") != "telemetry.snapshot":
            continue
        payload = ev.get("gauges")
        if isinstance(payload, dict):
            gauges = payload
        cpayload = ev.get("counters")
        if isinstance(cpayload, dict):
            counters = cpayload
    out: dict[str, float] = {}
    for name, (num_key, den_key) in _TRACKED_RATIOS.items():
        num, den = counters.get(num_key), counters.get(den_key)
        if (
            isinstance(num, (int, float))
            and isinstance(den, (int, float))
            and den > 0
        ):
            out[name] = round(float(num) / float(den), 6)
    for name, short in _TRACKED_GAUGES.items():
        series = gauges.get(name)
        if not isinstance(series, dict):
            continue
        # Keyed by PROGRAM only, max over label sets: the quant/strategy
        # labels change when a profile de-quantizes, and a key that moves
        # with them would downgrade exactly that regression to an
        # informational one-sided line. Under one program key, an int8 →
        # f32 flip is a same-key 4x value jump and fails the diff.
        for label, val in series.items():
            if not isinstance(val, (int, float)):
                continue
            program = dict(
                p.split("=", 1) for p in label.split(",") if "=" in p
            ).get("program", label)
            key = f"{short}[{program}]"
            out[key] = max(out.get(key, 0.0), float(val))
    peak = None
    for label, val in (gauges.get("device_peak_bytes_per_s") or {}).items():
        if isinstance(val, (int, float)) and val > 0:
            peak = float(val)
            break
    if peak:
        for label, per_call in (
            gauges.get("program_bytes_accessed") or {}
        ).items():
            if not isinstance(per_call, (int, float)):
                continue
            program = dict(
                p.split("=", 1) for p in label.split(",") if "=" in p
            ).get("program")
            entry = stages.get(program)
            if not entry:
                continue
            seconds = entry.get("mean")
            if entry.get("device_total_s") and entry.get("count"):
                seconds = entry["device_total_s"] / entry["count"]
            if not seconds:
                continue
            out[f"est_bytes_utilization[{program}]"] = round(
                per_call / seconds / peak, 6
            )
    return out


def capture_stats(events: list[dict]) -> dict:
    """One capture's comparable stats: per-stage wall/device aggregates +
    the last snapshot's plain histograms."""
    stages: dict[str, dict] = {}
    wall: dict[str, Histogram] = {}
    device: dict[str, Histogram] = {}
    for ev in events:
        if ev.get("event") != "telemetry.span":
            continue
        path, w = ev.get("path"), ev.get("wall_s")
        if not isinstance(path, str) or not isinstance(w, (int, float)):
            continue
        wall.setdefault(path, Histogram()).record(float(w))
        d = ev.get("device_s")
        if isinstance(d, (int, float)):
            device.setdefault(path, Histogram()).record(float(d))
    for path, h in wall.items():
        s = h.snapshot()
        entry = {
            "count": s["count"],
            "total_s": s["sum"],
            **{k: s[k] for k in ("mean", "p50", "p90", "p99") if k in s},
        }
        dh = device.get(path)
        if dh is not None:
            ds = dh.snapshot()
            entry["device_total_s"] = ds["sum"]
            if "p99" in ds:
                entry["device_p99"] = ds["p99"]
        stages[path] = entry

    hists: dict[str, dict] = {}
    counters: dict[str, float] = {}
    for ev in events:
        if ev.get("event") != "telemetry.snapshot":
            continue
        payload = ev.get("histograms")
        if isinstance(payload, dict):
            hists = {
                str(k): v for k, v in payload.items()
                if isinstance(v, dict) and v.get("count")
            }
        # Recovery counters: a reliability regression even when every
        # latency percentile held.
        cpayload = ev.get("counters")
        if isinstance(cpayload, dict):
            counters = {
                str(k): v for k, v in cpayload.items()
                if isinstance(v, (int, float))
                and (
                    str(k).startswith(_RELIABILITY_COUNTER_PREFIXES)
                    or str(k) in _RELIABILITY_COUNTERS
                    or str(k) in _INFORMATIONAL_COUNTERS
                )
            }
    return {
        "stages": stages,
        "histograms": hists,
        "counters": counters,
        "tracked": _tracked_metrics(events, stages),
    }


def _rel_delta(base: float, new: float) -> float | None:
    if not isinstance(base, (int, float)) or not isinstance(new, (int, float)):
        return None
    if base <= 0:
        return None
    return (new - base) / base


def compare_captures(
    base: dict,
    new: dict,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    metrics: tuple[str, ...] = DEFAULT_METRICS,
    min_seconds: float = 0.0,
) -> tuple[list[str], list[str]]:
    """(report lines, regression descriptions) for two capture_stats."""
    lines: list[str] = []
    regressions: list[str] = []
    b_stages, n_stages = base["stages"], new["stages"]
    shared = sorted(set(b_stages) & set(n_stages))
    only_base = sorted(set(b_stages) - set(n_stages))
    only_new = sorted(set(n_stages) - set(b_stages))

    header = (
        f"{'stage':<28} {'metric':<14} {'base':>12} {'new':>12} {'delta':>9}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    span_metrics = tuple(metrics)
    for path in shared:
        b, n = b_stages[path], n_stages[path]
        if b.get("total_s", 0.0) < min_seconds:
            continue
        for m in span_metrics:
            if m not in b or m not in n:
                continue
            delta = _rel_delta(b[m], n[m])
            if delta is None:
                continue
            flag = ""
            if delta > threshold:
                flag = "  REGRESSION"
                regressions.append(
                    f"{path} {m}: {b[m]:.6f} -> {n[m]:.6f} (+{delta:.1%})"
                )
            if flag or abs(delta) > threshold / 2:
                lines.append(
                    f"{path:<28} {m:<14} {b[m]:>12.6f} {n[m]:>12.6f} "
                    f"{delta:>+8.1%}{flag}"
                )

    b_h, n_h = base["histograms"], new["histograms"]
    for name in sorted(set(b_h) & set(n_h)):
        b, n = b_h[name], n_h[name]
        hist_metrics = ("mean", "p99")
        if name in _COLD_START_HISTOGRAMS:
            hist_metrics = ("mean", "p50", "p99")
        for m in hist_metrics:
            delta = _rel_delta(b.get(m), n.get(m))
            if delta is None:
                continue
            higher_better = any(t in name for t in _HIGHER_BETTER)
            worse = -delta if higher_better else delta
            flag = ""
            if worse > threshold:
                flag = "  REGRESSION"
                regressions.append(
                    f"{name} {m}: {b[m]:.6f} -> {n[m]:.6f} ({delta:+.1%})"
                )
            if flag or abs(delta) > threshold / 2:
                lines.append(
                    f"{name:<28} {m:<14} {b[m]:>12.6f} {n[m]:>12.6f} "
                    f"{delta:>+8.1%}{flag}"
                )

    b_c, n_c = base.get("counters", {}), new.get("counters", {})
    for name in sorted(set(b_c) | set(n_c)):
        bv = float(b_c.get(name, 0) or 0)
        nv = float(n_c.get(name, 0) or 0)
        if bv <= 0 and nv <= 0:
            continue
        if bv > 0:
            delta = (nv - bv) / bv
            shown = f"{delta:>+8.1%}"
        else:
            # Zero/absent baseline: the most common reliability regression
            # IS a recovery counter appearing at all (0 retries -> 50, a
            # first breaker trip) — a relative delta can't express it, so
            # any appearance regresses regardless of threshold.
            delta = math.inf
            shown = f"{'new':>8}"
        if name in _INFORMATIONAL_COUNTERS:
            # Tracked for the operator, exempt from the gate: paging
            # activity moving with the tenant population is expected.
            if delta == math.inf or abs(delta) > threshold / 2:
                lines.append(
                    f"{name:<28} {'count':<14} {bv:>12.6f} "
                    f"{nv:>12.6f} {shown}  informational"
                )
            continue
        flag = ""
        if delta > threshold:
            flag = "  REGRESSION"
            suffix = "new" if delta == math.inf else f"+{delta:.1%}"
            regressions.append(f"{name}: {bv:g} -> {nv:g} ({suffix})")
        if flag or abs(delta) > threshold / 2:
            lines.append(
                f"{name:<28} {'count':<14} {bv:>12.6f} "
                f"{nv:>12.6f} {shown}{flag}"
            )

    # Tracked contract metrics: table-traffic gauges regress upward (more
    # table bytes resident or streamed, more of the memory roof consumed);
    # the aggregate fill ratios regress downward (emptier shapes). Unlike
    # the recovery counters, a metric appearing in only one capture is
    # informational — instrumentation grows between rounds, and a
    # freshly-tracked metric has no contract yet.
    b_t, n_t = base.get("tracked", {}), new.get("tracked", {})
    for name in sorted(set(b_t) | set(n_t)):
        if name not in b_t or name not in n_t:
            lines.append(
                f"tracked metric only in "
                f"{'baseline' if name in b_t else 'candidate'}: {name}"
            )
            continue
        delta = _rel_delta(b_t[name], n_t[name])
        higher_better = any(t in name for t in _HIGHER_BETTER)
        if delta is None:
            # A lower-better ratio rising off an exactly-zero baseline
            # (a zero-reject run that starts rejecting: segment/
            # reject_rate 0 -> anything) has no finite relative delta —
            # like the reliability counters, the appearance itself is
            # the regression.
            if not higher_better and b_t[name] == 0 and n_t[name] > 0:
                delta = math.inf
            else:
                continue
        worse = -delta if higher_better else delta
        flag = ""
        if worse > threshold:
            flag = "  REGRESSION"
            regressions.append(
                f"{name}: {b_t[name]:g} -> {n_t[name]:g} ({delta:+.1%})"
            )
        if flag or abs(delta) > threshold / 2:
            lines.append(
                f"{name:<28} {'gauge':<14} {b_t[name]:>12.6f} "
                f"{n_t[name]:>12.6f} {delta:>+8.1%}{flag}"
            )

    if only_base:
        lines.append(f"only in baseline: {', '.join(only_base)}")
    if only_new:
        lines.append(f"only in candidate: {', '.join(only_new)}")
    return lines, regressions


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    threshold = DEFAULT_THRESHOLD
    metrics = DEFAULT_METRICS
    min_seconds = 0.0
    paths: list[str] = []
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a in ("-h", "--help"):
                raise ValueError
            if a == "--threshold":
                threshold = float(argv[i + 1])
                i += 2
            elif a == "--metrics":
                metrics = tuple(
                    m.strip() for m in argv[i + 1].split(",") if m.strip()
                )
                i += 2
            elif a == "--min-seconds":
                min_seconds = float(argv[i + 1])
                i += 2
            elif a.startswith("-"):
                raise ValueError(f"unknown option {a!r}")
            else:
                paths.append(a)
                i += 1
        if len(paths) != 2:
            raise ValueError
    except (ValueError, IndexError) as e:
        msg = f"error: {e}\n" if str(e) else ""
        print(
            msg + "usage: python -m spark_languagedetector_tpu_torch.telemetry."
            "compare <baseline.jsonl> <candidate.jsonl> "
            "[--threshold 0.25] [--metrics p50,p90,p99] [--min-seconds 0.0]",
            file=sys.stderr,
        )
        return 2
    try:
        base = capture_stats(load_events(paths[0]))
        new = capture_stats(load_events(paths[1]))
    except OSError as e:
        print(f"cannot read capture: {e}", file=sys.stderr)
        return 2
    if not base["stages"] and not base["histograms"]:
        print(f"no comparable telemetry in {paths[0]}", file=sys.stderr)
        return 2
    lines, regressions = compare_captures(
        base, new, threshold=threshold, metrics=metrics,
        min_seconds=min_seconds,
    )
    print("\n".join(lines))
    if regressions:
        print(
            f"\n{len(regressions)} regression(s) past threshold "
            f"{threshold:.0%}:"
        )
        for r in regressions:
            print(f"  {r}")
        return 1
    print(f"\nok: no regression past threshold {threshold:.0%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
