"""Cost and roofline gauges: an analytic model of a program's operations
and bytes, beside its measured time.

Port of ``spark_languagedetector_tpu.telemetry.cost``. The JAX package
takes a program's cost from XLA's ``cost_analysis``; torch has no such
model of a dispatch, so the port counts it from the dispatch's shape.
The gauges, their labels and their per-span-call units are the JAX
package's:

  * ``program_flops{program=<span path>}`` and
    ``program_bytes_accessed{program=...}``: the cost of one call of the
    span at that path (``score/dispatch`` per dispatch, also
    ``score/fused`` for the fused strategy; ``fit/count`` for the whole
    counting loop);
  * ``device_peak_flops{device=<platform>}`` and
    ``device_peak_bytes_per_s{...}``: the roofline anchors;
  * ``langdetect_table_bytes{program, quant, strategy}``: the runner's
    resident table bytes (:meth:`BatchRunner.table_bytes`).

:meth:`Registry.stage_summary` joins them with the span times into
``est_flops_per_s``, ``flops_utilization``, ``bytes_utilization`` and
``roofline_bound``; it prefers the fenced ``device_mean``
(``LANGDETECT_TELEMETRY_FENCE=1``), without which a span's wall time is
enqueue time and the utilization an upper bound.

**The score model** (:func:`dispatch_cost`), for one dispatch at the
padded ``[rows, pad_to]`` shape, as the JAX package models its dispatch
program. With ``windows = rows * sum(max(pad_to - n + 1, 0))`` over the
gram lengths ``n`` and ``L`` languages:

  * operations: ``2 * windows * L``, one multiply-add per window and
    language, the same for every strategy (``fused``, ``gather``,
    ``hist``, ``pallas``, ``hybrid``);
  * bytes: the uint8 batch and the int32 lengths; the int32 id (or row)
    plane, written once and read once (8 bytes a window); the weight
    tables read, each bounded by the smaller of one row per window and
    the whole table (the fused table in its stored dtype, the gather
    table, the row-histogram operand in float64, the bigram views); and
    the f32 ``[rows, L]`` scores written.

This differs from the per-batch bound ``chip_smoke.py`` gives a kernel:
that bound counts the distinct (document, row) pairs of the batch's real
data and the bytes their windows cover, so padding and repeated grams
cost nothing there; this model counts every padded window, as a compiled
program of that shape would. It is an upper bound on the work, so its
utilization reads high against the kernel bound's.

**The fit model** (:func:`fit_step_cost`), per count step at its real
``[rows, pad_to]`` shape: ``windows`` integer adds; the batch, lengths
and labels read, the id plane written and read, and at most one int32
cell of the ``[V, L]`` table read and written per window.

**Peaks**: on ``cuda`` the H100 SXM's published 3.35e12 B/s of device
memory and 67e12 f32 op/s; on ``cpu`` a nominal host anchor (1e11 op/s,
5e10 B/s) so utilization stays defined on a CPU run, and obviously
approximate there. ``LANGDETECT_PEAK_FLOPS`` and
``LANGDETECT_PEAK_BYTES_PER_S`` (the ``peak_flops`` and
``peak_bytes_per_s`` knobs) override either.
"""

from __future__ import annotations

import os

from .registry import REGISTRY, Registry

__all__ = [
    "dispatch_cost",
    "fit_step_cost",
    "peak_rates",
    "record_fit_count_cost",
    "record_program_cost",
    "record_runner_cost",
]

# (op/s, bytes/s) per platform: ``torch.device.type`` of the work.
_PLATFORM_PEAKS: dict[str, tuple[float, float]] = {
    "cuda": (67e12, 3.35e12),
    "cpu": (1.0e11, 5.0e10),
}


def peak_rates(platform: str, env=os.environ) -> tuple[float, float] | None:
    """(peak op/s, peak bytes/s) for a platform; the knobs override. A
    malformed override is ignored here (the gauges are advisory) and shows
    as an ``error`` row in ``effective_config``."""
    from ..exec import config as exec_config

    base = _PLATFORM_PEAKS.get(platform)
    try:
        flops = exec_config.resolve("peak_flops", env=env) or None
        byts = exec_config.resolve("peak_bytes_per_s", env=env) or None
    except ValueError:
        flops = byts = None
    if base is None and flops is None and byts is None:
        return None
    return (
        flops if flops is not None else (base[0] if base else 0.0),
        byts if byts is not None else (base[1] if base else 0.0),
    )


def record_program_cost(
    program: str,
    cost: dict | None,
    *,
    calls: float = 1.0,
    platform: str | None = None,
    registry: Registry | None = None,
) -> None:
    """Record one program's cost gauges in per-span-call units: ``calls``
    is the number of program runs one span at ``program``'s path covers."""
    if not cost:
        return
    reg = registry if registry is not None else REGISTRY
    if "flops" in cost:
        reg.set_gauge("program_flops", cost["flops"] * calls, program=program)
    if "bytes_accessed" in cost:
        reg.set_gauge("program_bytes_accessed", cost["bytes_accessed"] * calls, program=program)
    if platform:
        peaks = peak_rates(platform)
        if peaks:
            reg.set_gauge("device_peak_flops", peaks[0], device=platform)
            reg.set_gauge("device_peak_bytes_per_s", peaks[1], device=platform)


def _windows(rows: int, pad_to: int, gram_lengths) -> int:
    return int(rows) * sum(max(int(pad_to) - int(n) + 1, 0) for n in gram_lengths)


def _weight_tables(runner) -> list:
    """The weight tensors the runner's strategy reads, one per storage
    (the bigram views share theirs with the table they view)."""
    out = {}
    for t in runner.weight_tables():
        out.setdefault(t.untyped_storage().data_ptr(), t)
    return list(out.values())


def dispatch_cost(runner, rows: int, pad_to: int) -> dict:
    """``{"flops", "bytes_accessed"}`` of one of ``runner``'s dispatches at
    ``[rows, pad_to]`` (the score model of the module docstring)."""
    rows, pad_to = int(rows), int(pad_to)
    L = int(runner.num_langs)
    windows = _windows(rows, pad_to, runner.spec.gram_lengths)
    table_bytes = sum(
        min(windows * t.shape[1] * t.element_size(), t.untyped_storage().nbytes())
        for t in _weight_tables(runner)
    )
    nbytes = rows * pad_to + 4 * rows + 8 * windows + table_bytes + 4 * rows * L
    return {"flops": float(2 * windows * L), "bytes_accessed": float(nbytes)}


def record_runner_cost(runner, rows: int, pad_to: int,
                       registry: Registry | None = None) -> dict:
    """Record the cost of one of ``runner``'s dispatches at ``[rows,
    pad_to]`` under ``program="score/dispatch"`` (and ``"score/fused"`` on
    the fused strategy), with the peaks of the runner's device and its
    ``langdetect_table_bytes``. Returns the cost."""
    reg = registry if registry is not None else REGISTRY
    reg.set_gauge(
        "langdetect_table_bytes", float(runner.table_bytes()),
        program="score/dispatch",
        quant=runner.quantization or "f32",
        strategy=runner.strategy,
    )
    cost = dispatch_cost(runner, rows, pad_to)
    platform = runner.device.type
    record_program_cost("score/dispatch", cost, platform=platform, registry=reg)
    if runner.strategy == "fused":
        record_program_cost("score/fused", cost, platform=platform, registry=reg)
    return cost


def fit_step_cost(spec, num_langs: int, rows: int, pad_to: int) -> dict:
    """``{"flops", "bytes_accessed"}`` of one count step at ``[rows,
    pad_to]`` (the fit model of the module docstring)."""
    rows, pad_to = int(rows), int(pad_to)
    windows = _windows(rows, pad_to, spec.gram_lengths)
    cells = min(windows, int(spec.id_space_size) * int(num_langs))
    nbytes = rows * pad_to + 8 * rows + 8 * windows + 8 * cells
    return {"flops": float(windows), "bytes_accessed": float(nbytes)}


def record_fit_count_cost(spec, num_langs: int, step_shapes: dict, *,
                          platform: str = "cuda",
                          registry: Registry | None = None) -> dict | None:
    """Record the device fit's count loop under ``program="fit/count"``
    (that span wraps the whole loop, so the gauges are whole-loop units).
    ``step_shapes`` maps each dispatched ``(rows, pad_to)`` to its step
    count; each shape is billed at its own size. Returns the total, or
    None for an empty loop."""
    total: dict[str, float] = {}
    for (rows, pad_to), n in step_shapes.items():
        if n <= 0 or rows <= 0 or pad_to <= 0:
            continue
        for k, v in fit_step_cost(spec, num_langs, rows, pad_to).items():
            total[k] = total.get(k, 0.0) + v * n
    if not total:
        return None
    record_program_cost("fit/count", total, platform=platform, registry=registry)
    return total
