"""One reader per metric, ``<metric name>.py``, each with ``read(rec)``: the
metric's value from the window's record, or None where it finds nothing to
read. The harness loads a reader by the metric's name in BENCHMARK.json.

The record: ``entry``, ``calls`` (each with ``t0``, ``t1`` on the host's
perf clock, ``docs`` and ``ok``), ``window_s``, ``setup_s``; in a traced run
also ``spans`` (the program's, ``path`` and ``wall_s``), ``device``
(:func:`langbench.devtrace.summarize`), ``work`` (:mod:`langbench.count`)
and ``peaks`` (:mod:`langbench.peaks`).
"""
