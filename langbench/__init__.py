"""The benchmark of ``spark_languagedetector_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json``; ``readings.py`` reads the
numbers that decide ``correct`` over many seeds, for the program and for
its control. The harness imports torch, numpy and the program; the plain
reference (``reference/``) imports torch and numpy only. Nothing here
imports JAX or the JAX package.
"""
