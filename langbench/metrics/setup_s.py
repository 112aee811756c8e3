"""``setup_s``: seconds from the process's start to the window's start:
imports, inputs from the seed, the profile fitted, kernels built or loaded,
every shape of the window warmed."""


def read(rec: dict) -> float | None:
    return rec["setup_s"]
