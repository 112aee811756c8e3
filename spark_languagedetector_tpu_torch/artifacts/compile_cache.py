"""The kernel build cache and the shape-lattice prewarm of the cold-start plane.

Port of ``spark_languagedetector_tpu.artifacts.compile_cache``. In the JAX
package the cache is XLA's persistent compilation cache. Here what a
process would otherwise compile is the CUDA kernels' libraries (``nvcc``,
``ops/_kernels.py``), so the cache is the kernel build directory:

* :func:`enable_compile_cache` points the build directory at the resolved
  ``compile_cache_dir`` knob (``LANGDETECT_COMPILE_CACHE_DIR``). The first
  process to need a library builds it there; every later one loads it. The
  build writes ``*.tmp<pid>.so`` and renames it into place, so processes
  building the same library at once never load a half-written file. An
  unset knob returns None and changes nothing.
* :func:`prewarm_lattice` loads the libraries the runner's strategy
  launches and scores one synthetic document per bucket ceiling, so a
  replica reaches READY with every geometry it serves dispatched once.

**What "verified warm" means here.** A full prewarm writes the lattice's
signature as a manifest into the cache (``lattice-<digest>.manifest.json``).
A later prewarm with the same signature runs one sentinel bucket and checks
the proof: every library that the runner's strategy launches
(``BatchRunner.kernels()``) was found in the cache and loaded, and no
``nvcc`` ran (``compile_cache/misses`` did not move). ``compile_cache/hits``
alone cannot be the proof: it moves only when a process first loads a
library. Off the card a runner launches no kernel, the set is empty, and
the proof holds. A sentinel that fails the proof (a wiped or foreign cache
behind a stale manifest) self-heals: the full lattice runs and the manifest
is rewritten.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

from ..telemetry.registry import REGISTRY, Registry
from ..utils.logging import get_logger, log_event

_log = get_logger("artifacts.compile_cache")


def enable_compile_cache(
    cache_dir: str | None = None, env=os.environ
) -> str | None:
    """Point the kernel build directory at the resolved ``compile_cache_dir``
    (explicit > env > default). An unset knob returns None and leaves the
    build directory as it is; otherwise the directory is created and
    returned. Libraries already loaded in this process stay loaded."""
    from ..exec import config as exec_config
    from ..ops import _kernels

    path = exec_config.resolve("compile_cache_dir", cache_dir, env)
    if not path:
        return None
    os.makedirs(path, exist_ok=True)
    _kernels.set_build_dir(path)
    log_event(_log, "compile_cache.enabled", path=str(path))
    return str(path)


def _lattice_signature(runner, buckets: tuple[int, ...]) -> dict:
    """Everything the lattice's work depends on, runner-side: geometry
    knobs, table shapes and dtypes, the torch version, the device, and the
    digest of every kernel library the strategy launches (its file name
    carries the hash of its sources and flags). A dimension this misses
    degrades gracefully: the sentinel's proof fails and the full prewarm
    runs."""
    import torch

    w = runner._host_weights
    lut = runner._host_lut
    dev = runner.device
    return {
        "schema": 1,
        "torch": torch.__version__,
        "device": (
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
        ),
        "kernels": sorted(k.library_path.name for k in runner.kernels()),
        "buckets": [int(b) for b in buckets],
        "strategy": runner.strategy,
        "quantization": runner.quantization,
        "block": int(runner.block),
        "batch_bytes": int(runner.batch_bytes),
        "device_encode": bool(runner.device_encode),
        "weights": [list(map(int, w.shape)), str(w.dtype)],
        "lut": None if lut is None else [list(map(int, lut.shape)), str(lut.dtype)],
        "cuckoo": runner.cuckoo is not None,
        "vocab": [
            runner.spec.mode, list(runner.spec.gram_lengths),
            int(runner.spec.hash_bits),
        ],
    }


def _manifest_path(cache_dir: str, sig: dict) -> str:
    digest = hashlib.sha256(
        json.dumps(sig, sort_keys=True).encode()
    ).hexdigest()[:16]
    return os.path.join(cache_dir, f"lattice-{digest}.manifest.json")


def _misses() -> int:
    return int(REGISTRY.snapshot()["counters"].get("compile_cache/misses", 0))


def _load_kernels(runner) -> bool:
    """Load every library the runner's strategy launches, building the
    missing ones first (one ``nvcc`` each, all at once). True when each was
    already in the cache and no ``nvcc`` ran."""
    from ..ops import _kernels

    kernels = runner.kernels()
    missing = [k for k in kernels if not k.library_path.is_file()]
    before = _misses()
    if missing:
        _kernels.build_all(missing)
    for k in kernels:
        k.library()
    return not missing and _misses() == before


def prewarm_lattice(
    runner,
    profile=None,
    registry: Registry | None = None,
    cache_dir: str | None = None,
) -> dict:
    """Load the runner's kernel libraries and score one synthetic document
    per bucket ceiling of its padded-length lattice, each in its **own**
    call (a batched call would let the planner coalesce them into one
    geometry). ``profile`` (a :class:`~..exec.profile.TuningProfile`)
    overrides the bucket source; by default the runner's own lattice.

    With ``cache_dir`` (:func:`enable_compile_cache`'s return) a full
    prewarm writes the lattice's manifest, and a later one with the same
    signature runs only the first bucket as a sentinel and checks the proof
    of the module docstring; a failed proof falls back to the full lattice
    and rewrites the manifest. Without ``cache_dir`` no manifest is read or
    written and the full lattice always runs.

    Returns ``{"buckets": [...], "seconds": ..., "mode": "full" |
    "sentinel", "verified_hit": bool | None}`` and records the seconds in
    the ``artifacts/prewarm_s`` histogram."""
    reg = registry if registry is not None else REGISTRY
    buckets = None
    if profile is not None:
        buckets = profile.get("length_buckets")
    if buckets is None:
        buckets = runner.length_buckets
    buckets = tuple(int(b) for b in buckets)

    mode = "full"
    verified_hit: bool | None = None
    manifest = None
    if cache_dir:
        sig = _lattice_signature(runner, buckets)
        manifest = _manifest_path(str(cache_dir), sig)
        try:
            with open(manifest, "r", encoding="utf-8") as f:
                if json.load(f) == sig:
                    mode = "sentinel"
        except (OSError, ValueError):
            pass

    t0 = time.perf_counter()
    warm = _load_kernels(runner)
    if mode == "sentinel":
        runner.score([b"a" * buckets[0]])
        verified_hit = warm
        if not verified_hit:
            # The manifest promised libraries the cache no longer held:
            # run the rest of the lattice and earn the manifest again.
            mode = "full"
            for b in buckets[1:]:
                runner.score([b"a" * b])
    else:
        for b in buckets:
            runner.score([b"a" * b])
    seconds = time.perf_counter() - t0

    if mode == "full" and manifest is not None:
        # Atomic (tmp + rename): later spawns skip work on this promise, so
        # a torn manifest must fail to parse, never read as a signature.
        tmp = f"{manifest}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(sig, f, sort_keys=True)
            os.replace(tmp, manifest)
        except OSError:
            pass
    reg.observe("artifacts/prewarm_s", seconds)
    log_event(
        _log, "compile_cache.prewarmed", buckets=list(buckets),
        seconds=round(seconds, 4), mode=mode, verified_hit=verified_hit,
    )
    return {
        "buckets": list(buckets), "seconds": seconds, "mode": mode,
        "verified_hit": verified_hit,
    }
