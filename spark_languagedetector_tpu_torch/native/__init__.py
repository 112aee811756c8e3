"""Native host-side packer (C++ through ctypes), the port's own build.

Port of ``spark_languagedetector_tpu.native``. ``packer.cpp`` and
``refscorer.cpp`` are copies kept in this package; they are compiled with
``g++`` on first use into ``build/native/`` at the root of a source checkout
(or, for an installed package, a per-user cache directory), under a name
keyed by a hash of the sources and flags, so an edited source never loads a
stale build. Nothing is written into, or loaded from, the JAX package's
folder. Exposed:

  * :func:`pack_batch` — multithreaded documents → padded uint8 [B, S];
  * :func:`pack_ragged` — the chunk-aligned flat form (see
    ``ops.encoding.pack_ragged_numpy``);
  * :func:`clean_bytes` / :func:`ascii_lower` — byte-level text cleanup;
  * :class:`RefScorer` — the compiled per-row reference scorer.

Both packers take ``out`` arrays, so a caller packs straight into a view of
pinned host memory. Every entry point but :class:`RefScorer` has a numpy
fallback: without a compiler (or when the build fails) :func:`available` is
False, ``native/unavailable`` is counted once and a ``native.unavailable``
event is logged, and the numpy packers serve — bit-identical, slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("native")

_HERE = Path(__file__).resolve().parent
_SOURCES = (_HERE / "packer.cpp", _HERE / "refscorer.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _build_dir() -> Path:
    """``build/native/`` of the source checkout holding the package, else
    ``$XDG_CACHE_HOME`` (default ``~/.cache``) for an installed package."""
    checkout = _HERE.parents[1]
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "native"
    cache = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache")
    return cache / "spark_languagedetector_tpu_torch" / "native"


def library_path() -> Path:
    """Where this source tree's packer library is (or would be) built."""
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in _SOURCES) + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return _build_dir() / f"libpacker_{digest}.so"


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build(out: Path) -> bool:
    # Compile to a process-unique temp name and rename into place: rename is
    # atomic on POSIX, so a concurrent process never loads a half-written
    # library.
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), *map(str, _SOURCES), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        detail = getattr(e, "stderr", b"")
        log_event(
            _log, "native.build_failed",
            error=str(e), stderr=detail.decode() if detail else "",
        )
        tmp.unlink(missing_ok=True)
        return False


def _unavailable(reason: str) -> None:
    REGISTRY.incr("native/unavailable")
    log_event(_log, "native.unavailable", reason=reason)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.is_file() and not _build(path):
            _unavailable("build failed (no g++, or the sources do not compile)")
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _unavailable(f"load failed: {e}")
            return None
        lib.pack_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.pack_batch.restype = None
        lib.pack_ragged.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.pack_ragged.restype = None
        lib.clean_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.clean_bytes.restype = ctypes.c_int64
        lib.ascii_lower.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ascii_lower.restype = None
        lib.ref_build.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ref_build.restype = ctypes.c_void_p
        lib.ref_free.argtypes = [ctypes.c_void_p]
        lib.ref_free.restype = None
        lib.ref_score.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.ref_score.restype = None
        _lib = lib
        log_event(_log, "native.loaded", path=str(path))
        return _lib


def available() -> bool:
    return _load() is not None


def default_pack_threads() -> int:
    """Worker threads for the packing loops when the caller passes None:
    min(8, cores), or ``LANGDETECT_PACK_THREADS`` through ``exec.config``. A
    malformed value logs and falls back here instead of raising: the packer
    sits on the hot path, and a typo'd tuning knob must not stop scoring."""
    from ..exec import config as exec_config

    try:
        threads = exec_config.resolve("pack_threads")
    except ValueError:
        log_event(
            _log, "native.bad_pack_threads",
            value=exec_config.raw_env("pack_threads"),
        )
        threads = None
    if threads is not None:
        return max(1, int(threads))
    return min(8, os.cpu_count() or 1)


def _lengths64(byte_docs) -> np.ndarray:
    return np.fromiter(map(len, byte_docs), dtype=np.int64, count=len(byte_docs))


def pack_batch(
    byte_docs, pad_to: int, n_threads: int | None = None,
    out: np.ndarray | None = None, lengths_out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Native padded packing: documents → (uint8 [B, pad_to], int32 [B]).

    ``out`` (uint8 [B, pad_to], C-contiguous) and ``lengths_out`` (int32
    [B]), when given, receive the batch in place of new arrays — a view of
    pinned host memory, say. A :class:`~..ops.encode_device.DocBlock` packs
    with one vectorized scatter. Falls back to ``ops.encoding.pad_batch``
    when the library is unavailable."""
    from ..ops.encode_device import DocBlock, pad_block

    n = len(byte_docs)
    if out is None:
        out = np.empty((n, pad_to), dtype=np.uint8)
    if lengths_out is None:
        lengths_out = np.empty(n, dtype=np.int32)
    if out.shape != (n, pad_to) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous uint8 [{n}, {pad_to}]")
    if lengths_out.shape != (n,) or lengths_out.dtype != np.int32:
        raise ValueError(f"lengths_out must be int32 [{n}]")
    if isinstance(byte_docs, DocBlock):
        out[...], lengths_out[...] = pad_block(byte_docs, pad_to)
        return out, lengths_out
    lib = _load()
    if lib is None:
        from ..ops.encoding import pad_batch as py_pad

        _, lengths_out[...] = py_pad(byte_docs, pad_to=pad_to, out=out)
        return out, lengths_out
    # Each bytes object's buffer goes to C directly: the C-side memcpy is
    # the only host copy of the data.
    ptrs = (ctypes.c_char_p * n)(*byte_docs)
    lens = _lengths64(byte_docs)
    lib.pack_batch(
        ptrs,
        lens.ctypes.data_as(ctypes.c_void_p),
        n,
        pad_to,
        out.ctypes.data_as(ctypes.c_void_p),
        lengths_out.ctypes.data_as(ctypes.c_void_p),
        default_pack_threads() if n_threads is None else n_threads,
    )
    return out, lengths_out


def pack_ragged(
    byte_docs, pad_to: int, flat_step: int | None = None,
    n_threads: int | None = None, out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native ragged packing: documents → (flat uint8 [C, 128], offs int32
    [B], lengths int32 [B]) — the wire-efficient transfer form (see
    ``ops.encoding.pack_ragged_numpy``, its numpy mirror and fallback).

    ``out``, a C-contiguous uint8 [C, 128] array of the layout's own row
    count, receives the flat buffer. Offset and size bookkeeping is numpy
    either way; the library replaces only the per-document copy loop. A
    :class:`~..ops.encode_device.DocBlock` fills the flat buffer with one
    vectorized scatter instead."""
    from ..ops.encode_device import DocBlock, ragged_block
    from ..ops.encoding import RAGGED_CHUNK, pack_ragged_numpy, ragged_layout

    if isinstance(byte_docs, DocBlock):
        return ragged_block(byte_docs, pad_to, flat_step, out=out)
    lib = _load()
    if lib is None:
        return pack_ragged_numpy(byte_docs, pad_to, flat_step, out=out)
    n = len(byte_docs)
    flat, offs, lengths = ragged_layout(byte_docs, pad_to, flat_step, out=out)
    if n:
        ptrs = (ctypes.c_char_p * n)(*byte_docs)
        lens64 = _lengths64(byte_docs)
        lib.pack_ragged(
            ptrs,
            lens64.ctypes.data_as(ctypes.c_void_p),
            n,
            pad_to,
            RAGGED_CHUNK,
            offs.ctypes.data_as(ctypes.c_void_p),
            flat.ctypes.data_as(ctypes.c_void_p),
            # C writes the same clamp ragged_layout already computed.
            lengths.ctypes.data_as(ctypes.c_void_p),
            default_pack_threads() if n_threads is None else n_threads,
        )
    return flat, offs, lengths


def clean_bytes(data: bytes) -> bytes:
    """Byte-level strip+squash (ASCII whitespace only — Unicode whitespace
    such as NBSP passes through). Falls back to a byte regex when unbuilt."""
    lib = _load()
    if lib is None:
        import re

        sym = re.compile(rb'[/_\[\]*()%^&@$#:|{}<>~`"\\]')
        ws = re.compile(rb"\s+")
        return ws.sub(b" ", sym.sub(b"", data))
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(len(data), dtype=np.uint8)
    n = lib.clean_bytes(
        src.ctypes.data_as(ctypes.c_void_p), len(data),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out[:n].tobytes()


def ascii_lower(data: bytes) -> bytes:
    """Native ASCII lowercasing; multi-byte UTF-8 untouched."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8).copy()
    if lib is None:
        mask = (buf >= 65) & (buf <= 90)
        buf[mask] += 32
        return buf.tobytes()
    lib.ascii_lower(buf.ctypes.data_as(ctypes.c_void_p), len(buf))
    return buf.tobytes()


class RefScorer:
    """Compiled per-row reference scorer (``refscorer.cpp``): one hash-map
    probe per sliding window, float64 accumulate, first-max-wins argmax.
    An independent semantics cross-check of the port's scorers.

    Raises ``RuntimeError`` when the native library is unavailable: it is a
    measurement tool with no fallback (a fallback would time the wrong
    baseline)."""

    def __init__(self, keys, vecs: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable; the C++ scorer cannot run")
        self._lib = lib
        vecs = np.ascontiguousarray(vecs, dtype=np.float64)
        if vecs.ndim != 2 or vecs.shape[0] != len(keys):
            raise ValueError(
                f"vecs must be [len(keys), L]; got {vecs.shape} for {len(keys)} keys"
            )
        self.num_grams = len(keys)
        self.num_languages = int(vecs.shape[1])
        n = len(keys)
        ptrs = (ctypes.c_char_p * n)(*keys)
        lens = _lengths64(keys)
        self._handle = lib.ref_build(
            ptrs,
            lens.ctypes.data_as(ctypes.c_void_p),
            n,
            vecs.ctypes.data_as(ctypes.c_void_p),
            self.num_languages,
        )

    def score(self, byte_docs, gram_lengths, n_threads: int = 1) -> np.ndarray:
        """int32 [N] first-max-wins argmax labels."""
        if not self._handle:
            # After close() the C handle is gone; ref_score would
            # dereference NULL rather than raise.
            raise RuntimeError("RefScorer is closed")
        n = len(byte_docs)
        out = np.empty(n, dtype=np.int32)
        if n == 0:
            return out
        ptrs = (ctypes.c_char_p * n)(*byte_docs)
        lens = _lengths64(byte_docs)
        # Caller order preserved: the exact-agreement contract with a
        # per-row baseline requires the same accumulation order.
        gl = np.asarray(list(gram_lengths), dtype=np.int32)
        self._lib.ref_score(
            self._handle,
            ptrs,
            lens.ctypes.data_as(ctypes.c_void_p),
            n,
            gl.ctypes.data_as(ctypes.c_void_p),
            len(gl),
            out.ctypes.data_as(ctypes.c_void_p),
            n_threads,
        )
        return out

    def close(self):
        if self._handle:
            self._lib.ref_free(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the explicit path
        try:
            self.close()
        except Exception:
            pass
