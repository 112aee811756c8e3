"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, which is loaded with ``ctypes``: pointers
come from ``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``, all passed as ``c_void_p``.
Nothing but the repository's own sources goes into the build, and nothing
is compiled at import time: the first call that launches a kernel builds it
(or :func:`build_all` builds every kernel at once, one ``nvcc`` per source,
all started together).

Libraries land in ``build/kernels/`` at the root of a source checkout, or,
for an installed package, in a per-user cache directory; either way they are
named by a hash of their source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"


class KernelBuildError(RuntimeError):
    """A kernel could not be built or loaded: no ``nvcc``, a failed
    compile, or an ``OSError`` / missing symbol while writing the build
    directory, starting the compiler or loading the library. Not retryable:
    the runner's retry policy and degradation ladder let it through, since
    replaying cannot make it build."""


class KernelLaunchError(RuntimeError):
    """A kernel's launch returned a CUDA error. Not retryable, for the same
    reason, and because a CUDA error is sticky for the context."""


def _build_dir() -> Path:
    """``build/kernels/`` of the source checkout holding the package, else
    ``$XDG_CACHE_HOME`` (default ``~/.cache``) for an installed package."""
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "kernels"
    cache = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache")
    return cache / "spark_languagedetector_tpu_torch" / "kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, in the build log
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels are built from csrc/ on first use"
    )


class CudaKernel:
    """One kernel: its source, its C entry point and a launch counter.

    ``launches`` counts successful launches made by the wrapper that owns
    this kernel (it adds one right after each launch and nowhere else), so a
    run can show that its path really went through the kernel.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes, restype):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.restype = restype
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    @property
    def library_path(self) -> Path:
        # The shared headers beside the source count too: it may include any.
        headers = b"".join(h.read_bytes() for h in sorted(self.source.parent.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def build_command(self, out: Path) -> list[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if needed. Every failure on the
        way raises :class:`KernelBuildError`."""
        with self._lock:
            if self._lib is None:
                try:
                    path = self.library_path
                    if not path.is_file():
                        build_all([self])
                    lib = ctypes.CDLL(str(path))
                    fn = getattr(lib, self.symbol)
                    err = lib.kernel_error_string
                except KernelBuildError:
                    raise
                except (OSError, AttributeError) as e:
                    raise KernelBuildError(f"{self.name}: cannot load its library: {e!r}") from e
                fn.argtypes = self.argtypes
                fn.restype = self.restype
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def launch(self, *args) -> None:
        """Call the C entry point; it launches on the given stream and
        returns ``cudaGetLastError()``, which must be 0."""
        lib = self.library()
        rc = getattr(lib, self.symbol)(*args)
        if rc != 0:
            msg = lib.kernel_error_string(rc).decode()
            raise KernelLaunchError(f"{self.name} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1


def check_operand(kernel: str, t, name: str, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D ``dtype`` tensor on
    ``device`` (what a kernel's C entry point assumes of every operand)."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


_p = ctypes.c_void_p
_i = ctypes.c_int

# Every kernel of the port. Each C entry point takes device pointers, sizes
# and the stream, launches, and returns cudaGetLastError().
FUSED_DETECT = CudaKernel(
    "fused_detect",
    "fused_detect.cu",
    "fused_detect_launch",
    [_p] * 10 + [_i] * 8 + [ctypes.POINTER(_i)] * 2
    + [ctypes.POINTER(ctypes.c_uint)] * 2 + [_p],
    _i,
)
# batch, lengths, lim, prow, rows, wq, scales, out; B, S, cell, C, K, W, R, L,
# dtype, n_inline; the inline plan's four arrays; stream
FUSED_SEGMENT = CudaKernel(
    "fused_segment",
    "fused_segment.cu",
    "fused_segment_launch",
    [_p] * 8 + [_i] * 10 + [ctypes.POINTER(_i)] * 2
    + [ctypes.POINTER(ctypes.c_uint)] * 2 + [_p],
    _i,
)
# rows, vmax, out; B, K, W, R, miss; stream
ROW_HIST = CudaKernel(
    "row_hist", "row_hist.cu", "row_hist_launch", [_p] * 3 + [_i] * 5 + [_p], _i
)
# batch, lengths, lim, out; B, S, mask_n; stream
BIGRAM_HIST = CudaKernel(
    "bigram_hist", "bigram_hist.cu", "bigram_hist_launch",
    [_p] * 4 + [_i] * 3 + [_p], _i,
)
# batch, lengths, lim, w1, w2, out; B, S, L, has1, has2; stream
BIGRAM_SCORE = CudaKernel(
    "bigram_score", "bigram_score.cu", "bigram_score_launch",
    [_p] * 6 + [_i] * 5 + [_p], _i,
)
KERNELS = (FUSED_DETECT, FUSED_SEGMENT, ROW_HIST, BIGRAM_HIST, BIGRAM_SCORE)


def build_all(
    kernels=KERNELS, *, force: bool = False
) -> dict[str, tuple[float, str]]:
    """Compile the kernels' sources (by default every kernel of the port),
    one ``nvcc`` process per source, all running at once. Returns (seconds,
    compiler output) per kernel built; raises with the compiler's output if
    any build fails. Already-built libraries are skipped unless ``force``.
    Every failure raises :class:`KernelBuildError`; compilers already
    started are waited for first."""
    procs = []
    built: dict[str, tuple[float, str]] = {}
    failures = []
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for k in kernels:
            out = k.library_path
            if out.is_file() and not force:
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            procs.append(
                (
                    k, out, tmp, time.perf_counter(),
                    subprocess.Popen(
                        k.build_command(tmp),
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    ),
                )
            )
    except (OSError, KernelBuildError) as e:
        failures.append(f"cannot start the build: {e}")
    for k, out, tmp, t0, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        built[k.name] = (time.perf_counter() - t0, log)
        if p.returncode != 0:
            failures.append(f"{k.name} ({k.source.name}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        try:
            os.replace(tmp, out)
        except OSError as e:
            failures.append(f"{k.name}: cannot move its library into place: {e!r}")
    if failures:
        raise KernelBuildError("kernel build failed for\n" + "\n".join(failures))
    return built
