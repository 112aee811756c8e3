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
named by a hash of their source and flags, so an edited source never loads a
stale build.
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
    raise RuntimeError(
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
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def build_command(self, out: Path) -> list[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if needed (raises on failure)."""
        with self._lock:
            if self._lib is None:
                if not self.library_path.is_file():
                    build_all([self])
                lib = ctypes.CDLL(str(self.library_path))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = self.restype
                err = lib.kernel_error_string
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
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc} ({msg})")
        self.launches += 1


def build_all(kernels, *, force: bool = False) -> dict[str, tuple[float, str]]:
    """Compile the kernels' sources, one ``nvcc`` process per source, all
    running at once. Returns (seconds, compiler output) per kernel built;
    raises with the compiler's output if any build fails. Already-built
    libraries are skipped unless ``force``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
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
    built: dict[str, tuple[float, str]] = {}
    failures = []
    for k, out, tmp, t0, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        built[k.name] = (time.perf_counter() - t0, log)
        if p.returncode != 0:
            failures.append(f"{k.name} ({k.source.name}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for\n" + "\n".join(failures))
    return built
