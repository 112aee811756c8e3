"""Host staging: pinned buffers for the copies to and from the card.

The torch form of the JAX package's asynchronous ``jax.device_put`` and
``copy_to_host_async``:

* :class:`HostStaging` keeps a small ring of pinned host buffers per size
  class. A batch is packed straight into numpy views of one buffer
  (:meth:`HostStaging.take`), so there is no second host copy, and the
  whole buffer goes to the card in one ``non_blocking`` copy on the current
  stream (:meth:`Staged.to_device`). A CUDA event is recorded after the
  copy, and the buffer is handed out again only once that event has
  completed: a buffer refilled while its copy is still in flight would
  corrupt a batch without raising.
* :func:`copy_to_host_async` starts a result's copy into pinned memory with
  its own event; :func:`host_numpy` reads it only after the event has
  synchronized.
* :func:`upload` sends a runner's table to its device the same way, through
  a pinned buffer and one ``non_blocking`` copy; the tables of a baked
  artifact page in from their read-only mapping there.

Every kernel of the port launches on the current stream, which is also the
stream of these copies, so no cross-stream ordering is needed. Pinned
memory is allocated only when the device is CUDA; on the CPU the same code
hands out plain tensors, never recycled (the "device" tensors are the host
buffer itself, so reusing it would let a later batch overwrite an earlier
one's operands).
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

# Byte alignment of each field inside a staged buffer: int32 views need 4,
# the kernels' vector loads 16; 64 keeps every field on its own cache line.
_ALIGN = 64
# Smallest size class (bytes); buffers are sized to the next power of two.
_MIN_CLASS = 1 << 16
# Buffers kept per size class: the batches a pipeline has in flight (the
# runner's dispatch workers, the fit packer's prefetch depth) plus the one
# being packed.
RING_DEPTH = 4

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32}


def _layout(fields) -> tuple[list[tuple[str, np.dtype, tuple, int, int]], int]:
    """[(name, dtype, shape, offset, nbytes)], total bytes."""
    out = []
    off = 0
    for name, dtype, shape in fields:
        dtype = np.dtype(dtype)
        shape = tuple(int(x) for x in shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out.append((name, dtype, shape, off, nbytes))
        off += -(-nbytes // _ALIGN) * _ALIGN
    return out, max(off, _ALIGN)


class Staged:
    """One batch's host buffer, taken from a :class:`HostStaging`.

    ``views`` maps each field name to a numpy view of the buffer: pack into
    those, then :meth:`to_device`, which hands the buffer back to the ring
    behind its copy's event. Pack inside a ``with`` block: a pack that
    raises returns the buffer at once (there is no copy to wait for)."""

    __slots__ = ("_ring", "_key", "_buf", "_layout", "_used", "views", "_done")

    def __init__(self, ring: "HostStaging", key: int | None, buf: torch.Tensor, layout, used: int):
        self._ring, self._key, self._buf = ring, key, buf
        self._layout, self._used = layout, used
        host = buf.numpy()
        self.views = {
            name: host[off : off + nbytes].view(dtype).reshape(shape)
            for name, dtype, shape, off, nbytes in layout
        }
        self._done = False

    def to_device(self) -> dict[str, torch.Tensor]:
        """The fields as tensors on the ring's device: one ``non_blocking``
        copy of the used bytes on the current stream, an event recorded
        after it, and the buffer back in the ring behind that event."""
        ring = self._ring
        if ring.pinned:
            dev = self._buf[: self._used].to(ring.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(ring.device))
            self._release(event)
        else:
            dev = self._buf
            self._done = True  # a CPU buffer is never handed out again
        return {
            name: dev[off : off + nbytes].view(_TORCH_DTYPES[dtype]).view(shape)
            for name, dtype, shape, off, nbytes in self._layout
        }

    def _release(self, event) -> None:
        if not self._done:
            self._done = True
            if self._key is not None:
                self._ring._give_back(self._key, self._buf, event)

    def __enter__(self) -> "Staged":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self._release(None)


class HostStaging:
    """A ring of pinned host buffers per size class (power-of-two bytes),
    for one device. :data:`RING_DEPTH` buffers per class are kept; a
    ``take`` finds one whose copy has completed, allocates while the class
    holds fewer, and otherwise waits on the oldest copy (counted in
    ``waits``). Thread-safe: dispatch workers take and return concurrently.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self._lock = threading.Lock()
        self._free: dict[int, list[tuple[torch.Tensor, object]]] = {}
        self._count: dict[int, int] = {}
        self.pinned_bytes = 0
        self.waits = 0

    def take(self, fields: Sequence[tuple[str, object, tuple]]) -> Staged:
        """A buffer holding ``fields`` ((name, numpy dtype, shape) each,
        laid out in order, 64-byte aligned)."""
        layout, total = _layout(fields)
        if not self.pinned:
            return Staged(self, None, torch.empty(total, dtype=torch.uint8), layout, total)
        key = max(_MIN_CLASS, 1 << (total - 1).bit_length())
        wait = None
        with self._lock:
            free = self._free.setdefault(key, [])
            for i, (buf, event) in enumerate(free):
                if event is None or event.query():
                    del free[i]
                    return Staged(self, key, buf, layout, total)
            if free and self._count.get(key, 0) >= RING_DEPTH:
                buf, wait = free.pop(0)  # the oldest copy
                self.waits += 1
            else:
                buf = torch.empty(key, dtype=torch.uint8, pin_memory=True)
                self._count[key] = self._count.get(key, 0) + 1
                self.pinned_bytes += key
        if wait is not None:
            wait.synchronize()
        return Staged(self, key, buf, layout, total)

    def _give_back(self, key: int, buf: torch.Tensor, event) -> None:
        with self._lock:
            self._free.setdefault(key, []).append((buf, event))


def copy_to_host_async(t: torch.Tensor):
    """Start ``t``'s copy to host memory: ``(host tensor, event)``, the event
    None for a CPU tensor (which is its own host copy). Read the host tensor
    only through :func:`host_numpy`."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def host_numpy(started) -> np.ndarray:
    """The numpy value of a copy started by :func:`copy_to_host_async`,
    after its event has synchronized."""
    host, event = started
    if event is not None:
        event.synchronize()
    return host.numpy()


def upload(arr, device) -> torch.Tensor:
    """A host table as a tensor on ``device``, read from ``arr`` and never
    written through it.

    On the card: ``arr`` is copied into a pinned buffer (a baked artifact's
    read-only ``np.memmap`` pages in here) and the buffer to the card in one
    ``non_blocking`` copy on the current stream; the caching host allocator
    keeps the buffer until that copy has run. On the CPU: ``arr`` itself
    when it is writable, else a copy of it, so a CPU tensor never aliases a
    read-only mapping (a write through one would fault)."""
    arr = np.ascontiguousarray(arr)
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    dtype = torch.from_numpy(np.empty(0, dtype=arr.dtype)).dtype
    host = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = arr
    return host.to(dev, non_blocking=True)
