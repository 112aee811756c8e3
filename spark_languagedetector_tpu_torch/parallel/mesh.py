"""The mesh: a grid of process-group ranks with a data and a vocab axis.

Port of ``spark_languagedetector_tpu.parallel.mesh``. Where the JAX package
lays ``jax.sharding.Mesh`` over devices and lets GSPMD place collectives,
the port lays a grid over the ranks of the ``torch.distributed`` default
group (one process per rank) and every module calls its collectives by
hand, in the same order on every rank:

  * ``"data"`` — document parallelism: a padded batch splits into
    contiguous row shards, one per data coordinate (:meth:`Mesh.shard_rows`);
  * ``"vocab"`` — the gram-id axis of a dense table: each vocab coordinate
    holds one stripe of rows.

Rank ``r`` of the grid sits at ``(r // vocab, r % vocab)``, as JAX reshapes
its device list. Each axis line (the ranks that share every other
coordinate) has its own subgroup; :meth:`Mesh.psum`, :meth:`Mesh.all_gather`,
:meth:`Mesh.reduce_scatter` and :meth:`Mesh.ring_shift` run over the line of
one axis. ``dist.new_group`` is itself collective, so :func:`build_mesh`
creates every line's group on every rank, in one order, members or not, and
keeps the mesh it built: the same call on every rank returns the same mesh
and creates nothing again.

A one-rank mesh is valid, as JAX's 1x1 mesh is. Without a process group its
collectives are identities; with a one-rank group they are real calls into
that group.

The collective backend is the default group's, decided once when the mesh
is built: NCCL when each rank has a card of its own
(``parallel.distributed.initialize`` chooses it then), gloo on the CPU and
when ranks share a card. Under gloo a CUDA tensor goes through pinned host
memory for each collective and then back to the card. The mesh logs its
backend and the world size once, when built.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import get_logger, log_event

DATA_AXIS = "data"
VOCAB_AXIS = "vocab"

_log = get_logger("parallel.mesh")

# torch 2.13 deprecates all_gather_into_tensor and reduce_scatter_tensor
# (a warning per call) for the *_single names, which older versions lack;
# both pairs take the same arguments.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class Mesh:
    """A ``data`` x ``vocab`` grid of ranks; see the module docstring.

    ``shape`` maps each axis to its size, as JAX's ``Mesh.shape`` does;
    ``ranks`` are the grid's global ranks in row-major order; ``coords``
    this rank's coordinates (None on a rank outside the grid); ``device``
    where this rank's tensors live; ``backend`` the group's backend, or
    None without a process group. Build meshes with :func:`build_mesh`.
    """

    def __init__(self, data: int, vocab: int, ranks: Sequence[int], rank: int,
                 device: torch.device, groups: dict | None, backend: str | None):
        self.shape = {DATA_AXIS: int(data), VOCAB_AXIS: int(vocab)}
        self.ranks = tuple(int(r) for r in ranks)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.backend = backend
        self._groups = groups
        self._lines: dict[str, tuple[int, ...]] = {}
        self.coords = None
        if self.rank in self.ranks:
            i = self.ranks.index(self.rank)
            d, v = divmod(i, self.shape[VOCAB_AXIS])
            self.coords = {DATA_AXIS: d, VOCAB_AXIS: v}
            self._lines = {
                DATA_AXIS: tuple(self.ranks[j * vocab + v] for j in range(data)),
                VOCAB_AXIS: tuple(self.ranks[d * vocab + j] for j in range(vocab)),
            }
        # Under gloo a CUDA tensor crosses through pinned host memory.
        self.staged = backend == "gloo" and self.device.type == "cuda"

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, vocab={self.shape[VOCAB_AXIS]}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[VOCAB_AXIS]

    def coord(self, axis: str) -> int:
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in this mesh {self.ranks}")
        return self.coords[axis]

    def line(self, axis: str) -> tuple[int, ...]:
        """Global ranks of this rank's line along ``axis``, in coordinate
        order."""
        self.coord(axis)
        return self._lines[axis]

    # -- row shards -------------------------------------------------------------
    def shard_rows(self, x, axis: str = DATA_AXIS):
        """This rank's contiguous shard of ``x``'s rows (a list, numpy array
        or tensor whose length divides by the axis size)."""
        n = self.shape[axis]
        rows = len(x) if not isinstance(x, torch.Tensor) else int(x.shape[0])
        if rows % n:
            raise ValueError(f"{rows} rows do not split over {axis}={n}")
        per = rows // n
        c = self.coord(axis)
        return x[c * per : (c + 1) * per]

    # -- collectives ------------------------------------------------------------
    def _group(self, axis: str):
        self.coord(axis)
        return None if self._groups is None else self._groups[axis]

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective reads: pinned host memory under gloo for
        a CUDA tensor, else ``t`` (contiguous)."""
        if self.staged and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        return t.contiguous()

    def _empty(self, shape, like: torch.Tensor) -> torch.Tensor:
        if self.staged and like.is_cuda:
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _out(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A collective's result back on ``like``'s device."""
        if t.device != like.device:
            return t.to(like.device, non_blocking=True)
        return t

    def psum(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """The sum of ``t`` over the ranks of this rank's ``axis`` line (a
        new tensor; ``t`` is left as it is)."""
        g = self._group(axis)
        if g is None:
            return t.clone()
        buf = self._in(t)
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g)
        return self._out(buf, t)

    def all_gather(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on dim 0 in
        coordinate order (the same on every rank of the line)."""
        g = self._group(axis)
        if g is None:
            return t
        n = self.shape[axis]
        src = self._in(t)
        out = self._empty((n * t.shape[0], *t.shape[1:]), t)
        _ALL_GATHER(out, src, group=g)
        return self._out(out, t)

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis``'s line of ``t`` [n·R, ...], scattered: this
        rank's chunk ``[c·R, (c+1)·R)`` of the sum (a new tensor)."""
        n = self.shape[axis]
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not reduce-scatter over {axis}={n}")
        g = self._group(axis)
        if g is None:
            return t.clone()
        src = self._in(t)
        out = self._empty((t.shape[0] // n, *t.shape[1:]), t)
        _REDUCE_SCATTER(out, src, op=dist.ReduceOp.SUM, group=g)
        return self._out(out, t)

    def ring_shift(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """One hop of a ring along ``axis``: send ``t`` to coordinate c+1 and
        return what coordinate c-1 sent (``batch_isend_irecv``)."""
        g = self._group(axis)
        line = self.line(axis)
        n = len(line)
        if g is None or n == 1:
            return t
        c = self.coord(axis)
        src = self._in(t)
        recv = self._empty(t.shape, t)
        ops = [
            dist.P2POp(dist.isend, src, line[(c + 1) % n], group=g),
            dist.P2POp(dist.irecv, recv, line[(c - 1) % n], group=g),
        ]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return self._out(recv, t)

    def barrier(self) -> None:
        """Every rank of the grid waits for the others (a no-op without a
        process group)."""
        if self._groups is not None:
            dist.barrier(group=self._groups["grid"])


_MESHES: dict[tuple, Mesh] = {}
_MESHES_LOCK = threading.Lock()


def clear_meshes() -> None:
    """Forget the built meshes (their groups belong to a process group that
    is being replaced)."""
    with _MESHES_LOCK:
        _MESHES.clear()


def build_mesh(
    data: int | None = None,
    vocab: int = 1,
    ranks: Sequence[int] | None = None,
    *,
    device=None,
) -> Mesh:
    """Mesh of shape (data, vocab) over the given (or all) ranks.

    ``ranks`` defaults to every rank of the initialised default group, or
    the one rank of a process without a group. ``data=None`` puts every
    remaining rank on the data axis. ``device`` defaults to this rank's
    device (``parallel.distributed.rank_device``), or the CUDA card without
    a group. Raises, as JAX does, when the ranks do not divide by ``vocab``
    or the grid needs more ranks than there are: a mesh never quietly
    shrinks. Every rank of the group must make the same calls in the same
    order (the subgroups are created collectively); a repeated call returns
    the mesh already built.
    """
    from ..utils.device import resolve_device
    from .distributed import rank_device

    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    ranks = list(range(world) if ranks is None else ranks)
    if data is None:
        if len(ranks) % vocab:
            raise ValueError(f"{len(ranks)} ranks not divisible by vocab={vocab}")
        data = len(ranks) // vocab
    if data * vocab > len(ranks):
        raise ValueError(
            f"mesh {data}x{vocab} needs {data * vocab} ranks, have {len(ranks)}"
        )
    grid = tuple(ranks[: data * vocab])
    if device is None:
        device = rank_device() if grouped else None
    device = resolve_device(device)
    key = (data, vocab, grid, str(device), grouped)
    with _MESHES_LOCK:
        mesh = _MESHES.get(key)
        if mesh is not None:
            return mesh
        groups = None
        backend = None
        if grouped:
            backend = dist.get_backend()
            # Every line of both axes, then the whole grid, on every rank in
            # one order: new_group is collective over the default group.
            mine: dict = {}
            for v in range(vocab):
                members = [grid[d * vocab + v] for d in range(data)]
                g = dist.new_group(members)
                if rank in members:
                    mine[DATA_AXIS] = g
            for d in range(data):
                members = [grid[d * vocab + v] for v in range(vocab)]
                g = dist.new_group(members)
                if rank in members:
                    mine[VOCAB_AXIS] = g
            g = dist.new_group(list(grid))
            if rank in grid:
                mine["grid"] = g
            groups = mine
        mesh = Mesh(data, vocab, grid, rank, device, groups, backend)
        _MESHES[key] = mesh
    log_event(
        _log, "mesh.built", data=data, vocab=vocab, world_size=world,
        backend=backend, staged=mesh.staged, device=str(device),
    )
    return mesh


def table_axis(mesh: Mesh) -> str:
    """The mesh axis that stripes [V, L] count and weight tables for the
    fit: the vocab axis when it has more than one rank, else the data axis
    (a data-only fit mesh still stripes its table, so each rank's finalize
    covers V/ndata rows)."""
    return VOCAB_AXIS if int(mesh.shape[VOCAB_AXIS]) > 1 else DATA_AXIS


def table_shards(mesh: Mesh) -> int:
    return int(mesh.shape[table_axis(mesh)])


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def pad_rows_for_mesh(docs: list, ndata: int, *fill_lists):
    """Pad a doc list (and parallel per-row metadata lists) to a multiple of
    the data-axis size with empty rows. Empty docs (length 0) contribute
    nothing to scoring or counting, so pad rows are semantically inert; the
    caller drops their output rows. Returns (docs, *fill_lists) extended.

    ``fill_lists`` are (list, pad_value) pairs.
    """
    short = len(docs) % ndata
    if not short:
        return (docs, *[lst for lst, _ in fill_lists])
    pad = ndata - short
    out = [docs + [b""] * pad]
    for lst, value in fill_lists:
        if isinstance(lst, np.ndarray):
            out.append(np.concatenate([lst, np.full(pad, value, lst.dtype)]))
        else:
            out.append(list(lst) + [value] * pad)
    return tuple(out)
