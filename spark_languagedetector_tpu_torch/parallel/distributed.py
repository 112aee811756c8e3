"""Multi-process bring-up and host-level data distribution.

Port of ``spark_languagedetector_tpu.parallel.distributed``. Where the JAX
package brings up ``jax.distributed`` (one process per host, every device
in one mesh), the port runs one process per rank of a ``torch.distributed``
process group; the mesh of :mod:`.mesh` lays its grid over those ranks and
the modules of :mod:`.sharded` and :mod:`.sequence` call the collectives.

:func:`initialize` takes the group's address, size and this process's rank,
explicitly or through the ``tpu_coordinator``, ``tpu_num_processes`` and
``tpu_process_id`` knobs (``exec.config``; the JAX names and env
spellings). A rank's device is ``cuda:(rank % torch.cuda.device_count())``
(the ranks of one host), or the CPU when the caller asks for it. The
backend is NCCL when each rank has a card of its own and gloo otherwise: on
the CPU, and when ranks share a card (NCCL refuses two ranks of one group on
one GPU).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..exec import config as exec_config
from ..utils.device import resolve_device
from ..utils.logging import get_logger, log_event

_log = get_logger("parallel.distributed")

# This rank's device, set by initialize().
_RANK_DEVICE: list = [None]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device=None,
) -> None:
    """Join the process group (idempotent; a no-op for a single process).

    ``coordinator_address`` is the group's rendezvous: ``host:port`` (TCP)
    or a ``tcp://`` or ``file://`` URL. A single process — no address and
    one process or none named — logs ``distributed.single_process`` and
    does nothing; a one-process group with an address is a real group.
    ``backend`` None picks NCCL when the device is CUDA and the group has no
    more ranks than this host has cards, else gloo. ``device`` None is
    ``cuda:(process_id % device_count)`` (raises without a card); ``"cpu"``
    puts this rank on the host.
    """
    coordinator_address = exec_config.resolve("tpu_coordinator", explicit=coordinator_address)
    num_processes = exec_config.resolve("tpu_num_processes", explicit=num_processes)
    process_id = exec_config.resolve("tpu_process_id", explicit=process_id)
    if coordinator_address is None and num_processes in (None, 1):
        log_event(_log, "distributed.single_process")
        return
    if dist.is_initialized():
        log_event(_log, "distributed.already_initialized", rank=dist.get_rank(),
                  world_size=dist.get_world_size())
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs its coordinator address, number of processes "
            "and this process's id (arguments or LANGDETECT_TPU_COORDINATOR, "
            "LANGDETECT_TPU_NUM_PROCESSES, LANGDETECT_TPU_PROCESS_ID)"
        )
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, {num_processes})")
    if device is None:
        resolve_device(None)  # raises without a card
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    if backend is None:
        own_card = dev.type == "cuda" and num_processes <= torch.cuda.device_count()
        backend = "nccl" if own_card else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = (
        coordinator_address if "://" in coordinator_address
        else f"tcp://{coordinator_address}"
    )
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=num_processes,
        rank=process_id,
    )
    from .mesh import clear_meshes

    clear_meshes()
    _RANK_DEVICE[0] = dev
    log_event(
        _log, "distributed.initialized", process_index=dist.get_rank(),
        process_count=dist.get_world_size(), backend=dist.get_backend(),
        device=str(dev),
    )


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    from .mesh import clear_meshes

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    clear_meshes()
    _RANK_DEVICE[0] = None


def rank_device():
    """This rank's device as :func:`initialize` chose it; None before."""
    return _RANK_DEVICE[0]


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_shard(n_items: int) -> slice:
    """This process's contiguous shard of an n_items-long work list."""
    from .mesh import pad_to_multiple

    p, k = process_index(), process_count()
    per = pad_to_multiple(n_items, k) // k
    return slice(p * per, min((p + 1) * per, n_items))


def global_batch(local_batch, mesh) -> torch.Tensor:
    """The rows of every rank's ``local_batch`` along the mesh's data axis,
    concatenated in coordinate order, on every rank (a tensor on the mesh's
    device)."""
    from .mesh import DATA_AXIS

    t = torch.as_tensor(np.asarray(local_batch)).to(mesh.device)
    return mesh.all_gather(t, DATA_AXIS)
