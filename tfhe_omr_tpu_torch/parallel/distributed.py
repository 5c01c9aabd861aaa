"""Multi-process launch helper.

PyTorch counterpart of :mod:`tfhe_omr_tpu.parallel.distributed`. Every
process runs the same script with the same ``--seed``, so each derives the
same keys; the clues are split over the ranks' devices by
:class:`~tfhe_omr_tpu_torch.parallel.mesh.ShardedDetector`, every rank keeps
its rows of the pertinency stack on its own devices, and the digests'
partial sums meet in one int64 ``all_reduce`` (NCCL between cards, gloo
between CPU processes). The key masks come from a ``torch.Generator`` on the
key's device, so the ranks' keys agree only when their devices are of one
kind.

Typical use, the same on every rank::

    from tfhe_omr_tpu_torch.parallel import distributed, make_data_mesh
    distributed.init("host0:29500", num_processes=4, process_id=rank)
    mesh = make_data_mesh()          # this rank's card and the process group
    sharded = ShardedDetector(detector, mesh)

Under ``torchrun`` the three arguments come from ``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``: call ``distributed.init()``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tfhe_omr_tpu_torch.utils.build import resolve_device

#: the devices :func:`init` gave this rank (None: no process group was made)
_local_devices: list[torch.device] | None = None


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None,
         device=None) -> int:
    """Join the process group (a no-op in a single process) and return the
    global device count, one device a rank.

    ``device`` is the kind of device the ranks run on: a card unless the
    caller names ``"cpu"``; with no card this raises. On cards rank ``i``
    takes card ``LOCAL_RANK`` (as ``torchrun`` sets it), else ``i`` modulo
    the visible cards, unless ``device`` names a card by its index
    (``"cuda:2"``), and the backend is ``nccl``; CPU ranks use ``gloo``.
    Arguments left out come from ``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.
    """
    global _local_devices
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    asked = torch.device("cuda" if device is None else device)
    if not coordinator_address or num_processes is None or process_id is None:
        return torch.cuda.device_count() if resolve_device(asked).type == "cuda" else 1
    if asked.type == "cuda" and asked.index is None and torch.cuda.is_available():
        # the rank's card is chosen before the device is resolved:
        # resolve_device would spell plain "cuda" out as the current card
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        asked = torch.device("cuda", local)
    dev = resolve_device(asked)  # raises where there is no card
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's communicator binds to the current card
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    _local_devices = [dev]
    return dist.get_world_size()


def local_devices() -> list[torch.device] | None:
    """The devices :func:`init` gave this rank, or None."""
    return _local_devices


def backend() -> str | None:
    """The process group's backend (``nccl`` or ``gloo``), or None."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def is_multihost() -> bool:
    """True when more than one process shares the work."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    global _local_devices
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _local_devices = None
