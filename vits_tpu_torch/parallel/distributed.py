"""Multi-process start-up over ``torch.distributed``.

Counterpart of ``vits_tpu/parallel/distributed.py``. One process per card
(NCCL), or per CPU process (gloo): call :func:`initialize` once per process
before the first collective; :func:`is_primary` picks the one process that
writes checkpoints and logs. Under ``torchrun`` every argument comes from its
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``), as JAX discovers a TPU pod from its metadata server.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    heartbeat_timeout_seconds: Optional[int] = None,
    *,
    device,
    backend: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` over TCP at ``coordinator_address``
    (``host:port``; None: torchrun's ``MASTER_ADDR:MASTER_PORT``, with its
    ``WORLD_SIZE`` and ``RANK`` for the arguments left None).

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU: the
    caller's device decides (``device="cuda"`` without a card raises).
    ``backend="gloo"`` on a CUDA device runs several ranks on one card, which
    NCCL refuses; gloo carries ``all_reduce`` and ``broadcast`` of CUDA tensors
    through the host.

    ``heartbeat_timeout_seconds`` is the process group's timeout: a collective
    whose peer stops answering raises after it. Deployments that want the
    training-level watchdog (train/watchdog.py) to decide first -- it also
    catches a process that is alive but making no training progress, which
    the process group cannot see -- should set this above the watchdog's
    ``stall_seconds``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}, but no CUDA device is visible")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    kwargs = {}
    if heartbeat_timeout_seconds is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=heartbeat_timeout_seconds)
    if backend == "nccl":  # bound to this process's card
        kwargs["device_id"] = local_device(device)
        torch.cuda.set_device(kwargs["device_id"])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, **kwargs)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that should write checkpoints/logs."""
    return process_index() == 0


def local_device(device) -> torch.device:
    """This process's card, ``cuda:LOCAL_RANK`` (torchrun's; 0 where unset), for a
    CUDA ``device``; other devices as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
