"""Process-group setup (counterpart of
``speech_enhancement_by_s3prl_tpu/parallel/distributed.py``).

A data-parallel run of the port is one process a rank. The processes meet
through ``torch.distributed``: NCCL where a rank's device is a card, gloo on
the CPU. ``initialize_distributed`` reads the rendezvous from the standard
variables that ``torchrun`` sets (``MASTER_ADDR`` / ``MASTER_PORT`` /
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``) unless it is given one, and is a
no-op (False) for a single process.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# how long a collective (and the rendezvous) may wait for the other ranks
TIMEOUT = datetime.timedelta(seconds=300)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, device: str = "cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group of a multi-process run; False (and nothing
    done) for a single process, True once joined (or already joined).

    ``init_method`` defaults to ``env://`` when ``RANK`` and ``WORLD_SIZE``
    are set (``torchrun``), ``world_size`` / ``rank`` to those variables.
    ``device`` is the rank's device: on ``cuda`` the rank's current device
    becomes ``cuda:LOCAL_RANK`` (the rank when ``LOCAL_RANK`` is not set),
    and a local rank past this node's cards is refused; ``cuda:i`` names the
    card itself. The backend is NCCL on a card and gloo on ``cpu``.
    ``backend`` overrides that choice (two ranks that share one card, each
    given ``cuda:0``, need gloo, since NCCL refuses them)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return False
        init_method = "env://"
    world_size = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
    rank = int(env["RANK"]) if rank is None else int(rank)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a rank on cuda, but there is no CUDA device")
        card = int(env.get("LOCAL_RANK", rank)) if device.index is None else device.index
        if card >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} asks for card {card}, but this node shows "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(card)
        backend = backend or "nccl"
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=TIMEOUT)
    return True


def topology_summary() -> str:
    """One line: this process's rank of the group, the backend and the
    device it computes on."""
    if not dist.is_initialized():
        return "process 0/1 | no process group"
    device = f"cuda:{torch.cuda.current_device()}" if torch.cuda.is_available() else "cpu"
    return (f"process {dist.get_rank()}/{dist.get_world_size()} | {dist.get_backend()} | "
            f"{device}")
