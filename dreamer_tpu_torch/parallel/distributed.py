"""Process-group initialisation over ``torch.distributed`` (the port of
``dreamer_tpu/parallel/distributed.py``).

One rank is one process on one device.  ``torchrun`` (``python -m
torch.distributed.run``) sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; a launcher of its
own sets the same.  Call ``init_distributed`` before anything touches CUDA;
it is a no-op when ``WORLD_SIZE`` is unset or 1.

Backends: ``nccl`` on CUDA devices, one card a rank; ``gloo`` on the CPU, and
on CUDA devices where ranks share a card (NCCL refuses two ranks on one
device, so that case must name ``gloo`` and is refused here otherwise).
Gloo takes CUDA tensors for the ops ``MeshPlan`` uses.  Every collective has
a finite timeout, ``DREAMER_DIST_TIMEOUT_S`` seconds (default 300), so a
rank that died stops the others with an error instead of a hang.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT_S = float(os.environ.get("DREAMER_DIST_TIMEOUT_S", 300))


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else _env_int("WORLD_SIZE", 1)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else _env_int("RANK", 0)


def local_rank() -> int:
    return _env_int("LOCAL_RANK", 0)


def local_world_size() -> int:
    return _env_int("LOCAL_WORLD_SIZE", world_size())


def hosts() -> int:
    """The hosts of the run: ``WORLD_SIZE / LOCAL_WORLD_SIZE``."""
    n, local = world_size(), local_world_size()
    if n % local:
        raise ValueError(f"WORLD_SIZE {n} is not a multiple of LOCAL_WORLD_SIZE {local}")
    return n // local


def is_primary() -> bool:
    """True on the rank that writes logs, metrics and the checkpoint's state."""
    return rank() == 0


def rank_device(device=None) -> Optional[torch.device]:
    """The device a rank runs on: ``device`` when named; else, in a world
    of more than one rank, ``cuda:{LOCAL_RANK}``; else None (the card)."""
    if device is not None:
        return torch.device(device)
    if _env_int("WORLD_SIZE", 1) > 1:
        return torch.device("cuda", local_rank())
    return None


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group that torchrun's variables describe; returns
    whether the world has more than one rank.  ``backend`` defaults to
    ``nccl`` for a CUDA device and ``gloo`` for the CPU; ``device`` is the
    rank's (``rank_device``)."""
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the port runs nccl or gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, this rank runs on {dev}")
        local_world, cards = local_world_size(), torch.cuda.device_count()
        index = dev.index if dev.index is not None else local_rank()
        if local_world > cards or index != local_rank():
            raise ValueError(
                f"NCCL refuses two ranks on one device: {local_world} ranks on this host, "
                f"{cards} CUDA device(s), local rank {local_rank()} on cuda:{index}; run one "
                "rank a card on cuda:{LOCAL_RANK}, or name the gloo backend "
                "(--dist-backend gloo) for ranks that share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else local_rank())
    dist.init_process_group(backend, init_method="env://", rank=_env_int("RANK", 0),
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
