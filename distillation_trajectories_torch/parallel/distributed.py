"""Process-group initialization and the global mesh (port of
``distillation_trajectories_tpu/parallel/distributed.py``).

JAX runs one process per host and ``jax.distributed.initialize`` joins
them; PyTorch runs one process per rank, joined in a
``torch.distributed`` process group.  :func:`initialize_distributed` reads
torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``) or explicit arguments, and is a no-op returning
``False`` in a single-process run, so every entry point can call it.

    torchrun --nproc_per_node=2 -m distillation_trajectories_torch.scripts.train_teacher \\
        --mesh 2,1 --device cpu
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import make_mesh


def choose_backend(local_world_size: int) -> str:
    """``nccl`` when every rank on this host has a card of its own, else
    ``gloo`` (CPU runs, and ranks that share one card: NCCL refuses two
    ranks on one GPU)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group when a launcher's environment (or the
    arguments) names one; ``False`` without either.

    ``coordinator_address`` is an init method (``tcp://host:port``) or a
    ``host:port``.  On CUDA the rank's device becomes ``LOCAL_RANK`` modulo
    the visible cards.  ``backend`` defaults to :func:`choose_backend`;
    the choice is printed.  Returns ``True`` when this process is (or
    already was) part of a process group.
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = backend or choose_backend(local_world)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=world, rank=rank)
    if rank == 0:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[distributed] {world} ranks, backend {backend} "
              f"({local_world} ranks on this host, {cards} visible cards)")
    return True


def is_main_process() -> bool:
    """Rank 0 of the process group, or a process outside any: the one
    that writes checkpoints, metrics and images."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (no-op outside one)."""
    if dist.is_initialized():
        dist.barrier()


def make_global_mesh(model_parallel: int = 1):
    """``(data, model)`` mesh over every rank of the process group, the
    model axis of size ``model_parallel``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not divide into model axis {model_parallel}")
    return make_mesh((world // model_parallel, model_parallel))
