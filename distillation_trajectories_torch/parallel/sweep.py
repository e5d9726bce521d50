"""The student sweep with every student training at once (port of
``distillation_trajectories_tpu/parallel/sweep.py``).

Students of different size factors are different architectures, so they
cannot share one batched graph.  JAX pins student *i* to device ``i % n``
and dispatches each student's step per batch without blocking.  Here
student *i* trains on ``devices[i % n]`` (default: every visible CUDA
device), each on a CUDA stream of its own, so the students' steps
interleave on the card; nothing synchronizes the host inside an epoch:
each student's losses stay on its device until the epoch barrier.

Each student gets what the sequential trainer
(``training/students.py::distill_diffusion_model``) gives it: its draw
source from ``seed + int(sf * 1000)``, the same batches in the same order
(one shared loader with the trainer's seed shuffles each epoch as a fresh
one would), the same checkpoints and the same end-of-training grids.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import DataLoader, load_dataset
from ..utils.profiling import MetricsLogger
from ..utils.viz import save_image_grid


class _StudentSlot:
    """One student's placement, stream and training context."""

    def __init__(self, size_factor: float, device: torch.device, built: dict):
        self.size_factor = size_factor
        self.device = device
        self.built = built
        self.state = built["state"]
        self.stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
        if self.stream is not None:  # after the model's initialization
            self.stream.wait_stream(torch.cuda.current_stream(device))
        self.losses: List[torch.Tensor] = []

    def on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()


def distill_students_parallel(
    config,
    teacher_model,
    size_factors: List[float],
    seed: int = 0,
    devices: Optional[List] = None,
    draws=None,
) -> Dict[float, torch.nn.Module]:
    """Distill every student of ``size_factors`` from ``teacher_model`` at
    once, student *i* on ``devices[i % len(devices)]``.  Returns
    ``{size_factor: model}`` as ``training.students.train_students`` does.
    ``draws`` is a factory ``(seed, device) -> draw source``."""
    from ..config import resolve_device
    from ..training.checkpoints import AsyncCheckpointWriter
    from ..training.state import TorchDraws
    from ..training.students import _build_student

    if devices is None:
        base = resolve_device(config.device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if base.type == "cuda" else [base])
    devices = [torch.device(d) for d in devices]
    print(f"[sweep] distilling {len(size_factors)} students over "
          f"{min(len(size_factors), len(devices))} devices (round-robin, one stream each)")

    teachers = {}
    slots: List[_StudentSlot] = []
    for i, sf in enumerate(size_factors):
        dev = devices[i % len(devices)]
        if dev not in teachers:
            teachers[dev] = teacher_model if _on(teacher_model, dev) else \
                _copy_to(teacher_model, dev)
        factory = lambda s, _d, dev=dev: (draws or TorchDraws)(s, dev)
        built = _build_student(teachers[dev], config, sf, seed, factory, device=dev)
        slots.append(_StudentSlot(sf, dev, built))

    images, labels = load_dataset(config)
    loader = DataLoader(images, labels, config.batch_size, shuffle=True, seed=seed)
    metrics_log = MetricsLogger(os.path.join(config.results_dir, "sweep_parallel_metrics.jsonl"))
    writer = AsyncCheckpointWriter()
    try:
        for epoch in range(config.epochs):
            t0 = time.time()
            for slot in slots:
                slot.losses = []
            for batch_idx, (batch, _) in enumerate(loader):
                if (config.limit_batches_per_epoch is not None
                        and batch_idx >= config.limit_batches_per_epoch):
                    break
                host = torch.from_numpy(batch)
                for slot in slots:
                    with slot.on_stream():
                        x = host.to(slot.device, non_blocking=True)
                        slot.state, loss = slot.built["train_step"](slot.state, x)
                        slot.losses.append(loss)
            # The epoch barrier: the one host synchronization.
            for slot in slots:
                if slot.stream is not None:
                    slot.stream.synchronize()
            dt = time.time() - t0
            for slot in slots:
                avg = (float(np.mean(torch.stack(slot.losses).cpu().numpy()))
                       if slot.losses else 0.0)
                print(f"[sweep sf={slot.size_factor}] epoch {epoch + 1}/{config.epochs} "
                      f"avg loss {avg:.6f} ({dt:.1f}s wall, shared)")
                metrics_log.log("epoch", epoch=epoch + 1, size_factor=slot.size_factor,
                                avg_loss=avg, seconds=dt)
            if (epoch + 1) % config.save_interval == 0 or epoch == config.epochs - 1:
                for slot in slots:
                    writer.save(config.student_dir(slot.size_factor), epoch + 1,
                                slot.state.model, optimizer=slot.state.optimizer)
        # End-of-training grids, as the sequential trainer draws them.
        for slot in slots if config.num_samples_to_generate > 0 else []:
            grid_fn = slot.built["grid_fn"]
            noise, step_noise = slot.built["draws"].sample(grid_fn.shape, grid_fn.n_steps)
            writer.submit(
                save_image_grid, grid_fn(noise, step_noise),
                os.path.join(config.results_dir,
                             f"student_samples_size_{slot.size_factor}_epoch_{config.epochs}.png"),
                config.samples_grid_size,
            )
    finally:
        metrics_log.close()
        writer.close()
    return {slot.size_factor: slot.state.model for slot in slots}


def _on(model: torch.nn.Module, device: torch.device) -> bool:
    on = next(model.parameters()).device
    return on.type == device.type and (device.index is None or on.index == device.index)


def _copy_to(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    import copy

    return copy.deepcopy(model).to(device)
