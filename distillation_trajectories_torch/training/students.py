"""Student distillation across size factors (port of
``distillation_trajectories_tpu/training/students.py``, without its
TPU-host machinery: AOT compile pool, watchdog, epoch scan, mesh).

Each student trains in turn from the teacher's latest checkpoint: per batch
two teacher forwards in eval mode and two student forwards plus one
backward in train mode.  Size factors that floor to the same architecture
(``Config.vmap_students``) train in sequence too; the JAX package trains
such a group as one vmapped graph with exactly these per-member semantics:
each member's own draw stream from ``seed + int(sf * 1000)`` and the same
loader order (a fresh loader with the trainer's seed per student).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from ..config import resolve_device
from ..data.datasets import DataLoader, load_dataset
from ..diffusion import get_diffusion_params
from ..models import load_unet_variables, make_unet, param_count
from ..utils.profiling import MetricsLogger, dump_phase_times, phase_timer, phase_times
from ..utils.viz import save_image_grid
from .checkpoints import (
    AsyncCheckpointWriter,
    checkpoint_path,
    latest_epoch,
    load_checkpoint,
    variables_from_checkpoint,
)
from .loop import check_supported, run_train_epoch
from .state import TorchDraws, create_train_state, make_distill_train_step
from .teacher import make_grid_fn


def print_size_factor_info(size_factors: List[float]) -> None:
    """Size-factor tier table with sf² parameter estimates (JAX
    ``training/students.py::print_size_factor_info``)."""
    param_counts = {sf: sf**2 for sf in size_factors}
    tiers = [("Tiny", [sf for sf in size_factors if sf < 0.1]),
             ("Small", [sf for sf in size_factors if 0.1 <= sf < 0.3]),
             ("Medium", [sf for sf in size_factors if 0.3 <= sf < 0.7]),
             ("Large", [sf for sf in size_factors if sf >= 0.7])]
    print("Student model size factors:")
    for category, factors in tiers:
        if factors:
            lo, hi = min(factors), max(factors)
            print(f"  {category}: {param_counts[lo]:.4f}x to {param_counts[hi]:.4f}x parameters")


def print_size_factor_info(size_factors: List[float]) -> None:
    """Size-factor tier table with sf² parameter estimates."""
    tiers = [
        ("Tiny", [sf for sf in size_factors if sf < 0.1]),
        ("Small", [sf for sf in size_factors if 0.1 <= sf < 0.3]),
        ("Medium", [sf for sf in size_factors if 0.3 <= sf < 0.7]),
        ("Large", [sf for sf in size_factors if sf >= 0.7]),
    ]
    print("Student model size factors:")
    for category, factors in tiers:
        if factors:
            lo, hi = min(factors), max(factors)
            print(f"  {category}: {lo ** 2:.4f}x to {hi ** 2:.4f}x parameters")


def load_teacher(config, epoch: Optional[int] = None):
    """The sf-1.0 teacher from ``config.teacher_models_dir`` (the latest
    checkpoint when ``epoch`` is None), in eval mode."""
    payload = load_checkpoint(config.teacher_models_dir, epoch)
    model = make_unet(config, size_factor=1.0)
    return load_unet_variables(model, variables_from_checkpoint(payload)).eval()


def _build_student(teacher_model, config, size_factor: float, seed: int, draws=None) -> dict:
    """The student model, its train state and step, and its grid function;
    the draw source is seeded from ``seed + int(size_factor * 1000)``."""
    device = resolve_device(config.device)
    source = (draws or TorchDraws)(seed + int(size_factor * 1000), device)
    model = source.init_unet(config, size_factor)
    train_step = make_distill_train_step(
        teacher_model, get_diffusion_params(config.teacher_steps, config),
        config.teacher_steps, config.student_steps,
    )
    grid_fn = make_grid_fn(model, config, get_diffusion_params(config.student_steps, config),
                           sample_steps=config.student_steps)
    return {"model": model, "state": create_train_state(model, config, source),
            "train_step": train_step, "grid_fn": grid_fn, "draws": source,
            "device": device}


def distill_diffusion_model(
    teacher_model,
    config,
    size_factor: float = 1.0,
    seed: int = 0,
    log_every: int = 50,
    ckpt_writer: Optional[AsyncCheckpointWriter] = None,
    loader: Optional[DataLoader] = None,
    draws=None,
):
    """Distill one student of ``size_factor`` from ``teacher_model``.

    ``ckpt_writer`` lets a sweep share one async writer; ``loader``
    defaults to a fresh loader of ``config``'s dataset with ``seed``;
    ``draws`` is a factory ``(seed, device) -> draw source``.  Returns the
    trained student.
    """
    check_supported(config)
    own_writer = ckpt_writer is None
    writer = ckpt_writer or AsyncCheckpointWriter()
    built = _build_student(teacher_model, config, size_factor, seed, draws)
    state = built["state"]
    teacher_mb = param_count(teacher_model) * 4 / 2**20
    student_mb = param_count(built["model"]) * 4 / 2**20
    print(f"Teacher model size: {teacher_mb:.2f} MB")
    print(f"Student model size: {student_mb:.2f} MB ({student_mb / teacher_mb:.2%} of teacher)")

    if loader is None:
        images, labels = load_dataset(config)
        loader = DataLoader(images, labels, config.batch_size, shuffle=True, seed=seed)
    metrics_log = MetricsLogger(
        os.path.join(config.results_dir, f"distill_metrics_size_{size_factor}.jsonl"))
    try:
        for epoch in range(config.epochs):
            t0 = time.time()
            with phase_timer(f"distill_epoch_sf{size_factor}"):
                state, avg_loss, _ = run_train_epoch(
                    state,
                    train_step=built["train_step"],
                    loader=loader,
                    config=config,
                    device=built["device"],
                    progress_desc=f"Distillation Epoch {epoch + 1}/{config.epochs}",
                    log_label=f"[distill sf={size_factor}] epoch {epoch + 1}",
                    log_every=log_every,
                    loss_fmt=".6f",
                )
            print(f"[distill sf={size_factor}] epoch {epoch + 1}/{config.epochs} "
                  f"avg loss {avg_loss:.6f} ({time.time() - t0:.1f}s)")
            metrics_log.log("epoch", epoch=epoch + 1, size_factor=size_factor,
                            avg_loss=avg_loss, seconds=time.time() - t0)

            if (epoch + 1) % config.save_interval == 0 or epoch == config.epochs - 1:
                writer.save(config.student_dir(size_factor), epoch + 1, state.model,
                            optimizer=state.optimizer)
                if epoch == config.epochs - 1 and config.num_samples_to_generate > 0:
                    # The sampling runs here; fetching and writing the PNG
                    # ride the writer's pool.
                    grid_fn = built["grid_fn"]
                    with phase_timer("students/grid"):
                        noise, step_noise = built["draws"].sample(grid_fn.shape, grid_fn.n_steps)
                        samples = grid_fn(noise, step_noise)
                    writer.submit(
                        save_image_grid, samples,
                        os.path.join(config.results_dir,
                                     f"student_samples_size_{size_factor}_epoch_{epoch + 1}.png"),
                        config.samples_grid_size,
                    )
    finally:
        metrics_log.close()
        if own_writer:
            writer.close()
    return state.model


def train_students(
    config,
    custom_size_factors: Optional[List[float]] = None,
    seed: int = 0,
    sweep_parallel: bool = False,
    skip_existing: bool = False,
    draws=None,
    teacher_epoch: Optional[int] = None,
) -> Dict[float, object]:
    """Distill a student for every size factor, in turn, from the latest
    teacher checkpoint.  Returns ``{size_factor: model}``.

    ``skip_existing=True`` loads instead of training every size factor
    whose final-epoch checkpoint exists and is no older than the teacher's
    latest (those models stay on the CPU).  ``sweep_parallel`` (one student
    per device) is not ported and raises.  ``teacher_epoch`` picks the
    teacher checkpoint (default: the latest).
    """
    if sweep_parallel:
        raise NotImplementedError("sweep_parallel: the multi-device sweep is not ported")
    check_supported(config)
    with phase_timer("students/teacher_load"):
        teacher = load_teacher(config, teacher_epoch)
    size_factors = custom_size_factors if custom_size_factors else config.student_size_factors

    preloaded: Dict[float, object] = {}
    if skip_existing:
        t_epoch = latest_epoch(config.teacher_models_dir)
        teacher_mtime = (
            os.path.getmtime(checkpoint_path(config.teacher_models_dir, t_epoch))
            if t_epoch is not None else 0.0
        )
        remaining = []
        for sf in size_factors:
            final = checkpoint_path(config.student_dir(sf), config.epochs)
            if os.path.exists(final) and os.path.getmtime(final) >= teacher_mtime:
                payload = load_checkpoint(config.student_dir(sf), config.epochs)
                preloaded[sf] = load_unet_variables(
                    make_unet(config, size_factor=sf, device="cpu"),
                    variables_from_checkpoint(payload))
                print(f"[students] sf={sf}: final checkpoint exists, skipping ({final})")
            else:
                remaining.append(sf)
        size_factors = remaining
        if not size_factors:
            print("[students] all requested sizes already trained")
            return preloaded

    print_size_factor_info(size_factors)
    with phase_timer("students/dataset"):
        images, labels = load_dataset(config)
    students: Dict[float, object] = {}
    writer = AsyncCheckpointWriter()
    try:
        for size_factor in size_factors:
            print(f"\nDistilling to student model with size factor {size_factor}...")
            students[size_factor] = distill_diffusion_model(
                teacher, config, size_factor=size_factor, seed=seed,
                ckpt_writer=writer, draws=draws,
                loader=DataLoader(images, labels, config.batch_size, shuffle=True, seed=seed),
            )
    finally:
        with phase_timer("students/ckpt_flush"):
            writer.close()
    summary = {k: round(v["total_s"], 1) for k, v in phase_times().items()
               if k.startswith("students/")}
    print(f"[students] phase totals (s): {summary}")
    dump_phase_times(os.path.join(config.results_dir, "students_phase_times.json"))
    students.update(preloaded)
    return students
