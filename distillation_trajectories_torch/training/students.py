"""Student distillation across size factors (port of
``distillation_trajectories_tpu/training/students.py``, without its
TPU-host machinery: AOT compile pool, watchdog).

Each student trains in turn from the teacher's latest checkpoint: per batch
two teacher forwards in eval mode and two student forwards plus one
backward in train mode.  On one device the sweep uploads the dataset once
and each student trains through the epoch lane (``state.make_distill_epoch_fn``;
a captured CUDA graph on the card) unless ``Config.epoch_scan`` is off or
``DTT_EPOCH_SCAN=0``.  There, size factors that floor to the same U-Net
(``Config.vmap_students``, not with ``checkpoint_sharded``) train as one
group step over a member axis (``state.make_multi_distill_epoch_fn``) with
the sequential semantics: each member's own draw stream from
``seed + int(sf * 1000)`` and the same loader order (a fresh loader with the
trainer's seed per student).  With ``Config.mesh_shape`` each student's
state and a copy of the teacher are sharded over the ``(data, model)``
mesh; ``sweep_parallel`` trains every student at once
(``parallel/sweep.py``).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..data.datasets import DataLoader, load_dataset
from ..diffusion import get_diffusion_params
from ..models import load_unet_variables, make_unet, param_count
from ..models.dit import require_unet
from ..models.unet import DiffusionUNet
from ..parallel.distributed import barrier
from ..parallel.mesh import mesh_from_config, shard_params, shard_train_state
from ..utils.profiling import MetricsLogger, dump_phase_times, phase_timer, phase_times
from ..utils.viz import save_image_grid
from .checkpoints import (
    AsyncCheckpointWriter,
    checkpoint_path,
    latest_epoch,
    load_checkpoint,
    save_epoch,
    variables_from_checkpoint,
)
from .loop import run_train_epoch, upload_dataset
from .state import (
    TorchDraws,
    create_train_state,
    epoch_scan_enabled,
    make_distill_epoch_fn,
    make_distill_train_step,
    make_multi_distill_epoch_fn,
    stack_train_states,
    unstack_train_state,
)
from .teacher import make_grid_fn


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


def _build_student(teacher_model, config, size_factor: float, seed: int, draws=None,
                   device=None) -> dict:
    """The student model, its train state and step (the per-batch one),
    and its grid function on ``device`` (default ``config.device``); the
    draw source is seeded from ``seed + int(size_factor * 1000)``."""
    device = resolve_device(config.device if device is None else device)
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
    dataset_dev=None,
):
    """Distill one student of ``size_factor`` from ``teacher_model``.

    ``ckpt_writer`` lets a sweep share one async writer; ``loader``
    defaults to a fresh loader of ``config``'s dataset with ``seed``;
    ``draws`` is a factory ``(seed, device) -> draw source``;
    ``dataset_dev``, the loader's images on the device, lets a sweep
    upload them once for the epoch lane.  Returns the trained student.
    """
    require_unet(teacher_model, "the distillation trainer")
    own_writer = ckpt_writer is None
    writer = ckpt_writer or AsyncCheckpointWriter()
    mesh = mesh_from_config(config)
    if mesh is not None and getattr(teacher_model, "mesh", None) is None:
        teacher_model = shard_params(copy.deepcopy(teacher_model), mesh)
    built = _build_student(teacher_model, config, size_factor, seed, draws)
    state = built["state"]
    if mesh is not None:
        state = built["state"] = shard_train_state(state, mesh)
        print(f"[distill sf={size_factor}] SPMD over mesh {mesh}")
    teacher_mb = param_count(teacher_model) * 4 / 2**20
    student_mb = param_count(built["model"]) * 4 / 2**20
    print(f"Teacher model size: {teacher_mb:.2f} MB")
    print(f"Student model size: {student_mb:.2f} MB ({student_mb / teacher_mb:.2%} of teacher)")

    if loader is None:
        images, labels = load_dataset(config)
        loader = DataLoader(images, labels, config.batch_size, shuffle=True, seed=seed)
    use_scan = epoch_scan_enabled(config, mesh)
    epoch_fn = None
    if use_scan:
        epoch_fn = make_distill_epoch_fn(
            teacher_model, get_diffusion_params(config.teacher_steps, config),
            config.teacher_steps, config.student_steps)
        if dataset_dev is None:
            with phase_timer("students/dataset_upload"):
                dataset_dev = upload_dataset(loader, built["device"])
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
                    use_scan=use_scan,
                    epoch_fn=epoch_fn,
                    dataset_dev=dataset_dev,
                )
            print(f"[distill sf={size_factor}] epoch {epoch + 1}/{config.epochs} "
                  f"avg loss {avg_loss:.6f} ({time.time() - t0:.1f}s)")
            metrics_log.log("epoch", epoch=epoch + 1, size_factor=size_factor,
                            avg_loss=avg_loss, seconds=time.time() - t0)

            if (epoch + 1) % config.save_interval == 0 or epoch == config.epochs - 1:
                save_epoch(writer, config, config.student_dir(size_factor), epoch + 1,
                           state.model, optimizer=state.optimizer)
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
                        config.samples_figure_size,
                    )
    finally:
        metrics_log.close()
        if own_writer:
            writer.close()
            barrier()
    return state.model


def _distill_group(teacher_model, config, size_factors: List[float], seed: int, writer,
                   loader: DataLoader, dataset_dev, draws=None) -> Dict[float, object]:
    """Train same-architecture students as one step over a member axis
    (JAX ``students.py::_distill_group_vmapped``): each member's metrics
    records, checkpoints and end-of-training grid keep the sequential
    trainer's contracts; the logged ``seconds`` is the group's epoch wall
    time (the members train together).  Returns ``{size_factor: model}``."""
    sfs = list(size_factors)
    builts = [_build_student(teacher_model, config, sf, seed, draws) for sf in sfs]
    states = stack_train_states([b["state"] for b in builts])
    epoch_fn = make_multi_distill_epoch_fn(
        teacher_model, get_diffusion_params(config.teacher_steps, config),
        config.teacher_steps, config.student_steps)
    logs = {sf: MetricsLogger(os.path.join(config.results_dir, f"distill_metrics_size_{sf}.jsonl"))
            for sf in sfs}
    print(f"[distill group {sfs}] one step over {len(sfs)} members of one architecture")
    try:
        for epoch in range(config.epochs):
            t0 = time.time()
            with phase_timer(f"distill_epoch_group{sfs}"):
                states, losses, _ = run_train_epoch(
                    states, train_step=None, loader=loader, config=config,
                    device=builts[0]["device"], progress_desc=f"distill group {sfs}",
                    log_label=f"[distill group {sfs}]", log_every=0, use_scan=True,
                    epoch_fn=epoch_fn, dataset_dev=dataset_dev, reduce_loss=False)
            secs = time.time() - t0
            for j, sf in enumerate(sfs):
                avg_loss = float(np.mean(losses[:, j])) if losses.size else 0.0
                print(f"[distill sf={sf}] epoch {epoch + 1}/{config.epochs} "
                      f"avg loss {avg_loss:.6f} ({secs:.1f}s group wall)")
                logs[sf].log("epoch", epoch=epoch + 1, size_factor=sf, avg_loss=avg_loss,
                             seconds=secs)
            if (epoch + 1) % config.save_interval == 0 or epoch == config.epochs - 1:
                for j, (sf, built) in enumerate(zip(sfs, builts)):
                    member = unstack_train_state(states, j)
                    save_epoch(writer, config, config.student_dir(sf), epoch + 1,
                               member.model, optimizer=member.optimizer)
                    if epoch == config.epochs - 1 and config.num_samples_to_generate > 0:
                        grid_fn = built["grid_fn"]
                        with phase_timer("students/grid"):
                            noise, step_noise = built["draws"].sample(grid_fn.shape,
                                                                      grid_fn.n_steps)
                            samples = grid_fn(noise, step_noise)
                        writer.submit(
                            save_image_grid, samples,
                            os.path.join(config.results_dir,
                                         f"student_samples_size_{sf}_epoch_{epoch + 1}.png"),
                            config.samples_grid_size,
                            config.samples_figure_size,
                        )
    finally:
        for log in logs.values():
            log.close()
    # The last epoch's save has unstacked every member into its model.
    return {sf: built["model"] for sf, built in zip(sfs, builts)}


def _architecture_groups(config, size_factors: List[float]) -> List[List[float]]:
    """The size factors that floor to one U-Net (``dims`` and
    ``time_emb_dim``), in first-seen order; groups of two or more."""
    by_arch: Dict[tuple, List[float]] = {}
    for sf in size_factors:
        with torch.device("meta"):
            m = DiffusionUNet(config.channels, size_factor=sf)
        by_arch.setdefault((tuple(m.dims), m.time_emb_dim), []).append(sf)
    return [sfs for sfs in by_arch.values() if len(sfs) > 1]


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
    latest (those models stay on the CPU).  ``sweep_parallel`` trains every
    student at once, student *i* on visible device ``i % n``
    (:func:`..parallel.sweep.distill_students_parallel`).  ``teacher_epoch``
    picks the teacher checkpoint (default: the latest).
    """
    require_unet(config, "the student trainer")
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
    if sweep_parallel:
        from ..parallel.sweep import distill_students_parallel

        if tuple(config.mesh_shape or (1, 1)) != (1, 1):
            print("[students] WARNING: sweep_parallel uses per-device student placement "
                  f"and ignores mesh_shape={tuple(config.mesh_shape)}; each student trains "
                  "unsharded on its own device. Drop --mesh or --sweep_parallel to get "
                  "SPMD sharding.")
        students = distill_students_parallel(config, teacher, size_factors, seed=seed,
                                             draws=draws)
        students.update(preloaded)
        return students
    with phase_timer("students/dataset"):
        images, labels = load_dataset(config)
    # Fresh loader views with the trainer's seed: each student's shuffle
    # stream starts again at epoch 1, as a loader of its own would.
    view = lambda: DataLoader(images, labels, config.batch_size, shuffle=True, seed=seed)
    dataset_dev, groups = None, []
    if epoch_scan_enabled(config, mesh_from_config(config)):
        with phase_timer("students/dataset_upload"):
            dataset_dev = upload_dataset(view(), resolve_device(config.device))
        if config.vmap_students and not config.checkpoint_sharded:
            groups = _architecture_groups(config, size_factors)
    group_of = {sf: g for g in groups for sf in g}
    students: Dict[float, object] = {}
    writer = AsyncCheckpointWriter()
    try:
        for size_factor in size_factors:
            if size_factor in students:
                continue  # trained in an earlier member's group
            print(f"\nDistilling to student model with size factor {size_factor}...")
            if size_factor in group_of:
                students.update(_distill_group(teacher, config, group_of[size_factor], seed,
                                               writer, view(), dataset_dev, draws))
                continue
            students[size_factor] = distill_diffusion_model(
                teacher, config, size_factor=size_factor, seed=seed,
                ckpt_writer=writer, draws=draws, loader=view(), dataset_dev=dataset_dev,
            )
    finally:
        with phase_timer("students/ckpt_flush"):
            writer.close()
        barrier()
    summary = {k: round(v["total_s"], 1) for k, v in phase_times().items()
               if k.startswith("students/")}
    print(f"[students] phase totals (s): {summary}")
    dump_phase_times(os.path.join(config.results_dir, "students_phase_times.json"))
    students.update(preloaded)
    return students
