"""Teacher training (port of ``distillation_trajectories_tpu/training/
teacher.py``, without its TPU-host machinery: AOT compile pool, watchdog).

The sf-1.0 U-Net trains with the teacher step on ``config.device``: on
one device through the epoch lane (the dataset uploaded once, each epoch
one call of ``state.make_teacher_epoch_fn``; a captured CUDA graph on the
card) unless ``Config.epoch_scan`` is off or ``DTT_EPOCH_SCAN=0``, else
through the per-batch loop;
checkpoints go to ``model_epoch_{e}.msgpack`` (``.dcp`` with
``Config.checkpoint_sharded``) every ``save_interval`` epochs and after
the last, and each save also writes a sample grid
``samples_epoch_{e}.png`` drawn with ``p_sample_loop``.  With
``Config.mesh_shape`` the state is sharded over the ``(data, model)`` mesh
(``parallel.shard_train_state``); every rank samples the grid, rank 0
alone writes files, and the others wait for it at the end.
"""

from __future__ import annotations

import os
import time

from ..config import resolve_device
from ..data import get_data_loader
from ..diffusion import get_diffusion_params, subsampled_timestep_indices
from ..diffusion.sampling import make_loop_fn
from ..parallel.distributed import barrier, is_main_process
from ..parallel.mesh import mesh_from_config, shard_train_state
from ..utils.profiling import MetricsLogger
from ..utils.graphs import sampler_lane_captures
from ..utils.viz import save_image_grid
from .checkpoints import AsyncCheckpointWriter, save_epoch
from .loop import run_train_epoch, upload_dataset
from .state import (
    TorchDraws,
    create_train_state,
    epoch_scan_enabled,
    make_eval_model_fn,
    make_teacher_epoch_fn,
    make_teacher_train_step,
)


def make_grid_fn(model, config, diffusion_params, sample_steps=None):
    """``grid_fn(noise, step_noise, params=None) -> samples``: the
    ``config.num_samples_to_generate``-image sample grid of ``model`` (or
    of ``params``, e.g. EMA weights) by ``p_sample_loop`` in
    ``config.sample_mode``.  ``grid_fn.shape`` and ``grid_fn.n_steps`` give
    the draws it takes.  The counterpart of JAX's jitted grid, which takes
    the variables as arguments: on the card (a model not sharded over a
    mesh) its loop is captured on the second call and replayed, with the
    weights given (or the model's own, which training changes in place)
    (:func:`..diffusion.sampling.make_loop_fn`)."""
    sample_steps = config.sample_steps if sample_steps is None else sample_steps
    shape = (config.num_samples_to_generate, config.image_size, config.image_size,
             config.channels)
    loop = make_loop_fn(
        lambda params: make_eval_model_fn(model, params), shape, sample_steps,
        diffusion_params, num_timesteps=config.timesteps, mode=config.sample_mode,
        captures=lambda device: sampler_lane_captures(device, model))

    def grid_fn(noise, step_noise, params=None):
        return loop(noise, step_noise, params)

    grid_fn.shape = shape
    grid_fn.n_steps = len(subsampled_timestep_indices(sample_steps, config.timesteps))
    grid_fn.loop = loop
    return grid_fn


def save_grid(grid_fn, draws, path, config, params=None) -> None:
    """Draw one grid's noise from ``draws`` — on every save, as the JAX
    trainers split a sample key on every save — and, when the grid has
    images, sample it (on every rank of a mesh) and write it (rank 0)."""
    noise, step_noise = draws.sample(grid_fn.shape, grid_fn.n_steps)
    if config.num_samples_to_generate > 0:
        samples = grid_fn(noise, step_noise, params)
        if is_main_process():
            save_image_grid(samples, path, nrow=config.samples_grid_size,
                            figsize=config.samples_figure_size)


def generate_sample_grid(model, config, diffusion_params, draws, path) -> None:
    """Sample a ``config.num_samples_to_generate``-image grid of ``model``
    and write it as a PNG (JAX ``training/teacher.py::generate_sample_grid``);
    ``draws``, a draw source such as :class:`.state.TorchDraws`, gives its
    noise.  No-op for a grid of 0 images."""
    if config.num_samples_to_generate <= 0:
        return
    save_grid(make_grid_fn(model, config, diffusion_params), draws, path, config)


def train_teacher(config, seed: int = 0, log_every: int = 50, draws=None):
    """Train the teacher (size_factor=1.0) on ``config.device``.

    ``draws`` is a factory ``(seed, device) -> draw source`` (default
    :class:`..state.TorchDraws`), which initialises the model and supplies
    every step's and grid's random inputs.  Returns the final
    :class:`..state.TrainState`.
    """
    device = resolve_device(config.device)
    source = (draws or TorchDraws)(seed, device)
    diffusion_params = get_diffusion_params(config.timesteps, config)
    model = source.init_unet(config, 1.0)
    state = create_train_state(model, config, source, use_ema=config.use_ema)
    mesh = mesh_from_config(config)
    if mesh is not None:
        state = shard_train_state(state, mesh)
        print(f"[teacher] SPMD over mesh {mesh}")
    ema_rate = config.ema_rate if config.use_ema else None
    use_scan = epoch_scan_enabled(config, mesh)
    train_step = epoch_fn = dataset_dev = None
    if use_scan:
        epoch_fn = make_teacher_epoch_fn(diffusion_params, config.timesteps, ema_rate=ema_rate)
    else:
        train_step = make_teacher_train_step(diffusion_params, config.timesteps,
                                             ema_rate=ema_rate)
    grid_fn = make_grid_fn(model, config, diffusion_params)

    loader = get_data_loader(config, seed=seed)
    if use_scan:
        dataset_dev = upload_dataset(loader, device)
    print(f"[teacher] dataset={config.dataset} size={config.image_size} "
          f"batches/epoch={len(loader)} epochs={config.epochs}")
    metrics_log = MetricsLogger(os.path.join(config.results_dir, "teacher_metrics.jsonl"))
    ckpt_writer = AsyncCheckpointWriter()
    try:
        for epoch in range(config.epochs):
            t0 = time.time()
            state, avg_loss, n_batches = run_train_epoch(
                state,
                train_step=train_step,
                loader=loader,
                config=config,
                device=device,
                progress_desc=f"Epoch {epoch + 1}/{config.epochs}",
                log_label=f"[teacher] epoch {epoch + 1}/{config.epochs}",
                log_every=log_every,
                loss_fmt=".5f",
                use_scan=use_scan,
                epoch_fn=epoch_fn,
                dataset_dev=dataset_dev,
            )
            dt = time.time() - t0
            print(f"[teacher] epoch {epoch + 1}/{config.epochs} "
                  f"avg loss {avg_loss:.5f} ({dt:.1f}s)")
            metrics_log.log("epoch", epoch=epoch + 1, avg_loss=avg_loss, seconds=dt,
                            steps=n_batches)

            if (epoch + 1) % config.save_interval == 0 or epoch == config.epochs - 1:
                save_epoch(ckpt_writer, config, config.teacher_models_dir, epoch + 1,
                           state.model, optimizer=state.optimizer, ema=state.ema)
                save_grid(grid_fn, source,
                          os.path.join(config.results_dir, f"samples_epoch_{epoch + 1}.png"),
                          config, params=state.ema)
    finally:
        metrics_log.close()
        ckpt_writer.close()
    barrier()
    return state
