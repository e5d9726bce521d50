"""Resume teacher training from a checkpoint epoch (port of
``distillation_trajectories_tpu/training/continue_training.py``).

Weights, BatchNorm statistics and, when the checkpoint has them, the Adam
moments are restored from a checkpoint written by either package (or the
port's sharded lane); epochs continue as ``model_epoch_{start + i}``,
through the epoch lane on one device as in :mod:`.teacher`.  With
``Config.mesh_shape`` the restored state is sharded over the mesh.
"""

from __future__ import annotations

import os
import time

from ..config import resolve_device
from ..data import get_data_loader
from ..diffusion import get_diffusion_params
from ..models import load_optax_adam_state, load_unet_variables, make_unet
from ..parallel.distributed import barrier
from ..parallel.mesh import mesh_from_config, shard_train_state
from .checkpoints import AsyncCheckpointWriter, load_checkpoint, save_epoch, variables_from_checkpoint
from .loop import run_train_epoch, upload_dataset
from .state import (
    TorchDraws,
    create_train_state,
    epoch_scan_enabled,
    make_teacher_epoch_fn,
    make_teacher_train_step,
)
from .teacher import make_grid_fn, save_grid


def continue_training(config, start_epoch: int, seed: int = 0, log_every: int = 50, draws=None):
    """Train ``config.epochs`` further epochs from
    ``model_epoch_{start_epoch}`` in ``config.teacher_models_dir``.

    The draw source and the loader are seeded from ``seed + start_epoch``;
    ``draws`` is a factory ``(seed, device) -> draw source``.  Returns the
    final :class:`..state.TrainState`.
    """
    device = resolve_device(config.device)
    source = (draws or TorchDraws)(seed + start_epoch, device)
    payload = load_checkpoint(config.teacher_models_dir, start_epoch)
    model = load_unet_variables(make_unet(config, size_factor=1.0, device=device),
                                variables_from_checkpoint(payload))
    state = create_train_state(model, config, source)
    if "opt_state" in payload:
        load_optax_adam_state(model, state.optimizer, payload["opt_state"])
    mesh = mesh_from_config(config)
    if mesh is not None:
        state = shard_train_state(state, mesh)
        print(f"[continue] SPMD over mesh {mesh}")

    diffusion_params = get_diffusion_params(config.timesteps, config)
    loader = get_data_loader(config, seed=seed + start_epoch)
    use_scan = epoch_scan_enabled(config, mesh)
    train_step = epoch_fn = dataset_dev = None
    if use_scan:
        epoch_fn = make_teacher_epoch_fn(diffusion_params, config.timesteps)
        dataset_dev = upload_dataset(loader, device)
    else:
        train_step = make_teacher_train_step(diffusion_params, config.timesteps)
    grid_fn = make_grid_fn(model, config, diffusion_params)
    ckpt_writer = AsyncCheckpointWriter()
    try:
        for i in range(config.epochs):
            epoch = start_epoch + i
            t0 = time.time()
            state, avg_loss, _ = run_train_epoch(
                state,
                train_step=train_step,
                loader=loader,
                config=config,
                device=device,
                progress_desc=f"Continue Epoch {epoch + 1}",
                log_label=f"[continue] epoch {epoch + 1}",
                log_every=log_every,
                loss_fmt=".5f",
                use_scan=use_scan,
                epoch_fn=epoch_fn,
                dataset_dev=dataset_dev,
            )
            print(f"[continue] epoch {epoch + 1} avg loss {avg_loss:.5f} "
                  f"({time.time() - t0:.1f}s)")
            if (epoch + 1) % config.save_interval == 0 or i == config.epochs - 1:
                save_epoch(ckpt_writer, config, config.teacher_models_dir, epoch + 1,
                           state.model, optimizer=state.optimizer)
                save_grid(grid_fn, source,
                          os.path.join(config.results_dir, f"samples_epoch_{epoch + 1}.png"),
                          config)
    finally:
        ckpt_writer.close()
    barrier()
    return state
