"""The one-epoch loop shared by the teacher, distillation and resume
trainers (port of the per-batch loop of JAX ``training/loop.py:89-118``).

The JAX package's epoch scan is bitwise equal to this loop, so the loop is
the whole contract: batches in loader order, ``limit_batches_per_epoch``
honoured, the losses kept on the device and fetched once, and an empty
epoch reported as 0.0.  On a mesh (``state.mesh``) every rank reads the
same global batch and keeps its rows (``parallel.shard_batch``); the steps
return the global batch's loss.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..parallel.mesh import shard_batch


def progress_iter(loader, desc, config):
    """tqdm progress bar honouring the ``progress_bar_*`` config (only on a
    terminal); the plain loader when tqdm is missing."""
    try:
        from tqdm import tqdm
    except ImportError:
        return loader
    return tqdm(
        loader,
        desc=desc,
        leave=config.progress_bar_leave,
        ncols=config.progress_bar_ncols,
        position=config.progress_bar_position,
        disable=not sys.stderr.isatty(),
    )


def run_train_epoch(
    state,
    *,
    train_step,
    loader,
    config,
    device,
    progress_desc: str,
    log_label: str,
    log_every: int,
    loss_fmt: str = ".5f",
):
    """Run one epoch of ``train_step(state, images) -> (state, loss)`` over
    ``loader``; returns ``(state, avg_loss, n_batches)``."""
    losses = []
    progress = progress_iter(loader, progress_desc, config)
    batches = iter(progress)
    try:
        for batch_idx, (images, _) in enumerate(batches):
            if (
                config.limit_batches_per_epoch is not None
                and batch_idx >= config.limit_batches_per_epoch
            ):
                break
            images = torch.from_numpy(images)
            if state.mesh is not None:
                images = shard_batch(images, state.mesh)
            images = images.to(device)
            state, loss = train_step(state, images)
            losses.append(loss)
            if log_every and (batch_idx + 1) % log_every == 0:
                running = float(torch.stack(losses).mean())
                if hasattr(progress, "set_postfix"):
                    progress.set_postfix(loss=running)
                else:
                    print(f"{log_label} batch {batch_idx + 1}/{len(loader)} "
                          f"loss {running:{loss_fmt}}")
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()  # stops the loader's prefetch thread
    if not losses:
        return state, 0.0, 0
    losses_host = torch.stack(losses).cpu().numpy()
    return state, float(np.mean(losses_host)), len(losses)

