"""The one-epoch runner shared by the teacher, distillation and resume
trainers (port of JAX ``training/loop.py``), in its two lanes.

The per-batch loop uploads each batch from the loader and runs the step;
on a mesh (``state.mesh``) every rank reads the same global batch and keeps
its rows (``parallel.shard_batch``), and the steps return the global
batch's loss.  The epoch lane (``use_scan``) hands one epoch's
``[n_batches, B]`` indices and the device-resident dataset to an epoch
function (``state.make_*_epoch_fn``).  Both take the batches in loader
order, honour ``limit_batches_per_epoch``, keep the losses on the device
and fetch them once, and report an empty epoch as 0.0.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..parallel.mesh import shard_batch
from ..utils.profiling import span


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


def upload_dataset(loader, device) -> torch.Tensor:
    """The loader's whole image set ``[N, H, W, C]`` float32 on ``device``,
    for the epoch lane (uploaded once, waited for)."""
    images = torch.from_numpy(loader.images).to(device)
    if images.device.type == "cuda":
        torch.cuda.synchronize(images.device)
    return images


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
    use_scan: bool = False,
    epoch_fn=None,
    dataset_dev=None,
    reduce_loss: bool = True,
):
    """Run one epoch; returns ``(state, avg_loss, n_batches)``.

    Per-batch lane: ``train_step(state, images) -> (state, loss)`` on each
    batch of ``loader``, with a running-loss print (or tqdm postfix) every
    ``log_every`` batches.  Epoch lane (``use_scan``): one
    ``epoch_fn(state, dataset_dev, idx) -> (state, losses)`` over the
    epoch's indices from ``loader.epoch_indices``.  ``reduce_loss=False``
    returns the fetched per-step losses (``[n_batches]``, or the student
    group's ``[n_batches, N]``) in place of their mean, in either lane.
    The epoch lane's epoch is a ``train.epoch`` span (``batches``), its
    loss fetch a ``train.loss_fetch`` span inside it."""
    if use_scan:
        idx = loader.epoch_indices(config.limit_batches_per_epoch)
        if not len(idx):
            return state, (0.0 if reduce_loss else np.zeros((0,), np.float32)), 0
        with span("train.epoch", batches=len(idx)):
            state, losses_dev = epoch_fn(state, dataset_dev, idx)
            with span("train.loss_fetch"):
                losses_host = losses_dev.cpu().numpy()
        return state, (float(np.mean(losses_host)) if reduce_loss else losses_host), len(idx)

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
    losses_host = torch.stack(losses).cpu().numpy() if losses else np.zeros((0,), np.float32)
    if not reduce_loss:
        return state, losses_host, len(losses)
    return state, float(np.mean(losses_host)) if losses else 0.0, len(losses)

