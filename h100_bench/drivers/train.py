"""Teacher training on the port's default epoch lane, as ``train_teacher``
runs it: ``run_train_epoch`` over a ``DataLoader`` of the configuration's
data set, each epoch one captured CUDA graph replayed a batch.

Set-up makes the data set and the weights from ``--seed``, builds the
train state (model, Adam, the trainer's draw source) and runs its first
whole epoch through the window's own call: the eager warm-up steps, then
the capture of the graph that every epoch of the window replays, then a
replay a batch.  That epoch's per-step losses are kept, and an Adam
post-step hook reads, during the eager steps alone, each leaf's gradient
norm after the first step (from Adam's first moment) and each leaf's
change after the last eager step (at most ``CHANGE_STEPS``); it removes
itself at the first step made inside a capture, so nothing of it is in
the graph.

The check follows the epoch's first ``checked_steps`` steps with the plain
reference (at the configuration's precision) from the same weights, the
loader's documented epoch order and the trainer's draw stream, and
compares each step's loss (the graph's replays among them: each reads its
batch's row at the graph's own counter and starts from the weights the
replay before it wrote), each moving leaf's first gradient norm and each
moving leaf's change.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from h100_bench import program
from h100_bench.reference import compare
from h100_bench.reference import unet as ref_unet
from h100_bench.reference.train import TeacherSteps
from h100_bench.yardstick import draws as D
from h100_bench.yardstick.flops import forward_flops
from h100_bench.yardstick.schedule import linear_schedule
from h100_bench.yardstick.weights import make_weights

# Leaves whose first gradient in float32 is under this share of the median
# leaf's (a convolution's bias ahead of BatchNorm) have a gradient of
# rounding alone, and Adam moves them by +-lr on it: the gradient and change
# numbers leave them out.
STILL_LEAF = 1e-3
# The change is read after the last eager step up to this one (the
# contract's three; the epoch lane makes two before its capture).
CHANGE_STEPS = 3


class EagerSteps:
    """Adam's post-step hook over a state's first steps: after the first,
    each leaf's gradient norm from Adam's first moment (``(1 - beta1) g``;
    NaN where the optimizer has no moment); after each later eager step up
    to ``upto``, each leaf's change from ``initial``.  It removes itself at
    the first step made inside a graph capture or past ``upto``."""

    def __init__(self, optimizer, model, initial, beta1: float, upto: int):
        self.named = list(model.named_parameters())
        self.initial, self.beta1, self.upto = initial, beta1, upto
        self.steps = 0
        self.grads = self.changes = None
        self.handle = optimizer.register_step_post_hook(self)

    def __call__(self, optimizer, args, kwargs) -> None:
        capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        if capturing or self.steps >= self.upto:
            self.handle.remove()
            return
        self.steps += 1
        with torch.no_grad():
            if self.steps == 1:
                moments = optimizer.state
                self.grads = [moments[p]["exp_avg"].norm() if "exp_avg" in moments.get(p, {})
                              else None for _, p in self.named]
            self.changes = [(p.detach() - self.initial[n]).norm() for n, p in self.named]

    def read(self):
        """``(first gradient norms, changes, steps the change is after)``;
        where the optimizer never stepped, NaN gradients and the change
        as it stands after ``upto`` steps."""
        self.handle.remove()
        if self.grads is None:
            self.grads = [None] * len(self.named)
            self.changes = [(p.detach() - self.initial[n]).norm() for n, p in self.named]
        grads = {n: math.nan if g is None else float(g) / (1.0 - self.beta1)
                 for (n, _), g in zip(self.named, self.grads)}
        changes = {n: float(c) for (n, _), c in zip(self.named, self.changes)}
        return grads, changes, self.steps or self.upto


class TrainRun:
    def __init__(self, ctx):
        cfg = ctx.config
        self.ctx, self.cfg = ctx, cfg
        dev = ctx.device
        self.B, self.N, self.T = int(cfg["batch_size"]), int(cfg["dataset_size"]), int(cfg["timesteps"])
        self.shape = (cfg["image_size"], cfg["image_size"], cfg["channels"])
        self.beta1 = float(cfg["trainer_adam_betas"][0])
        self.loader_seed = D.derive(ctx.seed, "loader")
        self.draw_seed = D.derive(ctx.seed, "draws")
        gen = torch.Generator(device=dev).manual_seed(D.derive(ctx.seed, "data"))
        self.pixels = torch.randint(0, 256, (self.N, *self.shape), generator=gen, device=dev,
                                    dtype=torch.uint8)
        self.weights = make_weights(1.0, cfg["channels"], D.derive(ctx.seed, "weights/1.0"), dev)

        from distillation_trajectories_torch.data.datasets import DataLoader
        from distillation_trajectories_torch.diffusion.schedules import get_diffusion_params
        from distillation_trajectories_torch.training.loop import run_train_epoch, upload_dataset
        from distillation_trajectories_torch.training.state import (
            TorchDraws, create_train_state, make_teacher_epoch_fn)

        images = (self.pixels.float() / 255.0 * 2.0 - 1.0).cpu().numpy()
        self.loader = DataLoader(images, np.zeros(self.N, np.int32), self.B, shuffle=True,
                                 seed=self.loader_seed)
        self.config = program.port_config(cfg, dev, ctx.workdir)
        model = program.port_unet(self.config, 1.0, self.weights, dev)
        self.state = create_train_state(model, self.config, TorchDraws(self.draw_seed, dev))
        self.epoch_fn = make_teacher_epoch_fn(get_diffusion_params(self.T, self.config), self.T)
        self.dataset = upload_dataset(self.loader, dev)
        self._run_epoch = run_train_epoch
        h, w, c = self.shape
        # Two train forwards a step, forward and backward counted as three.
        self.call_flops = len(self.loader) * 2 * 3 * self.B * forward_flops(1.0, h, w, c)

        watch = EagerSteps(self.state.optimizer, model, self.weights, self.beta1, CHANGE_STEPS)
        _, losses = self.epoch(reduce_loss=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.first_losses = [float(x) for x in losses[: int(ctx.traffic["checked_steps"])]]
        self.first_grads, self.changes, self.change_steps = watch.read()

    def epoch(self, reduce_loss: bool = True):
        self.state, loss, n = self._run_epoch(
            self.state, train_step=None, loader=self.loader, config=self.config,
            device=self.ctx.device, progress_desc="", log_label="", log_every=0,
            use_scan=True, epoch_fn=self.epoch_fn, dataset_dev=self.dataset,
            reduce_loss=reduce_loss)
        return n, loss

    def call(self, k: int):
        n, loss = self.epoch()
        return n * self.B, math.isfinite(loss)

    def slice(self) -> dict:
        n, _ = self.epoch()
        return {"steps": n}

    def release(self) -> None:
        del self.state, self.epoch_fn, self.dataset, self.loader, self._run_epoch

    # -- the check -------------------------------------------------------------

    def reference(self, quant=None, half_batch=False, dtype=None, steps=None):
        """``(losses, first gradient norms, change norms)`` of the plain
        reference over the first ``steps`` steps of the first epoch
        (default: as many as the program's were read), the change after as
        many steps as the program's, at the configuration's precision
        unless ``dtype``."""
        cfg, dev = self.cfg, self.ctx.device
        if dtype is None:
            dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
        gen = torch.Generator(device=dev).manual_seed(self.draw_seed)
        steps_run = TeacherSteps(self.weights, 1.0, linear_schedule(self.T, cfg["beta_start"],
                                                                    cfg["beta_end"]),
                                 self.T, cfg["lr"], cfg["dropout"], gen, quant=quant,
                                 half_batch=half_batch, dtype=dtype)
        n = steps or len(self.first_losses)
        losses, changes = [], {}
        with compare.float32_exact(), torch.enable_grad():
            for i, rows in enumerate(D.epoch_rows(self.N, self.B, self.loader_seed, 1, n)):
                batch = self.pixels[torch.as_tensor(rows, device=dev)].float() / 255.0 * 2.0 - 1.0
                losses.append(steps_run.step(batch))
                if i + 1 == self.change_steps:
                    changes = {k: float((p.detach() - self.weights[k]).norm())
                               for k, p in steps_run.params.items()}
            grads = {k: float(g.norm()) for k, g in steps_run.grads[0].items()}
        return losses, grads, changes

    def check(self) -> List[tuple]:
        program_numbers = (self.first_losses, self.first_grads, self.changes)
        if self.ctx.control == "reference_fp8":
            program_numbers = self.reference(quant=ref_unet.fp8_quant)
        elif self.ctx.control == "fault_half_batch":
            program_numbers = self.reference(half_batch=True)
        losses, grads, changes = program_numbers
        ref_losses, ref_grads, ref_changes = self.reference()
        # Which leaves move: by the first gradient in float32, where a leaf
        # whose gradient is nought reads as rounding of float32.
        exact = self.reference(dtype=torch.float32, steps=1)[1]
        median = float(np.median(list(exact.values())))
        moving = [k for k, g in exact.items() if g >= STILL_LEAF * median]
        grad_gaps = compare.leaf_gaps(grads, {k: ref_grads[k] for k in moving})
        update_gaps = compare.leaf_gaps(changes, {k: ref_changes[k] for k in moving})
        numbers = {
            "train_loss_gap": max(compare.relative_gap(p, r) for p, r in zip(losses, ref_losses)),
            "train_grad_gap": max(grad_gaps.values()),
            "train_update_gap": max(update_gaps.values()),
        }
        top = lambda gaps: sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
        self.details = {"losses": losses, "ref_losses": ref_losses,
                        "worst_grad_leaves": top(grad_gaps), "worst_update_leaves": top(update_gaps),
                        "still_leaves": sorted(set(ref_grads) - set(moving))}
        limits = self.ctx.cell.limits
        return [(k, float(v), float(limits[k])) for k, v in numbers.items()]


def setup(ctx) -> TrainRun:
    return TrainRun(ctx)
