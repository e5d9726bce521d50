"""Teacher training of the model the configuration names on the port's
default epoch lane, as ``train_teacher`` runs it: ``run_train_epoch``
over a ``DataLoader`` of latents and their class labels, each epoch one
captured CUDA graph replayed a batch, the step DiT's
(``training.state.make_dit_teacher_epoch_fn``: class dropout, ε-MSE plus
the variational bound, Adam, the EMA).

Set-up builds the model through the program's factory
(``models.make_model``) and gives it the benchmark's seeded weights (drawn
into its tensors, ``reference/dit.py``), makes the latents and labels from
``--seed``, builds the train state (Adam, the EMA, the trainer's draw
source) and runs its first whole epoch through the window's own call: the
eager warm-up steps, the capture, then a replay a batch.  That epoch's
per-step losses are kept, and the U-Net driver's Adam post-step hook
(``drivers/train.py::EagerSteps``, extended by :class:`EagerEMASteps`)
reads, during the eager steps alone, each leaf's gradient norm after the
first step, its change after the last and its EMA's change after the
EMA's updates until then; the initial weights these subtract are kept on
the host (:class:`HostWeights`), so the card holds no second copy.

The check follows the epoch's first ``checked_steps`` steps with the plain
reference (``reference/dit_train.py``, float32, TF32 off, in blocks of
samples) from the same weights, the loader's documented epoch order and the
trainer's draw stream, and compares each step's loss, each moving leaf's
first gradient norm and each moving leaf's change (``train_loss_gap``,
``train_grad_gap``, ``train_update_gap``), as ``drivers/train.py`` does,
and each moving leaf's EMA change (``train_ema_gap``; an EMA never
updated reads 1).  Controls: ``reference_fp8`` (the reference with fp8-rounded operands in
the program's place) and ``fault_half_batch`` (its loss over half the
batch).

On the CPU (the rehearsal tests alone: the harness refuses a host without
the card) the driver cuts the DiT to tiny widths on 8x8x4 latents, as
``sweep_models.py::cpu_cut`` does.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from h100_bench.drivers.sweep_models import TINY_DIT
from h100_bench.drivers.train import CHANGE_STEPS, STILL_LEAF, EagerSteps
from h100_bench.reference import compare
from h100_bench.reference import dit as ref_dit
from h100_bench.reference import dit_train as ref_train
from h100_bench.reference import unet as ref_unet
from h100_bench.yardstick import draws as D
from h100_bench.yardstick.adaln_bytes import dit_step_backward_bytes
from h100_bench.yardstick.dit_flops import dit_forward_flops

# Samples a reference forward and backward takes at a time on the card.
REFERENCE_BLOCK = 8


def cpu_cut(cfg: dict) -> dict:
    """The cell at a size a CPU test run holds: a tiny DiT on 8x8x4 latents
    in float32, a few batches."""
    return dict(cfg, image_size=8, channels=4, compute_dtype="float32",
                batch_size=min(int(cfg["batch_size"]), 4),
                dataset_size=min(int(cfg["dataset_size"]), 24), **TINY_DIT)


class HostWeights(dict):
    """A model's weights copied to the host, each leaf moved back to
    ``device`` as it is looked up."""

    def __init__(self, model: torch.nn.Module, device):
        super().__init__((k, p.detach().to("cpu", copy=True))
                         for k, p in model.named_parameters())
        self.device = device

    def __getitem__(self, name: str) -> torch.Tensor:
        return super().__getitem__(name).to(self.device)


def ema_change(name: str, ema: torch.Tensor, initial: torch.Tensor) -> torch.Tensor:
    """The norm of a leaf's EMA change, without the key bias (the middle
    third of an ``attn.qkv.bias``): the softmax takes a constant shift of a
    query's scores out, so its gradient is rounding alone, Adam moves it by
    ±lr on noise, and the EMA sums those moves with their signs."""
    change = ema - initial
    if name.endswith("attn.qkv.bias"):
        d = change.shape[0] // 3
        change = torch.cat([change[:d], change[2 * d:]])
    return change.norm()


class EagerEMASteps(EagerSteps):
    """:class:`EagerSteps` that also reads, at each eager step's hook after
    the first, each leaf's EMA change from ``initial`` (:func:`ema_change`).
    The EMA follows Adam's step, so step k's hook sees k - 1 updates of
    it."""

    def __init__(self, optimizer, model, ema, initial, beta1: float, upto: int):
        super().__init__(optimizer, model, initial, beta1, upto)
        self.ema, self.ema_changes, self.ema_steps = ema, None, 0

    def __call__(self, optimizer, args, kwargs) -> None:
        before = self.steps
        super().__call__(optimizer, args, kwargs)
        if self.steps > max(before, 1):
            with torch.no_grad():
                self.ema_changes = [ema_change(n, self.ema[n], self.initial[n])
                                    for n, _ in self.named]
            self.ema_steps = self.steps - 1

    def read_ema(self):
        """``(EMA changes, EMA updates they are after)``; where the hook
        never read them, the changes as they stand, after ``upto - 1``
        updates."""
        if self.ema_changes is None:
            with torch.no_grad():
                self.ema_changes = [ema_change(n, self.ema[n], self.initial[n])
                                    for n, _ in self.named]
            self.ema_steps = self.upto - 1
        return {n: float(c) for (n, _), c in zip(self.named, self.ema_changes)}, self.ema_steps


class ModelsTrainRun:
    def __init__(self, ctx):
        cfg = ctx.config
        if ctx.device.type == "cpu":
            cfg = cpu_cut(cfg)
        self.ctx, self.cfg = ctx, cfg
        dev = ctx.device
        self.B, self.N = int(cfg["batch_size"]), int(cfg["dataset_size"])
        self.T = int(cfg["diffusion_steps"])
        self.shape = (cfg["image_size"], cfg["image_size"], cfg["channels"])
        self.dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
        self.sizes = ref_dit.sizes(cfg["depth"], cfg["hidden_size"], cfg["num_heads"],
                                   patch=cfg["patch_size"], channels=cfg["channels"],
                                   input_size=cfg["image_size"], mlp_ratio=cfg["mlp_ratio"],
                                   num_classes=cfg["num_classes"], learn_sigma=cfg["learn_sigma"])
        self.loader_seed = D.derive(ctx.seed, "loader")
        self.draw_seed = D.derive(ctx.seed, "draws")
        self.weight_seed = D.derive(ctx.seed, "weights/teacher")
        gen = torch.Generator(device=dev).manual_seed(D.derive(ctx.seed, "data"))
        self.latents = torch.randn((self.N, *self.shape), generator=gen, device=dev)
        self.labels = torch.randint(0, cfg["num_classes"], (self.N,), generator=gen, device=dev)

        from distillation_trajectories_torch.data.datasets import DataLoader
        from distillation_trajectories_torch.diffusion.vlb import dit_schedule
        from distillation_trajectories_torch.training.loop import run_train_epoch, upload_dataset
        from distillation_trajectories_torch.training.state import (
            TorchDraws, create_train_state, make_dit_teacher_epoch_fn)

        self.config = self.port_config(ctx)
        model = self.build(dev)
        self.state = create_train_state(model, self.config, TorchDraws(self.draw_seed, dev),
                                        use_ema=True)
        self.epoch_fn = make_dit_teacher_epoch_fn(
            dit_schedule(self.T, cfg["beta_start"], cfg["beta_end"]), self.T,
            ema_rate=float(cfg["ema_rate"]))
        self.loader = DataLoader(self.latents.cpu().numpy(),
                                 self.labels.cpu().numpy().astype(np.int32), self.B, shuffle=True,
                                 seed=self.loader_seed)
        self.dataset = upload_dataset(self.loader, dev, labels=True)
        self._run_epoch = run_train_epoch
        s, tokens = self.sizes, (self.shape[0] // self.sizes["patch"]) ** 2
        forward = dit_forward_flops(s["depth"], s["hidden"], tokens, s["patch"], s["channels"],
                                    s["out_channels"], cfg["mlp_ratio"])
        # One train forward a step, forward and backward counted as three.
        self.call_flops = len(self.loader) * 3 * self.B * sum(forward.values())
        self.step_bytes = dit_step_backward_bytes(s["depth"], self.B, tokens, s["hidden"])

        self.initial = HostWeights(model, dev)
        watch = EagerEMASteps(self.state.optimizer, model, self.state.ema, self.initial,
                              float(cfg["trainer_adam_betas"][0]), CHANGE_STEPS)
        _, losses = self.epoch(reduce_loss=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.first_losses = [float(x) for x in losses[: int(ctx.traffic["checked_steps"])]]
        self.first_grads, self.changes, self.change_steps = watch.read()
        self.ema_changes, self.ema_steps = watch.read_ema()

    # -- the program -------------------------------------------------------------

    def port_config(self, ctx):
        from distillation_trajectories_torch.config import Config

        cfg = self.cfg
        return Config(image_size=cfg["image_size"], channels=cfg["channels"],
                      timesteps=self.T, beta_start=cfg["beta_start"], beta_end=cfg["beta_end"],
                      noise_schedule=cfg["noise_schedule"], compute_dtype=cfg["compute_dtype"],
                      batch_size=self.B, lr=cfg["lr"], ema_rate=cfg["ema_rate"], use_ema=True,
                      architecture="dit", base_dir=ctx.workdir, device=str(ctx.device))

    def build(self, device) -> torch.nn.Module:
        """The teacher through the program's factory (on the CPU at the cut's
        tiny widths through the program's class), the benchmark's weights
        drawn into its tensors."""
        cfg = self.cfg
        if device.type == "cpu":
            from distillation_trajectories_torch.models.dit import DiT

            model = DiT(input_size=cfg["image_size"], in_channels=cfg["channels"],
                        dtype=self.dtype, depth=cfg["depth"], hidden_size=cfg["hidden_size"],
                        num_heads=cfg["num_heads"])
        else:
            from distillation_trajectories_torch.models import make_model

            model = make_model(self.config, cfg["variant"], device=device,
                               seed=self.weight_seed % 2 ** 31)
        params = dict(model.state_dict())
        params.pop("pos_embed", None)
        names = {n for n, _, _ in ref_dit.param_spec(self.sizes)}
        if set(params) != names:
            raise RuntimeError(f"the program's model has other tensors than the benchmark's "
                               f"({sorted(set(params) ^ names)})")
        with torch.no_grad():
            ref_dit.make_weights(self.sizes, self.weight_seed, device, into=params)
        return model

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
        return {"steps": n, "adaln_backward_bytes": n * self.step_bytes}

    def release(self) -> None:
        del self.state, self.epoch_fn, self.dataset, self.loader, self._run_epoch

    # -- the check -------------------------------------------------------------

    def reference(self, quant=None, half_batch=False) -> tuple:
        """``(losses, first gradient norms, change norms, EMA change norms)``
        of the plain reference over as many steps of the first epoch as the
        program's were read, each change after as many steps or EMA updates
        as the program's."""
        cfg, dev = self.cfg, self.ctx.device
        steps_run = ref_train.DiTTeacherSteps(
            ref_dit.make_weights(self.sizes, self.weight_seed, dev), self.sizes,
            ref_train.schedule(self.T, cfg["beta_start"], cfg["beta_end"]), self.T, cfg["lr"],
            torch.Generator(device=dev).manual_seed(self.draw_seed), quant=quant,
            half_batch=half_batch, block=REFERENCE_BLOCK if dev.type == "cuda" else None,
            ema_rate=float(cfg["ema_rate"]))
        losses, changes, ema_changes = [], {}, {}
        moved = lambda leaves: {k: float((v.detach() - self.initial[k]).norm())
                                for k, v in leaves.items()}
        with compare.float32_exact(), torch.enable_grad():
            rows = D.epoch_rows(self.N, self.B, self.loader_seed, 1, len(self.first_losses))
            for i, r in enumerate(rows):
                at = torch.as_tensor(r, device=dev)
                losses.append(steps_run.step(self.latents[at], self.labels[at]))
                if i + 1 == self.change_steps:
                    changes = moved(steps_run.params)
                if i + 1 == self.ema_steps:
                    ema_changes = {k: float(ema_change(k, v, self.initial[k]))
                                   for k, v in steps_run.ema.items()}
            grads = {k: float(g.norm()) for k, g in steps_run.first_grads.items()}
        del steps_run
        return losses, grads, changes, ema_changes

    def check(self) -> List[tuple]:
        program_numbers = (self.first_losses, self.first_grads, self.changes, self.ema_changes)
        if self.ctx.control == "reference_fp8":
            program_numbers = self.reference(quant=ref_unet.fp8_quant)
        elif self.ctx.control == "fault_half_batch":
            program_numbers = self.reference(half_batch=True)
        losses, grads, changes, ema_changes = program_numbers
        ref_losses, ref_grads, ref_changes, ref_ema_changes = self.reference()
        # Which leaves move: by the reference's first gradient (float32),
        # where one of rounding alone reads near nought.
        median = float(np.median(list(ref_grads.values())))
        moving = [k for k, g in ref_grads.items() if g >= STILL_LEAF * median]
        grad_gaps = compare.leaf_gaps(grads, {k: ref_grads[k] for k in moving})
        update_gaps = compare.leaf_gaps(changes, {k: ref_changes[k] for k in moving})
        ema_gaps = compare.leaf_gaps(ema_changes, {k: ref_ema_changes[k] for k in moving})
        numbers = {
            "train_loss_gap": max(compare.relative_gap(p, r) for p, r in zip(losses, ref_losses)),
            "train_grad_gap": max(grad_gaps.values()),
            "train_update_gap": max(update_gaps.values()),
            "train_ema_gap": max(ema_gaps.values()),
        }
        top = lambda gaps: sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
        self.details: Dict[str, object] = {
            "losses": losses, "ref_losses": ref_losses, "worst_grad_leaves": top(grad_gaps),
            "worst_update_leaves": top(update_gaps), "worst_ema_leaves": top(ema_gaps),
            "still_leaves": sorted(set(ref_grads) - set(moving))}
        limits = self.ctx.cell.limits
        return [(k, float(v), float(limits[k])) for k, v in numbers.items()]


def setup(ctx) -> ModelsTrainRun:
    return ModelsTrainRun(ctx)
