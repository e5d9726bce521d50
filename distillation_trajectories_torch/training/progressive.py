"""Progressive step-halving distillation, plain and CFG-distilled (port of
``distillation_trajectories_tpu/training/progressive.py``, without its
TPU-host watchdog).

A student running S = T/2 steps learns to land, in ONE deterministic
engine update at its index j, where TWO consecutive teacher updates (steps
2j and 2j−1 on the teacher's schedule) land.  Its ε̂-target is solved in
closed form from the engine update, so the two schedules' c₁/c₂ mismatch
is absorbed into the target; the σ terms are left out (the student learns
the deterministic map).  Rounds repeat the halving (100 → 50 → 25 → …),
each student initialised from its teacher's weights.  With
``guidance_range`` the teacher's ε̂ is the two-forward CFG combine at a
per-sample w and the student is conditioned on w (``cond=w, mask=1``):
one student forward replaces the teacher's two.

The training step reaches no kernel: the teacher updates are the σ-free
closed form :func:`_engine_c`, elementwise torch as in the JAX package.
Where JAX jits the step, a round on one device runs it through the epoch
lane (:func:`make_progressive_epoch_fn`): on the card one CUDA graph,
captured after two eager warm-up steps, replayed a batch.
The students sample through :func:`..diffusion.sampling.generate_trajectory_scan`,
whose update tail is the Triton kernel on CUDA tensors.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, Optional, Tuple

import torch

from ..config import resolve_device
from ..data import get_data_loader
from ..diffusion import get_diffusion_params
from ..diffusion.process import q_sample
from ..models.dit import require_unet
from .checkpoints import AsyncCheckpointWriter, save_epoch
from .loop import run_train_epoch, upload_dataset
from .state import (
    StepDraws,
    TorchDraws,
    TrainState,
    _counted,
    _epoch_fn,
    _schedule,
    _update,
    create_train_state,
    make_eval_model_fn,
)


def _engine_c(alpha_t: torch.Tensor, alpha_prev: torch.Tensor):
    """(c1, c2) of the deterministic engine update, with the expressions of
    ``diffusion/sampling.py::engine_update``."""
    c1 = torch.sqrt(alpha_prev) / torch.sqrt(alpha_t)
    c2 = torch.sqrt(1.0 - alpha_prev) - torch.sqrt(alpha_prev / alpha_t) * torch.sqrt(1.0 - alpha_t)
    return c1, c2


def make_guided_eval_fn(model: torch.nn.Module, guidance_value: float,
                        quant: Optional[str] = None, **quant_kw):
    """Eval forward of a w-conditioned student: it ignores the sampler's
    ``(cond, cond_mask)`` and feeds ``cond=w, mask=1``, so
    ``generate_trajectory_scan(..., guidance_scale=None)`` runs the guided
    map in ONE forward per step.  ``guidance_value`` is a float or a 0-d
    float32 tensor on the model's device, read at each call (JAX's traced
    ``w``): a captured chain then reads the value it holds at each replay,
    so one graph serves every ``w``.  ``quant="int8"`` runs the int8
    forward (:func:`..models.quantized.make_quantized_eval_fn`), with
    ``quant_kw`` (``act_scales``, ``quant_blocks``) passed through."""
    if quant == "int8":
        from ..models.quantized import make_quantized_eval_fn

        base = make_quantized_eval_fn(model, **quant_kw)
    else:
        base = make_eval_model_fn(model)

    def fn(x, t, cond=None, cond_mask=None):
        b = x.shape[0]
        if torch.is_tensor(guidance_value):
            w = guidance_value.to(x.dtype).expand(b, 1)
        else:
            w = torch.full((b, 1), float(guidance_value), dtype=x.dtype, device=x.device)
        return base(x, t, w, torch.ones((b, 1), dtype=x.dtype, device=x.device))

    return fn


def make_progressive_distill_step(
    teacher_model: torch.nn.Module,
    teacher_alphas,
    student_alphas,
    teacher_steps: int,
    teacher_cumprod_params,
    guidance_range: Optional[Tuple[float, float]] = None,
    teacher_guided: bool = False,
):
    """Progressive-distillation step: ``step(state, images, draws=None) ->
    (state, loss)``, the gradients left in ``.grad``.

    Per batch: ``j ~ U[1, S)`` and ``t = 2j``; ``x_t`` by ``q_sample`` on
    the teacher's cumulative schedule; two deterministic teacher engine
    updates ``x_t → x_{t−2}`` from the eval-mode teacher without
    gradients; the closed-form ε̂* of the student's single update at j on
    its own schedule; the student's train-mode forward (BatchNorm batch
    statistics, dropout from ``draws.generator``); loss = mean over
    samples of ``min(1, c2s²/1e-4)`` × the per-sample ε-MSE; one Adam step.

    ``guidance_range=(lo, hi)``: per-sample ``draws.w ~ U[lo, hi]``; the
    teacher's ε̂ is ``u + w·(c − u)`` from cond 0 and cond 1 (mask 1), or
    with ``teacher_guided`` one forward at ``cond=w``; the student gets
    ``cond=w, mask=1``.  Otherwise teacher and student take cond 0, mask 0.
    """
    return _counted(_progressive_body(teacher_model, teacher_alphas, student_alphas,
                                      teacher_steps, teacher_cumprod_params,
                                      guidance_range, teacher_guided))


def make_progressive_epoch_fn(
    teacher_model: torch.nn.Module,
    teacher_alphas,
    student_alphas,
    teacher_steps: int,
    teacher_cumprod_params,
    guidance_range: Optional[Tuple[float, float]] = None,
    teacher_guided: bool = False,
):
    """The progressive round's epoch lane, the counterpart of JAX's jitted
    step (``training/progressive.py:148``, ``jax.jit`` with the state
    donated): ``epoch(state, dataset, idx) -> (state, losses)`` runs the
    step of :func:`make_progressive_distill_step` on each batch
    ``dataset[idx[i]]``, its draws from ``state.draws`` in the per-batch
    loop's order.  On CUDA the step is captured once into a CUDA graph
    after its warm-up steps and replayed a batch (``state._epoch_fn``); on
    the CPU it runs eagerly."""
    return _epoch_fn(_progressive_body(teacher_model, teacher_alphas, student_alphas,
                                       teacher_steps, teacher_cumprod_params,
                                       guidance_range, teacher_guided))


def _progressive_body(teacher_model, teacher_alphas, student_alphas, teacher_steps: int,
                      teacher_cumprod_params, guidance_range, teacher_guided: bool):
    """The progressive step's body ``(state, images, draws) -> loss``,
    shared by the per-batch step and the epoch lane; it leaves
    ``state.step`` alone.  Everything it reads from the schedules is
    gathered on the device by the drawn ``j``: no host lookup, so a
    captured replay takes each batch's own indices."""
    student_steps = len(student_alphas)
    if teacher_steps // 2 != student_steps:
        raise ValueError(f"teacher_steps {teacher_steps} does not halve to {student_steps}")
    teacher_fn = make_eval_model_fn(teacher_model)
    schedules: Dict[torch.device, Dict] = {}
    alphas: Dict[torch.device, Dict] = {}

    def body(state: TrainState, images: torch.Tensor, draws: Optional[StepDraws]):
        if draws is None:
            draws = state.draws.progressive_step(images, student_steps, guidance_range)
        device = images.device
        dp = _schedule(schedules, teacher_cumprod_params, device)
        a = _schedule(alphas, {"teacher": teacher_alphas, "student": student_alphas}, device)
        a_t, a_s = a["teacher"], a["student"]
        b = images.shape[0]
        j = draws.t.to(device=device, dtype=torch.int64)
        t = 2 * j
        x_t, _ = q_sample(images, t, dp, noise=draws.noises[0])
        zeros = images.new_zeros((b, 1))
        ones = images.new_ones((b, 1))

        if guidance_range is not None:
            w = draws.w.to(device=device, dtype=images.dtype)

            def teacher_eps(x, tvec):
                if teacher_guided:
                    return teacher_fn(x, tvec, w, ones)
                u = teacher_fn(x, tvec, zeros, ones)
                c = teacher_fn(x, tvec, ones, ones)
                return u + w[:, :, None, None] * (c - u)

            student_cond, student_mask = w, ones
        else:

            def teacher_eps(x, tvec):
                return teacher_fn(x, tvec, zeros, zeros)

            student_cond, student_mask = zeros, zeros

        def bcast(v):
            return v.reshape(b, 1, 1, 1)

        eps1 = teacher_eps(x_t, t.float())
        c1a, c2a = _engine_c(a_t[t], a_t[t - 1])
        x_mid = bcast(c1a) * x_t - bcast(c2a) * eps1
        eps2 = teacher_eps(x_mid, (t - 1).float())
        c1b, c2b = _engine_c(a_t[t - 1], a_t[t - 2])
        x_target = bcast(c1b) * x_mid - bcast(c2b) * eps2
        c1s, c2s = _engine_c(a_s[j], a_s[j - 1])
        eps_star = (bcast(c1s) * x_t - x_target) / bcast(c2s)

        model = state.model.train()
        pred = model(x_t, j.float(), student_cond, student_mask, generator=draws.generator)
        per = torch.mean((pred - eps_star) ** 2, dim=(1, 2, 3))
        weight = torch.clamp(c2s * c2s / 1e-4, max=1.0)
        loss = torch.mean(weight * per)
        _update(state, loss, None)
        return loss.detach()

    return body


def progressive_distill(
    config,
    teacher_model: torch.nn.Module,
    rounds: int = 1,
    seed: int = 0,
    epochs_per_round: Optional[int] = None,
    guidance_range: Optional[Tuple[float, float]] = None,
    draws=None,
) -> Tuple[torch.nn.Module, int]:
    """Iterated step-halving on ``config.device``: returns ``(model,
    final_steps)``.

    Round r copies the current model (at first the teacher, at
    ``config.teacher_steps``) into a same-architecture student running half
    the steps; the student then teaches round r+1.  Round r's loader is
    seeded ``seed + r`` and its draws come from ``draws`` (a factory
    ``(seed, device) -> draw source``, default :class:`..state.TorchDraws`)
    seeded ``seed + 1000·r``.  Checkpoints, Adam state included, go to
    ``models_dir/progressive/steps_{n}`` (``progressive_cfg`` when guided)
    every ``save_interval`` epochs and after the last, sharded
    (``model_epoch_{e}.dcp``) with ``Config.checkpoint_sharded``.  With
    ``guidance_range`` round 1's teacher makes the two CFG forwards and
    every later teacher, a w-conditioned student, one.

    A round on one device runs the epoch lane
    (:func:`make_progressive_epoch_fn`: one captured CUDA graph replayed a
    batch on the card, eager on the CPU) over the image set uploaded once
    a call, each epoch's batches the round's loader's; it reads neither
    ``Config.epoch_scan`` nor ``DTT_EPOCH_SCAN``, which JAX's progressive
    loop ignores too.  A state on a mesh takes the per-batch loop.  A
    round's graph is released when the round ends.
    """
    require_unet(teacher_model, "progressive distillation")
    device = resolve_device(config.device)
    epochs = epochs_per_round or config.epochs
    family = "progressive" if guidance_range is None else "progressive_cfg"
    cur_model, cur_steps = teacher_model, int(config.teacher_steps)
    writer = AsyncCheckpointWriter()
    dataset_dev = None
    try:
        for r in range(rounds):
            next_steps = cur_steps // 2
            if next_steps < 2:
                print(f"[progressive] {cur_steps} steps cannot halve further")
                break
            dp_teacher = get_diffusion_params(cur_steps, config)
            dp_student = get_diffusion_params(next_steps, config)
            student = copy.deepcopy(cur_model).to(device)
            state = create_train_state(student, config, (draws or TorchDraws)(seed + 1000 * r, device))
            use_scan = state.mesh is None  # a mesh's collectives cannot be captured
            make = make_progressive_epoch_fn if use_scan else make_progressive_distill_step
            fn = make(cur_model, dp_teacher["alphas"], dp_student["alphas"], cur_steps, dp_teacher,
                      guidance_range=guidance_range,
                      teacher_guided=guidance_range is not None and r > 0)
            loader = get_data_loader(config, seed=seed + r)
            if use_scan and dataset_dev is None:
                dataset_dev = upload_dataset(loader, device)
            print(f"[progressive] round {r + 1}/{rounds}: {cur_steps} -> {next_steps} steps, "
                  f"{epochs} epochs")
            ckpt_dir = os.path.join(config.models_dir, family, f"steps_{next_steps}")
            for epoch in range(epochs):
                t0 = time.time()
                state, avg, _ = run_train_epoch(
                    state, train_step=fn, loader=loader, config=config, device=device,
                    progress_desc=f"Progressive {cur_steps}->{next_steps} epoch {epoch + 1}/{epochs}",
                    log_label=f"[progressive] steps={next_steps} epoch {epoch + 1}",
                    log_every=50, loss_fmt=".6f",
                    use_scan=use_scan, epoch_fn=fn, dataset_dev=dataset_dev,
                )
                print(f"[progressive] steps={next_steps} epoch {epoch + 1}/{epochs} "
                      f"loss {avg:.6f} ({time.time() - t0:.1f}s)")
                if (epoch + 1) % config.save_interval == 0 or epoch == epochs - 1:
                    save_epoch(writer, config, ckpt_dir, epoch + 1, state.model,
                               optimizer=state.optimizer)
            if use_scan:
                fn.captured.clear()  # the round's graph and its memory pool
            cur_model, cur_steps = state.model, next_steps
    finally:
        writer.close()
    return cur_model, cur_steps
