"""Train state, draws and train steps (port of
``distillation_trajectories_tpu/training/state.py``).

One train step is eager PyTorch: the forwards, one backward, an Adam step
and, for the teacher, an optional EMA update.  Where JAX splits a PRNG key
per step (``split(key, 5)`` for the teacher at JAX ``state.py:164``,
``split(key, 4)`` for distillation at ``:341``), the port takes a
:class:`StepDraws`: the timesteps, the noise draws and the generator of the
dropout masks.  A step given none draws them from ``state.draws``, a draw
source; the default source, :class:`TorchDraws`, is one ``torch.Generator``
on the device seeded from the trainer's seed.  Tests pass a source (or the
draws) holding JAX's values instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..diffusion.process import q_sample
from ..diffusion.schedules import schedule_on


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one train step."""

    t: torch.Tensor  # [B] integer timesteps (the teacher's, for distillation;
    # the student's index j for progressive distillation)
    noises: Tuple[torch.Tensor, ...]  # two for the teacher step, one for distillation
    generator: Optional[torch.Generator] = None  # dropout masks; None: global generator
    w: Optional[torch.Tensor] = None  # [B, 1] guidance scales of guided progressive steps


class TorchDraws:
    """The port's default draw source for one trainer run.

    ``init_unet`` initialises a model from ``seed`` (see
    :func:`..models.make_unet`); the step and sample draws come, in call
    order, from one ``torch.Generator`` on ``device`` seeded from ``seed``,
    which also draws the dropout masks.  A source that replays another
    stream implements the same methods.
    """

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

    def init_unet(self, config, size_factor: float) -> torch.nn.Module:
        from ..models import make_unet

        return make_unet(config, size_factor=size_factor, device=self.device, seed=self.seed)

    def _normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device, dtype=dtype)

    def _t(self, batch: int, timesteps: int) -> torch.Tensor:
        return torch.randint(0, timesteps, (batch,), generator=self.generator,
                             device=self.device)

    def teacher_step(self, images: torch.Tensor, timesteps: int) -> StepDraws:
        t = self._t(images.shape[0], timesteps)
        noises = (self._normal(images.shape, images.dtype), self._normal(images.shape, images.dtype))
        return StepDraws(t, noises, self.generator)

    def distill_step(self, images: torch.Tensor, timesteps: int) -> StepDraws:
        t = self._t(images.shape[0], timesteps)
        return StepDraws(t, (self._normal(images.shape, images.dtype),), self.generator)

    def progressive_step(self, images: torch.Tensor, student_steps: int,
                         guidance_range: Optional[Tuple[float, float]] = None) -> StepDraws:
        """``j ~ U[1, S)``, the noise and, for a guided step, ``w ~ U[lo, hi]``."""
        b = images.shape[0]
        j = torch.randint(1, student_steps, (b,), generator=self.generator, device=self.device)
        noise = self._normal(images.shape, images.dtype)
        w = None
        if guidance_range is not None:
            lo, hi = guidance_range
            u = torch.rand((b, 1), generator=self.generator, device=self.device, dtype=images.dtype)
            w = lo + (hi - lo) * u
        return StepDraws(j, (noise,), self.generator, w)

    def sample(self, shape, n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Starting noise ``shape`` and per-step noise ``[n_steps, *shape]``
        of one sample grid."""
        return self._normal(shape), self._normal((n_steps, *shape))


@dataclasses.dataclass
class TrainState:
    """A model in training: its optimizer, its draw source, the optional
    EMA of its parameters (by name) and the step count."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    draws: object
    ema: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0


def make_optimizer(model: torch.nn.Module, config) -> torch.optim.Adam:
    """Adam with torch's defaults, β=(0.9, 0.999) and eps 1e-8, as the
    reference trainers run it (not the config's unused ``adam_beta1=0.8``)."""
    return torch.optim.Adam(model.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(model: torch.nn.Module, config, draws, use_ema: bool = False) -> TrainState:
    ema = None
    if use_ema:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model=model, optimizer=make_optimizer(model, config), draws=draws, ema=ema)


def make_eval_model_fn(model: torch.nn.Module, params: Optional[Dict[str, torch.Tensor]] = None) -> Callable:
    """Eval-mode forward closure ``(x, t, cond, cond_mask) -> ε̂``, run under
    ``torch.no_grad()``; puts ``model`` in eval mode.  ``params`` (tensors by
    parameter name, e.g. EMA weights) stand in for the model's own."""
    model.eval()

    def model_fn(x, t, cond=None, cond_mask=None):
        with torch.no_grad():
            if params is None:
                return model(x, t, cond=cond, cond_mask=cond_mask)
            return torch.func.functional_call(
                model, params, (x, t), dict(cond=cond, cond_mask=cond_mask), strict=False)

    return model_fn


def make_eval_fn_from_config(model: torch.nn.Module, config) -> Callable:
    """The config-aware eval forward every sampler and editing flow goes
    through (JAX ``training/state.py::make_eval_fn_from_config``):

    * ``Config.sampler_quant="int8"``: the folded int8 forward
      (:func:`..models.quantized.make_quantized_eval_fn`, dynamic scales);
    * ``Config.spatial_shape``: the spatially partitioned forward, not
      ported (raises ``NotImplementedError``);
    * otherwise the plain eval forward.

    The two opt-ins cannot combine (``ValueError``), as in JAX."""
    spatial = config is not None and getattr(config, "spatial_shape", None)
    if config is not None and getattr(config, "sampler_quant", "none") == "int8":
        if spatial:
            raise ValueError(
                "spatial_shape and sampler_quant='int8' cannot combine: the "
                "quantized forward bypasses the Block modules the spatial "
                "constraints intercept"
            )
        from ..models.quantized import make_quantized_eval_fn

        return make_quantized_eval_fn(model)
    if spatial:
        raise NotImplementedError("spatial_shape (spatial partitioning) is not ported")
    return make_eval_model_fn(model)


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def _schedule(cache: Dict, diffusion_params, device) -> Dict:
    if device not in cache:
        cache[device] = schedule_on(diffusion_params, device)
    return cache[device]


def _apply_update(state: TrainState, loss: torch.Tensor, ema_rate: Optional[float]) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    if ema_rate is not None and state.ema is not None:
        with torch.no_grad():
            ema = list(state.ema.values())
            params = [p for _, p in state.model.named_parameters()]
            torch._foreach_mul_(ema, ema_rate)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_rate)
    state.step += 1


def make_teacher_train_step(diffusion_params, timesteps: int, ema_rate: Optional[float] = None):
    """Teacher step: one ``t`` per image, two noise draws, loss =
    (cond ε-MSE + uncond ε-MSE) / 2, BatchNorm statistics chained through
    both train forwards (cond first).  Returns ``step(state, images,
    draws=None) -> (state, loss)``; the gradients stay in ``.grad``."""
    schedules: Dict[torch.device, Dict] = {}

    def train_step(state: TrainState, images: torch.Tensor, draws: Optional[StepDraws] = None):
        if draws is None:
            draws = state.draws.teacher_step(images, timesteps)
        dp = _schedule(schedules, diffusion_params, images.device)
        model = state.model.train()
        b = images.shape[0]
        ones = images.new_ones((b, 1))
        zeros = images.new_zeros((b, 1))
        x1, n1 = q_sample(images, draws.t, dp, noise=draws.noises[0])
        loss_cond = _mse(model(x1, draws.t, ones, ones, generator=draws.generator), n1)
        x2, n2 = q_sample(images, draws.t, dp, noise=draws.noises[1])
        loss_uncond = _mse(model(x2, draws.t, zeros, zeros, generator=draws.generator), n2)
        loss = (loss_cond + loss_uncond) / 2.0
        _apply_update(state, loss, ema_rate)
        return state, loss.detach()

    return train_step


def make_distill_train_step(teacher_model: torch.nn.Module, teacher_diffusion_params,
                            teacher_steps: int, student_steps: int):
    """Distillation step: ``t_student = ⌊t·S/T⌋``, images noised with the
    teacher's schedule, the teacher's cond and uncond in eval mode without
    gradients, the student's in train mode; loss = mean of the two MSEs
    between student and teacher predictions.  Returns ``step(state, images,
    draws=None) -> (state, loss)``."""
    ratio = student_steps / teacher_steps
    teacher_fn = make_eval_model_fn(teacher_model)
    schedules: Dict[torch.device, Dict] = {}

    def train_step(state: TrainState, images: torch.Tensor, draws: Optional[StepDraws] = None):
        if draws is None:
            draws = state.draws.distill_step(images, teacher_steps)
        dp = _schedule(schedules, teacher_diffusion_params, images.device)
        b = images.shape[0]
        ones = images.new_ones((b, 1))
        zeros = images.new_zeros((b, 1))
        t_teacher = draws.t
        t_student = torch.floor(t_teacher * ratio).to(torch.int64)
        x_noisy, _ = q_sample(images, t_teacher, dp, noise=draws.noises[0])
        teacher_cond = teacher_fn(x_noisy, t_teacher, ones, ones)
        teacher_uncond = teacher_fn(x_noisy, t_teacher, zeros, zeros)
        model = state.model.train()
        student_cond = model(x_noisy, t_student, ones, ones, generator=draws.generator)
        student_uncond = model(x_noisy, t_student, zeros, zeros, generator=draws.generator)
        loss = (_mse(student_cond, teacher_cond) + _mse(student_uncond, teacher_uncond)) / 2.0
        _apply_update(state, loss, None)
        return state, loss.detach()

    return train_step
