"""Shared editing primitives: unconditional denoising from any state and
timestep with trajectory capture (port of ``editing/core.py``), and the
default draws of the editing flows.

The JAX ``lax.scan`` over ``t = start_t … 0`` becomes a Python loop over
``t = start_t … 1``: the JAX body's t = 0 iteration runs a forward and an
update and then discards both, so the port skips that forward and records
the state.  Engine-mode updates go through the port's ``engine_update``,
which launches the Triton CFG-update kernel on CUDA tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..diffusion.sampling import engine_update, seeded_normal
from ..models.dit import require_unet
from ..trajectories.engine import _check_model_device


class EditingDraws:
    """Default draws of the editing flows, on ``device``.

    A chain of ``seed`` starts from the generator of ``(seed, 0)`` and its
    step-``t`` noise comes from that of ``(seed, t)``
    (:func:`..diffusion.sampling.seeded_normal`).  A source that replays
    another stream (the tests replay JAX's keys) implements the same three
    methods and may return CPU tensors."""

    def __init__(self, device):
        self.device = torch.device(device)

    def chain(self, seed: int, shape, start_t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Starting noise ``shape`` and step noise ``[start_t, *shape]`` of a
        generation of ``seed`` (row ``i`` is step ``t = start_t − i``)."""
        return seeded_normal([(seed, 0)], shape, self.device)[0], self.redenoise(seed, shape, start_t)

    def redenoise(self, seed: int, shape, start_t: int) -> torch.Tensor:
        """Step noise ``[start_t, *shape]`` of a re-denoise keyed on ``seed``."""
        return seeded_normal([(seed, t) for t in range(start_t, 0, -1)], shape, self.device)

    def direction(self, seed: int, shape) -> torch.Tensor:
        """A standard-normal ``shape`` draw of ``seed`` (not normalised)."""
        return seeded_normal([(seed, 0)], shape, self.device)[0]


def editing_device(model: torch.nn.Module, config) -> torch.device:
    """``config.device`` resolved (raises when it is CUDA and no GPU
    exists), checked against the device ``model`` is on; a DiT raises
    (``ValueError``): the editing flows run the U-Net only."""
    require_unet(model, "the editing flows")
    device = resolve_device(config.device)
    _check_model_device(model, device)
    return device


def denoise_with_trajectory(
    model_fn: Callable,
    x0: torch.Tensor,
    alphas,
    start_t: int,
    step_noise: Optional[torch.Tensor] = None,
    seed: int = 0,
    post_step: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    diffusion_params=None,
    mode: str = "engine",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse process from state ``x0`` at timestep ``start_t`` down to 0.

    ``step_noise`` is ``[start_t, B, H, W, C]``, row ``i`` for step
    ``t = start_t − i``; by default row ``i`` comes from the generator of
    ``(seed, t)``.  ``post_step`` (e.g. the inpainting mask reimposition)
    runs after every update.  Returns ``(final_state, trajectory)`` with
    trajectory ``[start_t + 2, B, H, W, C]``: the state before each of the
    ``start_t + 1`` iterations (the last, at t = 0, makes no update), then
    the final state.

    ``mode="engine"``: the reference's DDIM-like update on per-step
    alphas, through the kernel.  ``mode="ancestral"``: the DDPM step
    ``√(1/α_t)·(x − β_t/√(1−ᾱ_t)·ε̂) + √β̃_t·z`` (needs
    ``diffusion_params``), plain torch as in the JAX package.
    """
    if mode not in ("engine", "ancestral"):
        raise ValueError(f"mode must be 'engine' or 'ancestral', got {mode!r}")
    if mode == "ancestral" and diffusion_params is None:
        raise ValueError("ancestral mode needs diffusion_params")
    x = x0.to(torch.float32).contiguous()
    b = x.shape[0]
    if step_noise is None:
        step_noise = EditingDraws(x.device).redenoise(seed, x.shape, start_t)
    if tuple(step_noise.shape) != (start_t, *x.shape):
        raise ValueError(f"step_noise has shape {tuple(step_noise.shape)}, "
                         f"expected {(start_t, *x.shape)}")
    step_noise = step_noise.to(device=x.device, dtype=x.dtype).contiguous()
    alphas = np.asarray(alphas, dtype=np.float32)
    if mode == "ancestral":
        f32 = lambda k: np.asarray(diffusion_params[k], dtype=np.float32)
        sra, betas = f32("sqrt_recip_alphas"), f32("betas")
        somac, pvar = f32("sqrt_one_minus_alphas_cumprod"), f32("posterior_variance")
    zeros = x.new_zeros((b, 1))
    states = torch.empty((start_t + 2, *x.shape), dtype=x.dtype, device=x.device)
    for i, t in enumerate(range(start_t, 0, -1)):
        states[i] = x
        tvec = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        noise_pred = model_fn(x, tvec, zeros, zeros)
        if mode == "ancestral":
            coef = betas[t] / somac[t]
            x = float(sra[t]) * (x - float(coef) * noise_pred) + float(np.sqrt(pvar[t])) * step_noise[i]
        else:
            x = engine_update(x, noise_pred, step_noise[i], alphas[t], alphas[t - 1])
        if post_step is not None:
            x = post_step(x).contiguous()
    states[start_t] = x
    states[start_t + 1] = x
    return x, states


def to_image(x: torch.Tensor) -> torch.Tensor:
    """[−1, 1] → clipped [0, 1] (the editing modules' output space)."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
