"""Forward diffusion and the ε-MSE training loss (port of
``distillation_trajectories_tpu/diffusion/process.py``).

The noise is an argument: pass the draw to replay one (the CPU tests hand
in JAX's), or a ``torch.Generator`` to draw it here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .schedules import extract

# A model forward: (x, t, cond, cond_mask) -> predicted noise.
ModelFn = Callable[..., torch.Tensor]


def q_sample(
    x_start: torch.Tensor,
    t: torch.Tensor,
    diffusion_params: Dict,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Noise ``x_start`` to timestep ``t``; returns ``(x_noisy, noise)``."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator,
                            device=x_start.device, dtype=x_start.dtype)
    sqrt_ac = extract(diffusion_params["sqrt_alphas_cumprod"], t, x_start.shape)
    sqrt_omac = extract(
        diffusion_params["sqrt_one_minus_alphas_cumprod"], t, x_start.shape
    )
    return sqrt_ac * x_start + sqrt_omac * noise, noise


def p_losses(
    model_fn: ModelFn,
    x_start: torch.Tensor,
    t: torch.Tensor,
    diffusion_params: Dict,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    cond: Optional[torch.Tensor] = None,
    cond_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Simple-ε MSE; ``cond`` with ``cond_mask=0`` is the reference's
    ``cond=None``."""
    x_noisy, noise = q_sample(x_start, t, diffusion_params, noise, generator)
    predicted = model_fn(x_noisy, t, cond, cond_mask)
    return torch.mean((predicted - noise) ** 2)
