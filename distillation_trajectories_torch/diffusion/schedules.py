"""Noise schedules and precomputed diffusion parameters.

Port of ``distillation_trajectories_tpu/diffusion/schedules.py``.  The
schedule tensors are host numpy float32 arrays in both packages, computed
with the same numpy expressions, so the values are bit-identical.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def linear_beta_schedule(
    timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02
) -> np.ndarray:
    """Linear beta schedule."""
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float32)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule from Nichol & Dhariwal (2021)."""
    steps = np.arange(timesteps + 1, dtype=np.float64)
    f = np.cos(((steps / timesteps) + s) / (1 + s) * np.pi / 2) ** 2
    alphas_cumprod = f / f[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.asarray(np.clip(betas, 0.0, 0.999), dtype=np.float32)


_PARAMS_CACHE: Dict[tuple, Dict[str, np.ndarray]] = {}


def get_diffusion_params(
    sample_steps: int, config: Optional[object] = None
) -> Dict[str, np.ndarray]:
    """All schedule tensors as read-only host numpy arrays.

    Memoized per (steps, beta_start, beta_end, schedule); each call returns
    a fresh dict sharing the cached read-only arrays.
    """
    beta_start = getattr(config, "beta_start", 1e-4) if config else 1e-4
    beta_end = getattr(config, "beta_end", 0.02) if config else 0.02
    schedule = getattr(config, "noise_schedule", "linear") if config else "linear"

    cache_key = (int(sample_steps), float(beta_start), float(beta_end), schedule)
    if cache_key in _PARAMS_CACHE:
        return dict(_PARAMS_CACHE[cache_key])

    if schedule == "cosine":
        betas = cosine_beta_schedule(sample_steps)
    else:
        betas = linear_beta_schedule(sample_steps, beta_start, beta_end)

    alphas = (1.0 - betas).astype(np.float32)
    alphas_cumprod = np.cumprod(alphas, axis=0, dtype=np.float32)
    alphas_cumprod_prev = np.pad(
        alphas_cumprod[:-1], (1, 0), constant_values=1.0
    ).astype(np.float32)
    host = {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "alphas_cumprod_prev": alphas_cumprod_prev,
        "sqrt_recip_alphas": np.sqrt(1.0 / alphas),
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod),
        "posterior_variance": betas
        * (1.0 - alphas_cumprod_prev)
        / (1.0 - alphas_cumprod),
    }
    params = {k: np.asarray(v, dtype=np.float32) for k, v in host.items()}
    for v in params.values():
        # The cache shares these arrays process-wide: an in-place edit by any
        # caller would corrupt every later schedule.
        v.setflags(write=False)
    params["timesteps"] = np.int32(sample_steps)
    _PARAMS_CACHE[cache_key] = params
    return dict(params)


def extract(a, t: torch.Tensor, x_shape) -> torch.Tensor:
    """Gather schedule coefficients at timesteps ``t`` (clamped to bounds),
    shaped ``[B, 1, ..., 1]`` to broadcast against ``x_shape``.  ``a`` is a
    host array or a tensor (already on ``t``'s device saves the copy)."""
    if isinstance(a, torch.Tensor):
        a = a.to(t.device)
    else:
        a = torch.tensor(np.asarray(a), device=t.device)
    t = t.long().clamp(0, a.shape[0] - 1)
    return a[t].reshape(t.shape[0], *((1,) * (len(x_shape) - 1)))


def schedule_on(diffusion_params: Dict, device) -> Dict:
    """The schedule's arrays as float32 tensors on ``device`` (a train step
    gathers from them every step; host arrays would be copied each time)."""
    return {
        k: torch.tensor(np.asarray(v), device=device) if np.ndim(v) else v
        for k, v in diffusion_params.items()
    }
