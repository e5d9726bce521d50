"""The trajectory engine's reverse chain in plain PyTorch.

From the starting noise ``x`` the chain runs ``t = T-1 ... 1``: the
unconditional prediction (cond 0; mask 1 under CFG, 0 without), the
conditional one (cond 1, mask 1) under CFG, their combine
``u + g (c - u)``, and the update ``c1 x - c2 eps + sigma n_t`` on per-step
alphas.  The t = 0 step makes no update, so the last state is repeated:
``T+1`` states, the noise first.
"""

from __future__ import annotations

import torch

from ..yardstick.schedule import engine_scalars


def chain(model, noises: torch.Tensor, step_noise: torch.Tensor, alphas, timesteps: int,
          cfg: bool, g: float) -> torch.Tensor:
    """``[S, T+1, H, W, C]`` float32 states; ``model(x, t, cond, mask)``."""
    scalars = engine_scalars(alphas, timesteps)
    s = noises.shape[0]
    x = noises.float()
    zeros = x.new_zeros((s, 1))
    ones = x.new_ones((s, 1))
    states = [x]
    for j, t in enumerate(range(timesteps - 1, 0, -1)):
        tvec = torch.full((s,), float(t), device=x.device)
        u = model(x, tvec, zeros, ones if cfg else zeros)
        eps = u + g * (model(x, tvec, ones, ones) - u) if cfg else u
        c1, c2, sigma = (float(v) for v in scalars[j])
        x = c1 * x - c2 * eps + sigma * step_noise[j].float()
        states.append(x)
    states.append(x)
    return torch.stack(states, dim=1)
