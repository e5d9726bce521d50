"""The published linear noise schedule and the engine update's scalars,
in float32 with the reference's expressions."""

from __future__ import annotations

import numpy as np


def linear_schedule(timesteps: int, beta_start: float, beta_end: float) -> dict:
    betas = np.linspace(beta_start, beta_end, timesteps, dtype=np.float32)
    alphas = (1.0 - betas).astype(np.float32)
    ac = np.cumprod(alphas, axis=0, dtype=np.float32)
    return {"betas": betas, "alphas": alphas, "alphas_cumprod": ac,
            "sqrt_ac": np.sqrt(ac), "sqrt_omac": np.sqrt(1.0 - ac)}


def engine_scalars(alphas: np.ndarray, timesteps: int) -> np.ndarray:
    """``[T-1, 3]`` float32: c1, c2, sigma of step ``t = T-1-j`` in row ``j``
    (the update ``c1 x - c2 eps + sigma n`` on per-step alphas)."""
    one = np.float32(1.0)
    rows = []
    for t in range(timesteps - 1, 0, -1):
        a_t, a_p = np.float32(alphas[t]), np.float32(alphas[t - 1])
        c1 = np.sqrt(a_p) / np.sqrt(a_t)
        c2 = np.sqrt(one - a_p) - np.sqrt(a_p / a_t) * np.sqrt(one - a_t)
        sigma = np.sqrt(one - a_p) * np.sqrt(one - a_t / a_p)
        rows.append((c1, c2, sigma))
    return np.array(rows, dtype=np.float32).reshape(-1, 3)
