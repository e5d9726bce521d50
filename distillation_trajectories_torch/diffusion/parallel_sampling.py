"""Parallel-in-time trajectory generation by Picard fixed-point iteration
(port of ``distillation_trajectories_tpu/diffusion/parallel_sampling.py``).

A latency-oriented companion to the sequential engine sampler: the chain is
treated as a fixed-point problem and iterated in sweeps, each sweep
evaluating the model at many timesteps as one batched forward
(ParaDiGMS-style parallel sampling, Shih et al. 2023).  The per-step noise
is fixed in ``(seed, t)`` (:func:`.sampling.draw_step_noise`, injectable as
``step_noise``), so the sequential chain is a deterministic function of the
starting noise and the iteration converges to it: after k sweeps the first
k steps are final, so ``T−1`` sweeps (or ``tol=0``) reproduce the
sequential trajectory, up to the rounding a W·B-row forward gives where the
chain runs B rows.

The per-step update takes c1, c2 and σ per row of the window, so it is
plain torch (:func:`_rows_update`), in the order of the CFG-update kernel's
plain version; this path launches no kernel.  Each sweep reads its exit
test (the max state change, or the window's converged run) on the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .sampling import _engine_scalars, _step_noise_for, draw_step_noise

ModelFn = Callable[..., torch.Tensor]


def _use_cfg(guidance_scale, use_cfg) -> Tuple[bool, float]:
    if use_cfg is None:
        use_cfg = guidance_scale is not None and float(guidance_scale) > 1.0
    return use_cfg, 1.0 if guidance_scale is None else float(guidance_scale)


def _step_scalars(alphas, ts, device) -> torch.Tensor:
    """``[3, len(ts)]`` float32 (c1, c2, σ) of the engine update at each
    ``t`` of ``ts``, with the sequential chain's expressions."""
    alphas = np.asarray(alphas, dtype=np.float32)
    rows = [_engine_scalars(alphas[t], alphas[t - 1]) for t in ts]
    return torch.tensor(np.array(rows, dtype=np.float32).T, device=device)


def _rows_update(x, eps, noise, c1, c2, sigma) -> torch.Tensor:
    """``c1·x − c2·ε̂ + σ·n`` with per-row ``[R]`` coefficients over
    ``[R, B, …]`` states."""
    shape = (-1,) + (1,) * (x.ndim - 1)
    return c1.reshape(shape) * x - c2.reshape(shape) * eps + sigma.reshape(shape) * noise


def _eps(model_fn, states, tvec, use_cfg, gs) -> torch.Tensor:
    """ε̂ of ``[R, B, …]`` states at per-row timesteps, as one ``R·B``-row
    forward (two under CFG: cond 0 and cond 1, both with mask 1)."""
    flat = states.reshape((-1,) + tuple(states.shape[2:]))
    rows = flat.shape[0]
    zeros = flat.new_zeros((rows, 1))
    if use_cfg:
        ones = flat.new_ones((rows, 1))
        pred_u = model_fn(flat, tvec, zeros, ones)
        pred_c = model_fn(flat, tvec, ones, ones)
        eps = pred_u + gs * (pred_c - pred_u)
    else:
        eps = model_fn(flat, tvec, zeros, zeros)
    return eps.reshape(states.shape)


def _default_step_noise(step_noise, seed, timesteps, noise):
    if step_noise is None:
        step_noise = draw_step_noise([seed], timesteps, noise.shape, noise.device)[:, 0]
    return _step_noise_for(step_noise, timesteps, noise)


def parallel_generate_trajectory(
    model_fn: ModelFn,
    noise: torch.Tensor,
    timesteps: int,
    alphas,
    seed: int,
    guidance_scale: Optional[float] = None,
    use_cfg: Optional[bool] = None,
    max_sweeps: Optional[int] = None,
    tol: float = 0.0,
    step_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """Trajectory by full-chain Picard sweeps: every sweep runs the model
    at all ``T−1`` steps as one ``(T−1)·B``-row forward.

    ``max_sweeps`` defaults to ``T−1`` (the exact-convergence bound);
    iteration stops early once the largest state change of a sweep is at
    most ``tol``.  ``step_noise``: ``[T-1, B, H, W, C]``, row ``j`` for step
    ``t = T-1-j``; by default the sequential sampler's draw from
    ``(seed, t)``.  Returns ``(trajectory [T+1, B, H, W, C], sweeps)`` in
    the sequential sampler's layout (noise first, last two equal).
    """
    use_cfg, gs = _use_cfg(guidance_scale, use_cfg)
    n_steps = timesteps - 1
    if max_sweeps is None:
        max_sweeps = n_steps
    b = noise.shape[0]
    ts = list(range(timesteps - 1, 0, -1))
    step_noise = _default_step_noise(step_noise, seed, timesteps, noise)
    c1, c2, sigma = _step_scalars(alphas, ts, noise.device)
    tvec = torch.tensor(ts, dtype=torch.float32, device=noise.device).repeat_interleave(b)

    def sweep_once(states):
        """``states[i]`` is the input of step i; ``states[0]`` stays the
        starting noise."""
        outputs = _rows_update(states, _eps(model_fn, states, tvec, use_cfg, gs),
                               step_noise, c1, c2, sigma)
        return torch.cat([states[:1], outputs[:-1]]), outputs

    states, outputs = sweep_once(noise.expand(n_steps, *noise.shape).clone())
    sweeps, delta = 1, float("inf")
    while sweeps < max_sweeps and delta > tol:
        new_states, outputs = sweep_once(states)
        delta = float((new_states - states).abs().max())
        states = new_states
        sweeps += 1
    return torch.cat([noise[None], outputs, outputs[-1:]]), sweeps


def sliding_window_trajectory(
    model_fn: ModelFn,
    noise: torch.Tensor,
    timesteps: int,
    alphas,
    seed: int,
    guidance_scale: Optional[float] = None,
    use_cfg: Optional[bool] = None,
    window: int = 8,
    tol: float = 1e-3,
    step_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """Sliding-window ParaDiGMS: a window of ``W`` consecutive steps is
    iterated together, one sweep evaluating the model at all W timesteps as
    one ``W·B``-row forward; then the leading positions whose inputs moved
    by at most ``tol`` (RMS per pixel) are final and the window slides past
    them.  Position 0's input is always final (the frontier), so each sweep
    finalizes at least one step: at worst the sequential sweep count, at
    best several steps a sweep.

    ``tol=0`` finalizes one step a sweep and reproduces the sequential
    chain (the positions ahead serve only as warm starts); with ``tol>0``
    later steps are accepted within tolerance of it.  Window positions past
    the last step take ``t=1`` and its noise; their outputs are never
    written.  ``step_noise`` as in :func:`parallel_generate_trajectory`.
    Returns ``(trajectory [T+1, B, H, W, C], sweeps)``.
    """
    use_cfg, gs = _use_cfg(guidance_scale, use_cfg)
    n_steps = timesteps - 1
    w = min(window, n_steps)
    b = noise.shape[0]
    device = noise.device
    ts = list(range(timesteps - 1, 0, -1)) + [1] * w
    step_noise = _default_step_noise(step_noise, seed, timesteps, noise)
    scalars = _step_scalars(alphas, ts, device)  # [3, n_steps + w]
    tvecs = torch.tensor(ts, dtype=torch.float32, device=device).repeat_interleave(b)
    noise_rows = torch.cat([step_noise, step_noise[-1:].expand(w, *step_noise.shape[1:])])

    buf = noise.new_zeros((timesteps + 1, *noise.shape))
    buf[0] = noise
    states = noise.expand(w, *noise.shape).clone()
    f = sweeps = 0
    while f < n_steps:
        c1, c2, sigma = scalars[:, f:f + w]
        eps = _eps(model_fn, states, tvecs[f * b:(f + w) * b], use_cfg, gs)
        outputs = _rows_update(states, eps, noise_rows[f:f + w], c1, c2, sigma)
        new_inputs = torch.cat([states[:1], outputs[:-1]])
        drift = (new_inputs - states).square().mean(dim=tuple(range(1, states.ndim))).sqrt()
        converged = (drift <= tol).to(torch.int32)
        # 1 (position 0 is final) + the converged run from position 1; one
        # host read a sweep.
        k = min(1 + int(torch.cumprod(converged[1:], 0).sum()), n_steps - f)
        buf[f + 1:f + 1 + k] = outputs[:k]
        # Slide: position j takes new_inputs[j + k]; past the window's end,
        # warm-start from the newest output; position 0 is the frontier.
        states = torch.cat([new_inputs[k:], outputs[-1:].expand(k, *outputs.shape[1:])])
        states[0] = buf[f + k]
        f += k
        sweeps += 1
    buf[timesteps] = buf[timesteps - 1]
    return buf, sweeps
