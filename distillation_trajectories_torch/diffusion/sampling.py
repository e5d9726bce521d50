"""Reverse-process samplers (port of ``diffusion/sampling.py``).

``p_sample`` / ``p_sample_ancestral`` / ``p_sample_loop`` are the reference
formulation that training-time sample grids use (JAX ``sampling.py:40-151``);
their starting and per-step noise are injectable, as below.

The trajectory-engine samplers (JAX ``sampling.py:154-392``) follow.
The engine formulation: a DDIM-like c1/c2/σ update on *per-step* alphas over
``t = T-1 … 1``; the t=0 iteration makes no update, so its forward is
skipped and the final state duplicated, giving ``[T+1, …]`` states with the
starting noise first.  The JAX ``lax.scan`` becomes a Python loop over
steps; every step's update tail (CFG combine + engine update) goes through
:func:`..ops.cfg_update.cfg_engine_update`, which launches the Triton kernel
on CUDA tensors and runs its plain version on CPU tensors.  JAX's
``use_pallas`` picks between its fused kernel and the unfused combine then
``engine_update``; the fused function computes the unfused tail (bit-equal
on the CPU), so the port has the one tail under either value of
``Config.pallas_cfg_update``.

Per-step noise is injectable (``step_noise``, ``[T-1, …]`` with row ``j``
belonging to step ``t = T-1-j``), because torch cannot reproduce JAX's
threefry bits.  The default draw comes from a ``torch.Generator`` seeded
from ``(seed, t)`` alone, so a sample's noise at step t does not depend on
the batch it rides in or the model it feeds: teacher and student chains see
identical noise.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.cfg_update import cfg_engine_update
from .schedules import extract

ModelFn = Callable[..., torch.Tensor]

# (cond, cond_mask) rows of the two forwards per step.  CFG evaluates cond=0
# and cond=1 both through the conditioning MLP; no-CFG evaluates cond=None
# (cond 0, mask 0).  Equal rows mean one forward serves as both u and c.
CFG_COND_PAIRS = np.array([[0.0, 1.0], [1.0, 1.0]], dtype=np.float32)
NOCFG_COND_PAIRS = np.array([[0.0, 0.0], [0.0, 0.0]], dtype=np.float32)


def subsampled_timestep_indices(sample_steps: int, num_timesteps: int) -> np.ndarray:
    """Descending subsampled timestep indices."""
    step_size = max(1, sample_steps // num_timesteps)
    idx = {min(i * step_size, sample_steps - 1) for i in range(num_timesteps)}
    return np.array(sorted(idx, reverse=True), dtype=np.int32)


def _cfg_output(model_fn, x, t, guidance_scale):
    """Two-pass CFG: cond=1 against the reference's cond=None (mask 0)."""
    b = x.shape[0]
    ones = torch.ones((b, 1), dtype=x.dtype, device=x.device)
    zeros = torch.zeros((b, 1), dtype=x.dtype, device=x.device)
    cond_out = model_fn(x, t, ones, ones)
    uncond_out = model_fn(x, t, zeros, zeros)
    return uncond_out + guidance_scale * (cond_out - uncond_out)


def p_sample(model_fn, x, t, t_index: int, diffusion_params, noise,
             guidance_scale: float = 1.0) -> torch.Tensor:
    """One reverse step in the reference's non-standard formulation,
    ``x ← 1/√α·(x − (1−√(1−ᾱ))·ε̂) + noise·β``; ``noise`` is dropped at
    ``t_index == 0``."""
    betas_t = extract(diffusion_params["betas"], t, x.shape)
    sqrt_omac_t = extract(diffusion_params["sqrt_one_minus_alphas_cumprod"], t, x.shape)
    sqrt_recip_alphas_t = extract(diffusion_params["sqrt_recip_alphas"], t, x.shape)
    model_output = _cfg_output(model_fn, x, t, guidance_scale)
    pred_direction = (1.0 - sqrt_omac_t) * model_output
    if t_index == 0:
        noise = torch.zeros_like(x)
    return sqrt_recip_alphas_t * (x - pred_direction) + noise * betas_t


def p_sample_ancestral(model_fn, x, t, t_index: int, diffusion_params, noise,
                       guidance_scale: float = 1.0) -> torch.Tensor:
    """Textbook DDPM ancestral step (Ho et al. 2020, Eq. 11):
    ``1/√α_t·(x_t − β_t/√(1−ᾱ_t)·ε̂) + √β̃_t·z``."""
    betas_t = extract(diffusion_params["betas"], t, x.shape)
    sqrt_omac_t = extract(diffusion_params["sqrt_one_minus_alphas_cumprod"], t, x.shape)
    sqrt_recip_alphas_t = extract(diffusion_params["sqrt_recip_alphas"], t, x.shape)
    posterior_var_t = extract(diffusion_params["posterior_variance"], t, x.shape)
    eps = _cfg_output(model_fn, x, t, guidance_scale)
    mean = sqrt_recip_alphas_t * (x - betas_t / sqrt_omac_t * eps)
    if t_index == 0:
        noise = torch.zeros_like(x)
    return mean + torch.sqrt(posterior_var_t) * noise


def p_sample_loop(
    model_fn: ModelFn,
    shape: Tuple[int, ...],
    sample_steps: int,
    diffusion_params,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    num_timesteps: Optional[int] = None,
    track_trajectory: bool = False,
    guidance_scale: float = 1.0,
    mode: str = "reference",
    device=None,
):
    """The full reverse loop over the subsampled timesteps, descending.

    ``noise`` (``shape``) starts the chain and ``step_noise``
    (``[n_steps, *shape]``) feeds step ``j``; each one missing is drawn
    from ``generator`` on ``device``.  ``mode="ancestral"`` uses the DDPM
    update.  Returns ``img`` or ``(img, trajectory)`` with trajectory
    ``[n_steps + 1, *shape]``.
    """
    if num_timesteps is None:
        num_timesteps = sample_steps
    indices = subsampled_timestep_indices(sample_steps, num_timesteps)
    step_fn = p_sample_ancestral if mode == "ancestral" else p_sample
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    if step_noise is None:
        step_noise = torch.randn((len(indices), *shape), generator=generator,
                                 device=noise.device)
    if tuple(step_noise.shape) != (len(indices), *shape):
        raise ValueError(f"step_noise has shape {tuple(step_noise.shape)}, "
                         f"expected {(len(indices), *shape)}")
    x = noise
    states = [x]
    for j, t_index in enumerate(indices):
        t = torch.full((shape[0],), int(t_index), dtype=torch.int32, device=x.device)
        x = step_fn(model_fn, x, t, int(t_index), diffusion_params,
                    step_noise[j].to(x.device), guidance_scale)
        if track_trajectory:
            states.append(x)
    if track_trajectory:
        return x, torch.stack(states)
    return x


def _engine_scalars(alpha_t, alpha_prev) -> Tuple[np.float32, np.float32, np.float32]:
    """c1, c2, σ in float32, with the JAX ``engine_update`` expressions."""
    one = np.float32(1.0)
    alpha_t = np.float32(alpha_t)
    alpha_prev = np.float32(alpha_prev)
    c1 = np.sqrt(alpha_prev) / np.sqrt(alpha_t)
    c2 = np.sqrt(one - alpha_prev) - np.sqrt(alpha_prev / alpha_t) * np.sqrt(one - alpha_t)
    sigma = np.sqrt(one - alpha_prev) * np.sqrt(one - alpha_t / alpha_prev)
    return c1, c2, sigma


def engine_update(x, noise_pred, noise, alpha_t, alpha_prev) -> torch.Tensor:
    """Engine update ``c1·x − c2·ε̂ + σ·n`` on per-step alphas (not
    cumulative products), as the reference does."""
    c1, c2, sigma = _engine_scalars(alpha_t, alpha_prev)
    return cfg_engine_update(x, noise_pred, noise_pred, noise, c1, c2, sigma, 1.0)


def _generator_seed(seed: int, t: int) -> int:
    """splitmix64 of ``(seed, t)``: the CPU generator keeps only the low 32
    bits of its seed, so both inputs are mixed into all 64."""
    mask = 0xFFFFFFFFFFFFFFFF
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(t) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


def seeded_normal(keys: Sequence[Tuple[int, int]], shape, device, dtype=torch.float32):
    """``[len(keys), *shape]`` standard normals; row ``i`` comes from a
    generator seeded from ``keys[i] = (seed, t)`` alone."""
    device = torch.device(device)
    out = torch.empty((len(keys), *shape), device=device, dtype=dtype)
    gen = torch.Generator(device=device)
    for i, (seed, t) in enumerate(keys):
        gen.manual_seed(_generator_seed(seed, t))
        out[i].normal_(generator=gen)
    return out


def draw_step_noise(seeds, timesteps: int, shape, device, dtype=torch.float32):
    """Default per-step noise ``[T-1, S, *shape]``: sample ``i`` at step
    ``t`` from the generator of ``(seeds[i], t)``."""
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    keys = [(s, t) for t in range(timesteps - 1, 0, -1) for s in seeds]
    return seeded_normal(keys, shape, device, dtype).reshape(
        max(timesteps - 1, 0), len(seeds), *shape
    )


def _engine_chain(model_fn, x, timesteps, alphas, cond_pairs, g, step_noise, states):
    """Run the chain from ``x``, writing the ``T+1`` states into
    ``states`` (a ``[T+1, B, …]`` view, possibly of another dtype)."""
    alphas = np.asarray(alphas, dtype=np.float32)
    pairs = np.asarray(cond_pairs, dtype=np.float32)
    b = x.shape[0]
    conds = [
        (
            torch.full((b, 1), float(c), dtype=x.dtype, device=x.device),
            torch.full((b, 1), float(m), dtype=x.dtype, device=x.device),
        )
        for c, m in pairs
    ]
    one_forward = bool(np.array_equal(pairs[0], pairs[1]))
    g = float(g)
    states[0] = x
    for j, t in enumerate(range(timesteps - 1, 0, -1)):
        tvec = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        uncond = model_fn(x, tvec, *conds[0])
        cond = uncond if one_forward else model_fn(x, tvec, *conds[1])
        c1, c2, sigma = _engine_scalars(alphas[t], alphas[t - 1])
        x = cfg_engine_update(x, uncond, cond, step_noise[j], c1, c2, sigma, g)
        states[j + 1] = x
    states[timesteps] = x


def _step_noise_for(step_noise, timesteps, x):
    expected = (max(timesteps - 1, 0), *x.shape)
    if tuple(step_noise.shape) != expected:
        raise ValueError(
            f"step_noise has shape {tuple(step_noise.shape)}, expected {expected}"
        )
    return step_noise.to(device=x.device, dtype=x.dtype).contiguous()


def generate_trajectory_scan(
    model_fn: ModelFn,
    noise: torch.Tensor,
    timesteps: int,
    alphas,
    seed: int,
    guidance_scale: Optional[float] = None,
    use_cfg: Optional[bool] = None,
    store_dtype: Optional[torch.dtype] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One engine trajectory of a ``[B, H, W, C]`` batch: ``[T+1, B, H, W, C]``.

    CFG (two forwards, cond 0 and cond 1, both with mask 1) is on iff
    ``guidance_scale > 1.0``; otherwise one cond-0 mask-0 forward.  The
    default step noise is one ``[B, H, W, C]`` draw per step from the
    generator of ``(seed, t)``.  ``store_dtype`` casts only the stored
    states; the carry and the update math stay float32.
    """
    if use_cfg is None:
        use_cfg = guidance_scale is not None and float(guidance_scale) > 1.0
    g = 1.0 if guidance_scale is None or not use_cfg else float(guidance_scale)
    if step_noise is None:
        step_noise = draw_step_noise([seed], timesteps, noise.shape, noise.device)[:, 0]
    step_noise = _step_noise_for(step_noise, timesteps, noise)
    states = torch.empty(
        (timesteps + 1, *noise.shape), dtype=store_dtype or noise.dtype,
        device=noise.device,
    )
    pairs = CFG_COND_PAIRS if use_cfg else NOCFG_COND_PAIRS
    _engine_chain(model_fn, noise, timesteps, alphas, pairs, g, step_noise, states)
    return states


def generate_trajectory_batch_scan(
    model_fn: ModelFn,
    noises: torch.Tensor,
    timesteps: int,
    alphas,
    seeds,
    cond_pairs,
    guidance_scale,
    store_dtype: Optional[torch.dtype] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample-batched, CFG-unified engine sampler (the sweep hot path).

    ``noises [S, H, W, C]`` ride the model's batch axis; ``cond_pairs``
    (:data:`CFG_COND_PAIRS` or :data:`NOCFG_COND_PAIRS`) selects the two
    forwards.  The default step noise draws sample ``i`` at step ``t`` from
    the generator of ``(seeds[i], t)``.  Returns ``[S, T+1, H, W, C]``.
    """
    if step_noise is None:
        step_noise = draw_step_noise(seeds, timesteps, noises.shape[1:], noises.device)
    step_noise = _step_noise_for(step_noise, timesteps, noises)
    out = torch.empty(
        (noises.shape[0], timesteps + 1, *noises.shape[1:]),
        dtype=store_dtype or noises.dtype,
        device=noises.device,
    )
    _engine_chain(
        model_fn, noises, timesteps, alphas, cond_pairs, guidance_scale,
        step_noise, out.transpose(0, 1),
    )
    return out
