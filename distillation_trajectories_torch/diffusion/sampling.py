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
:func:`..ops.cfg_update.cfg_engine_update_row`, which launches the Triton
kernel on CUDA tensors and runs its plain version on CPU tensors, with its
scalars in row ``j`` of a ``[T-1, 4]`` table that goes to the device once
a chain.  JAX compiles each chain into one program under ``jax.jit``; the
port's counterparts are :func:`make_batch_chain_fn` and
:func:`make_loop_fn`, which the makers (trajectory engine, manager, grid,
FID) return, and :func:`make_chain_fn`, the benches' single-seed chain:
on the card each captures its chains into CUDA graphs after one eager
warm-up of their input signature, the CFG and CFG-off graphs of one maker
sharing their static inputs and output, and replays them from then on; a
call with ``eager=True`` runs the same body eagerly (``utils/graphs.py``,
which also lists what stays eager).  JAX's
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

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import COUNTED
from ..ops.cfg_update import cfg_engine_update, cfg_engine_update_row
from ..utils.graphs import CapturedCall, host_to_device
from ..utils.profiling import span
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
    """Two-pass CFG: cond=1 against the reference's cond=None (mask 0).
    ``guidance_scale`` is a float or a 0-d float32 tensor on ``x``'s
    device (the same bits)."""
    b = x.shape[0]
    ones = torch.ones((b, 1), dtype=x.dtype, device=x.device)
    zeros = torch.zeros((b, 1), dtype=x.dtype, device=x.device)
    cond_out = model_fn(x, t, ones, ones)
    uncond_out = model_fn(x, t, zeros, zeros)
    return uncond_out + guidance_scale * (cond_out - uncond_out)


def _reference_update(x, eps, noise, betas_t, sqrt_omac_t, sqrt_recip_alphas_t,
                      posterior_var_t=None):
    pred_direction = (1.0 - sqrt_omac_t) * eps
    return sqrt_recip_alphas_t * (x - pred_direction) + noise * betas_t


def _ancestral_update(x, eps, noise, betas_t, sqrt_omac_t, sqrt_recip_alphas_t,
                      posterior_var_t):
    mean = sqrt_recip_alphas_t * (x - betas_t / sqrt_omac_t * eps)
    return mean + torch.sqrt(posterior_var_t) * noise


# The schedule columns of a loop step, in the updates' argument order.
_LOOP_COLUMNS = ("betas", "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas",
                 "posterior_variance")


def p_sample(model_fn, x, t, t_index: int, diffusion_params, noise,
             guidance_scale: float = 1.0) -> torch.Tensor:
    """One reverse step in the reference's non-standard formulation,
    ``x ← 1/√α·(x − (1−√(1−ᾱ))·ε̂) + noise·β``; ``noise`` is dropped at
    ``t_index == 0``."""
    coefs = [extract(diffusion_params[k], t, x.shape) for k in _LOOP_COLUMNS[:3]]
    model_output = _cfg_output(model_fn, x, t, guidance_scale)
    if t_index == 0:
        noise = torch.zeros_like(x)
    return _reference_update(x, model_output, noise, *coefs)


def p_sample_ancestral(model_fn, x, t, t_index: int, diffusion_params, noise,
                       guidance_scale: float = 1.0) -> torch.Tensor:
    """Textbook DDPM ancestral step (Ho et al. 2020, Eq. 11):
    ``1/√α_t·(x_t − β_t/√(1−ᾱ_t)·ε̂) + √β̃_t·z``."""
    coefs = [extract(diffusion_params[k], t, x.shape) for k in _LOOP_COLUMNS]
    eps = _cfg_output(model_fn, x, t, guidance_scale)
    if t_index == 0:
        noise = torch.zeros_like(x)
    return _ancestral_update(x, eps, noise, *coefs)


def _loop_table(diffusion_params, indices) -> np.ndarray:
    """``[n_steps, 5]`` float32: row ``j`` holds the four schedule
    coefficients of step ``indices[j]`` (clamped, as ``extract`` clamps)
    and, in column 4, the guidance scale (1.0 here)."""
    cols = []
    for k in _LOOP_COLUMNS:
        a = diffusion_params[k]
        a = np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, dtype=np.float32)
        cols.append(a[np.clip(indices, 0, a.shape[0] - 1)])
    cols.append(np.ones(len(indices), dtype=np.float32))
    return np.stack(cols, axis=1)


def _loop_chain(model_fn, x, table, step_noise, indices, mode: str, track_trajectory: bool):
    """The reverse loop from ``x`` on ``table``'s rows (a ``[n_steps, 5]``
    :func:`_loop_table` on ``x``'s device, the guidance in column 4), so
    that nothing crosses from the host between steps."""
    update = _ancestral_update if mode == "ancestral" else _reference_update
    states = [x]
    for j, t_index in enumerate(indices):
        t = torch.full((x.shape[0],), int(t_index), dtype=torch.int32, device=x.device)
        row = table[j].unbind()
        eps = _cfg_output(model_fn, x, t, row[4])
        noise = torch.zeros_like(x) if t_index == 0 else step_noise[j]
        x = update(x, eps, noise, *row[:4])
        if track_trajectory:
            states.append(x)
    if track_trajectory:
        return x, torch.stack(states)
    return x


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
    ``[n_steps + 1, *shape]``.  The schedule coefficients and the guidance
    go to the device once, as one table, so the steps make no host copy.
    """
    if num_timesteps is None:
        num_timesteps = sample_steps
    indices = subsampled_timestep_indices(sample_steps, num_timesteps)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    if step_noise is None:
        step_noise = torch.randn((len(indices), *shape), generator=generator,
                                 device=noise.device)
    if tuple(step_noise.shape) != (len(indices), *shape):
        raise ValueError(f"step_noise has shape {tuple(step_noise.shape)}, "
                         f"expected {(len(indices), *shape)}")
    table = _loop_table(diffusion_params, indices)
    table[:, 4] = guidance_scale
    return _loop_chain(model_fn, noise, host_to_device(table, noise.device),
                       step_noise.to(noise.device), indices, mode, track_trajectory)


def make_loop_fn(make_model_fn, shape, sample_steps: int, diffusion_params, *,
                 captures: Callable[[torch.device], bool],
                 num_timesteps: Optional[int] = None, mode: str = "reference"):
    """The samplers' compiled loop (JAX's jitted ``p_sample_loop``, as the
    grid and FID makers use it, at guidance 1.0): ``fn(noise, step_noise,
    params=None, eager=False) -> img`` over ``make_model_fn(params)``'s
    forward, ``params`` (tensors by name) standing in for the model's
    weights; the same chain as :func:`p_sample_loop`.

    The call runs through :class:`..utils.graphs.CapturedCall`: where
    ``captures(device)`` holds and ``eager`` is false, each key (the
    ``params`` names, the inputs' shapes and dtypes) runs eagerly on its
    first call, is captured into a CUDA graph on its second (its final
    image copied into the graph's static output) and replayed from then
    on; the start noise, the step noise, the coefficient table
    (the guidance in its column 4, sent to the device once) and ``params``
    are the graph's inputs, copied into it each call, so a replay sees the
    weights it is given (and ``params=None``, the model's own weights,
    changed in place).  Otherwise the same body runs eagerly."""
    indices = subsampled_timestep_indices(
        sample_steps, sample_steps if num_timesteps is None else num_timesteps)
    host_table = _loop_table(diffusion_params, indices)
    tables: Dict[torch.device, torch.Tensor] = {}
    graphs = CapturedCall(captures, counted=COUNTED)

    def fn(noise, step_noise, params=None, eager=False):
        device = noise.device
        if tuple(noise.shape) != tuple(shape) or \
                tuple(step_noise.shape) != (len(indices), *shape):
            raise ValueError(f"noise {tuple(noise.shape)} and step_noise "
                             f"{tuple(step_noise.shape)} do not fit {tuple(shape)}")
        if device not in tables:
            tables[device] = host_to_device(host_table, device)
        names = None if params is None else tuple(params)

        def body(x, n, tab, *values, out=None):
            model_fn = make_model_fn(None if names is None else dict(zip(names, values)))
            img = _loop_chain(model_fn, x, tab, n, indices, mode, False)
            return img if out is None else out.copy_(img)

        values = [] if names is None else [params[k] for k in names]
        make_model_fn(params)  # its effect on the model (eval mode), on a replay too
        return graphs(names, body, noise, step_noise.to(device), tables[device], *values,
                      eager=eager)

    fn.graphs = graphs
    return fn


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
    generator seeded from ``keys[i] = (seed, t)`` alone.  One ``draws``
    span (``n``: the keys drawn)."""
    device = torch.device(device)
    with span("draws", n=len(keys)):
        out = torch.empty((len(keys), *shape), device=device, dtype=dtype)
        gen = torch.Generator(device=device)
        for i, (seed, t) in enumerate(keys):
            gen.manual_seed(_generator_seed(seed, t))
            out[i].normal_(generator=gen)
    return out


# The per-sample stream of class labels: the generator key ``(seed,
# LABEL_STREAM)``, which no step's ``(seed, t)`` takes.
LABEL_STREAM = 0xFFFFFFFF


def sample_labels(seeds, num_classes: int, device) -> torch.Tensor:
    """``[S]`` int64 class labels, uniform over ``[0, num_classes)``:
    sample ``i``'s from its seed alone (splitmix64 of ``(seeds[i],
    LABEL_STREAM)`` modulo ``num_classes``), so it does not depend on the
    batch it rides in.  One ``draws`` span (``n``, ``kind="labels"``)."""
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    with span("draws", n=len(seeds), kind="labels"):
        labels = np.array([_generator_seed(s, LABEL_STREAM) % num_classes for s in seeds],
                          dtype=np.int64)
        return host_to_device(labels, device)


def draw_step_noise(seeds, timesteps: int, shape, device, dtype=torch.float32):
    """Default per-step noise ``[T-1, S, *shape]``: sample ``i`` at step
    ``t`` from the generator of ``(seeds[i], t)``."""
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    keys = [(s, t) for t in range(timesteps - 1, 0, -1) for s in seeds]
    return seeded_normal(keys, shape, device, dtype).reshape(
        max(timesteps - 1, 0), len(seeds), *shape
    )


def _engine_table(timesteps: int, alphas, g=1.0) -> np.ndarray:
    """``[T-1, 4]`` float32: row ``j`` holds c1, c2, σ of step
    ``t = T-1-j`` (:func:`_engine_scalars`, the same bits) and ``g``."""
    alphas = np.asarray(alphas, dtype=np.float32)
    rows = [(*_engine_scalars(alphas[t], alphas[t - 1]), g)
            for t in range(timesteps - 1, 0, -1)]
    return np.array(rows, dtype=np.float32).reshape(-1, 4)


def _engine_chain(model_fn, x, table, cond_pairs, step_noise, states, labels=None):
    """Run the chain from ``x`` on ``table``'s scalars (an
    :func:`_engine_table` on ``x``'s device: step ``j`` launches the kernel
    on row ``j``, so nothing crosses from the host between steps), writing
    the ``T+1`` states into ``states`` (a ``[T+1, B, …]`` view, possibly of
    another dtype).  ``labels`` (``[B]`` class labels of a class-conditional
    model) go to every forward after its ``(cond, mask)``; without them the
    forward takes those two alone."""
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
    extra = () if labels is None else (labels,)
    timesteps = table.shape[0] + 1
    states[0] = x
    for j, t in enumerate(range(timesteps - 1, 0, -1)):
        tvec = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        uncond = model_fn(x, tvec, *conds[0], *extra)
        cond = uncond if one_forward else model_fn(x, tvec, *conds[1], *extra)
        x = cfg_engine_update_row(x, uncond, cond, step_noise[j], table[j])
        states[j + 1] = x
    states[timesteps] = x


def _batch_states(model_fn, noises, table, cond_pairs, step_noise, store_dtype, labels=None,
                  out=None):
    """``[S, T+1, H, W, C]`` states of the batched chain from ``noises``,
    written into ``out`` where given (a captured chain's static output)."""
    if out is None:
        out = torch.empty(
            (noises.shape[0], table.shape[0] + 2, *noises.shape[1:]),
            dtype=store_dtype or noises.dtype,
            device=noises.device,
        )
    _engine_chain(model_fn, noises, table, cond_pairs, step_noise, out.transpose(0, 1), labels)
    return out


def _step_noise_for(step_noise, timesteps, x):
    expected = (max(timesteps - 1, 0), *x.shape)
    if tuple(step_noise.shape) != expected:
        raise ValueError(
            f"step_noise has shape {tuple(step_noise.shape)}, expected {expected}"
        )
    return step_noise.to(device=x.device, dtype=x.dtype).contiguous()


def _scan_guidance(guidance_scale, use_cfg):
    """``(use_cfg, g)`` of a single-seed chain: CFG iff ``guidance_scale >
    1.0`` unless ``use_cfg`` says otherwise (JAX decides it so for a Python
    scale and runs CFG for a traced one, whatever its value), and ``g`` 1.0
    without it."""
    if use_cfg is None:
        use_cfg = guidance_scale is not None and float(guidance_scale) > 1.0
    return bool(use_cfg), 1.0 if guidance_scale is None or not use_cfg else float(guidance_scale)


def _scan_states(model_fn, noise, table, cond_pairs, step_noise, store_dtype, out=None):
    """``[T+1, B, H, W, C]`` states of the chain from ``noise``, written
    into ``out`` where given (a captured chain's static output)."""
    states = out if out is not None else torch.empty(
        (table.shape[0] + 2, *noise.shape), dtype=store_dtype or noise.dtype,
        device=noise.device)
    _engine_chain(model_fn, noise, table, cond_pairs, step_noise, states)
    return states


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
    ``guidance_scale > 1.0``, or as ``use_cfg`` says; otherwise one cond-0
    mask-0 forward.  The default step noise is one ``[B, H, W, C]`` draw per
    step from the generator of ``(seed, t)``.  ``store_dtype`` casts only
    the stored states; the carry and the update math stay float32.
    """
    use_cfg, g = _scan_guidance(guidance_scale, use_cfg)
    if step_noise is None:
        step_noise = draw_step_noise([seed], timesteps, noise.shape, noise.device)[:, 0]
    step_noise = _step_noise_for(step_noise, timesteps, noise)
    table = host_to_device(_engine_table(timesteps, alphas, g), noise.device)
    return _scan_states(model_fn, noise, table, CFG_COND_PAIRS if use_cfg else NOCFG_COND_PAIRS,
                        step_noise, store_dtype)


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
    labels: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample-batched, CFG-unified engine sampler (the sweep hot path).

    ``noises [S, H, W, C]`` ride the model's batch axis; ``cond_pairs``
    (:data:`CFG_COND_PAIRS` or :data:`NOCFG_COND_PAIRS`) selects the two
    forwards.  The default step noise draws sample ``i`` at step ``t`` from
    the generator of ``(seeds[i], t)``.  ``labels`` (``[S]``) are a
    class-conditional model's (:func:`sample_labels`).  Returns
    ``[S, T+1, H, W, C]``.
    """
    if step_noise is None:
        step_noise = draw_step_noise(seeds, timesteps, noises.shape[1:], noises.device)
    step_noise = _step_noise_for(step_noise, timesteps, noises)
    table = host_to_device(_engine_table(timesteps, alphas, float(guidance_scale)),
                           noises.device)
    return _batch_states(model_fn, noises, table, cond_pairs, step_noise, store_dtype, labels)


def _table_with_scale(tables, host_table, device, g):
    """A fresh copy of ``host_table`` on ``device`` (sent there once, into
    ``tables``) with ``g`` in column 3: one call's table, and on the
    captured lane the graph's input, copied in before the replay."""
    if device not in tables:
        tables[device] = host_to_device(host_table, device)
    table = tables[device].clone()
    table[:, 3].fill_(g)
    return table


def make_batch_chain_fn(model_fn, timesteps: int, alphas, store_dtype=None, *,
                        captures: Callable[[torch.device], bool]):
    """The makers' compiled chain (JAX's jitted
    :func:`generate_trajectory_batch_scan`): ``fn(noises, seeds,
    cond_pairs, gs, step_noise=None, labels=None, eager=False) -> [S, T+1,
    H, W, C]`` of one model forward at one T and store dtype, the chain
    :func:`generate_trajectory_batch_scan` computes.

    The call runs through :class:`..utils.graphs.CapturedCall`: where
    ``captures(device)`` holds and ``eager`` is false, the first call of an
    input signature (the inputs' shapes and dtypes) runs eagerly, its
    warm-up; each key (the cond pairs, so CFG on or off, and the signature)
    is captured into a CUDA graph on its next call and replayed from then
    on, so a CFG-off key whose signature a CFG call warmed up is captured on
    its first call.  The CFG and CFG-off graphs of one signature share
    their static inputs and output (the states are written into it,
    ``_batch_states(out=)``); each call returns a copy.  The noises, the
    step noise, the scalar table and, for a class-conditional model, the
    ``labels`` are the graph's inputs (without labels the graph has the
    first three alone), and ``gs`` is written into a copy of the device
    table's column 3 before each call, so one graph serves every guidance
    scale.
    Otherwise the same body runs eagerly on the same inputs.  The step
    noise is drawn outside the graph (:func:`draw_step_noise` seeds a
    generator from the host per ``(seed, t)``)."""
    host_table = _engine_table(timesteps, alphas)
    tables: Dict[torch.device, torch.Tensor] = {}
    graphs = CapturedCall(captures, counted=COUNTED)

    def fn(noises, seeds, cond_pairs, gs, step_noise=None, labels=None, eager=False):
        device = noises.device
        if step_noise is None:
            step_noise = draw_step_noise(seeds, timesteps, noises.shape[1:], device)
        step_noise = _step_noise_for(step_noise, timesteps, noises)
        table = _table_with_scale(tables, host_table, device, float(gs))
        pairs = np.asarray(cond_pairs, dtype=np.float32)
        body = lambda x, n, tab, *lab, out=None: _batch_states(model_fn, x, tab, pairs, n,
                                                               store_dtype, *lab, out=out)
        inputs = (noises, step_noise, table) + (() if labels is None else (labels,))
        return graphs(pairs.tobytes(), body, *inputs, eager=eager)

    fn.graphs = graphs
    return fn


def make_chain_fn(model_fn, timesteps: int, alphas, store_dtype=None, *,
                  captures: Callable[[torch.device], bool]):
    """The benches' compiled chain (their ``jax.jit`` of
    :func:`generate_trajectory_scan` over one model): ``fn(noise, seed,
    guidance_scale=None, use_cfg=None, step_noise=None, eager=False) ->
    [T+1, B, H, W, C]``, the arguments read as
    :func:`generate_trajectory_scan` reads them, and its chain.

    The call runs through :class:`..utils.graphs.CapturedCall`: where
    ``captures(device)`` holds and ``eager`` is false, the first call of an
    input signature (the inputs' shapes and dtypes) runs eagerly, its
    warm-up; each key (CFG on or off, and the signature) is captured into a
    CUDA graph on its next call and replayed from then on, the two keys of
    a signature sharing their static inputs and output; the noise, the
    step noise and the scalar table are the graph's inputs, and the
    guidance scale is written into a copy of the device table's column 3
    before each call, so one graph serves every scale.  Otherwise the same body runs eagerly on the same inputs.  The
    step noise is drawn outside the graph from ``(seed, t)``, as the eager
    chain draws it, unless ``step_noise`` is given.  What the forward reads
    besides its inputs it reads where it was captured: a model input that
    varies per call (the guided student's ``w``,
    :func:`..training.progressive.make_guided_eval_fn`) is a tensor changed
    in place."""
    host_table = _engine_table(timesteps, alphas)
    tables: Dict[torch.device, torch.Tensor] = {}
    graphs = CapturedCall(captures, counted=COUNTED)

    def fn(noise, seed, guidance_scale=None, use_cfg=None, step_noise=None, eager=False):
        use_cfg, g = _scan_guidance(guidance_scale, use_cfg)
        if step_noise is None:
            step_noise = draw_step_noise([seed], timesteps, noise.shape, noise.device)[:, 0]
        step_noise = _step_noise_for(step_noise, timesteps, noise)
        table = _table_with_scale(tables, host_table, noise.device, g)
        pairs = CFG_COND_PAIRS if use_cfg else NOCFG_COND_PAIRS
        body = lambda x, n, tab, out=None: _scan_states(model_fn, x, tab, pairs, n, store_dtype,
                                                        out=out)
        return graphs(use_cfg, body, noise, step_noise, table, eager=eager)

    fn.graphs = graphs
    return fn
