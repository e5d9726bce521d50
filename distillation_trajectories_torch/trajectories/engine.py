"""Trajectory generation and teacher/student comparison (port of
``trajectories/engine.py``).

A sweep runs one chain per (model, guidance scale) over all samples at once
(samples ride the U-Net's batch axis), with the teacher chains generated once
per (T, scale, draws) and shared by every student, and scores each pair
batch with the metric suite on the device.  The JAX package's TPU host
machinery (AOT compile pool, ``CompiledWithFallback``, the watchdog) has no
counterpart: PyTorch runs eagerly.

The three random draws of a sweep — starting noises, per-step noise and the
Wasserstein subsample keys — form one :class:`SweepDraws`, injectable as
``draws=`` so that a test can hand in the JAX draws.

``Config.mesh_shape`` shards a sweep's sample axis over the mesh's data
axis (one process per rank): the draws are made for all samples on every
rank, each rank runs and scores its rows' chains, and the per-sample
metrics are gathered before the means, so every rank returns the
unsharded result.  ``Config.spatial_shape`` sends
:func:`generate_trajectory` through the spatially partitioned forward.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..diffusion.sampling import (
    CFG_COND_PAIRS,
    NOCFG_COND_PAIRS,
    draw_step_noise,
    generate_trajectory_batch_scan,
    generate_trajectory_scan,
    seeded_normal,
)
from ..diffusion.schedules import get_diffusion_params
from ..metrics.trajectory_metrics import WASSERSTEIN_SAMPLE_SIZE, batch_metrics_core
from ..parallel.mesh import DATA_AXIS, axis_size, gather_batch, mesh_from_config, shard_batch
from ..training.state import make_eval_fn_from_config


@dataclasses.dataclass
class SweepDraws:
    """The random inputs of one sweep job.

    ``noises``: ``[S, H, W, C]`` starting noise.
    ``step_noise``: ``[T-1, S, H, W, C]``; row ``j`` is step ``t = T-1-j``.
    ``uniforms``: ``[S, T+1, H·W·C]`` Wasserstein subsample keys, or None
    when a state has no more pixels than the subsample size.
    """

    noises: torch.Tensor
    step_noise: torch.Tensor
    uniforms: Optional[torch.Tensor] = None

    def to(self, device) -> "SweepDraws":
        return SweepDraws(
            *(None if v is None else torch.as_tensor(v).to(device)
              for v in (self.noises, self.step_noise, self.uniforms))
        )


def _store_dtype(config) -> Optional[torch.dtype]:
    name = getattr(config, "trajectory_store_dtype", "float32") or "float32"
    if name == "bfloat16":
        return torch.bfloat16
    if name != "float32":
        raise ValueError(
            f"trajectory_store_dtype must be 'float32' or 'bfloat16', got {name!r}"
        )
    return None


def _entry_device(config, device) -> torch.device:
    if device is None:
        device = config.device if config is not None else "cuda"
    return resolve_device(device)


def _check_model_device(model: torch.nn.Module, device: torch.device) -> None:
    on = next(model.parameters()).device
    if on.type != device.type or (device.index is not None and on.index != device.index):
        raise ValueError(f"model is on {on}, the run asks for {device}")


def generate_trajectory(
    model,
    noise,
    timesteps: int,
    seed: Optional[int] = None,
    guidance_scale: Optional[float] = None,
    config=None,
    step_noise: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """One engine trajectory of a ``[B, H, W, C]`` noise batch:
    ``[T+1, B, H, W, C]`` on ``device`` (default ``config.device``).

    The forward is the config's (``make_eval_fn_from_config``: plain,
    int8, or spatially partitioned under ``Config.spatial_shape``, whose
    divisibility guards run on the starting noise up front, as in JAX).
    ``Config.parallel_sampling="window"`` switches to the
    sliding-window ParaDiGMS sampler
    (:func:`..diffusion.parallel_sampling.sliding_window_trajectory`, window
    ``paradigms_window``, tolerance ``paradigms_tol``), whose update is
    plain torch: it launches no kernel.  As in JAX, it says on stdout that
    ``Config.pallas_cfg_update`` is ignored when that is set.
    """
    device = _entry_device(config, device)
    _check_model_device(model, device)
    dp = get_diffusion_params(timesteps, config)
    model_fn = make_eval_fn_from_config(model, config)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(device)
    if config is not None and config.spatial_shape:
        from ..parallel.spatial import make_spatial_mesh, shard_batch_spatial

        shard_batch_spatial(noise, make_spatial_mesh(tuple(config.spatial_shape), device.type))
    seed = 0 if seed is None else seed
    if config is not None and getattr(config, "parallel_sampling", "off") == "window":
        from ..diffusion.parallel_sampling import sliding_window_trajectory

        if getattr(config, "pallas_cfg_update", False):
            print("[engine] parallel_sampling='window' has no fused update path; "
                  "pallas_cfg_update is ignored for this trajectory")
        traj, _ = sliding_window_trajectory(
            model_fn, noise, timesteps, dp["alphas"], seed,
            guidance_scale=guidance_scale,
            window=getattr(config, "paradigms_window", 8),
            tol=getattr(config, "paradigms_tol", 1e-3),
            step_noise=step_noise,
        )
        store = _store_dtype(config)
        return traj if store is None else traj.to(store)
    return generate_trajectory_scan(
        model_fn,
        noise,
        timesteps,
        dp["alphas"],
        seed=seed,
        guidance_scale=guidance_scale,
        store_dtype=_store_dtype(config),
        step_noise=step_noise,
    )


def make_batch_trajectory_fn(model, timesteps: int, config=None, use_cfg: bool = True,
                             device=None):
    """``fn(noises [S,H,W,C], seeds [S], gs, step_noise=None) -> trajs
    [S, T+1, H, W, C]`` for one model at a runtime guidance scale.

    Samples ride the U-Net's batch axis.  ``use_cfg`` selects the two CFG
    forwards (cond 0 and cond 1, both with mask 1) combined at ``gs``, or
    one cond-0 mask-0 forward.  The default step noise draws sample ``i``
    at step ``t`` from the generator of ``(seeds[i], t)``."""
    device = _entry_device(config, device)
    _check_model_device(model, device)
    sweep = make_sweep_trajectory_fn(model, timesteps, config)
    pairs = CFG_COND_PAIRS if use_cfg else NOCFG_COND_PAIRS

    def fn(noises, seeds, gs, step_noise=None):
        noises = torch.as_tensor(noises, dtype=torch.float32).to(device)
        if step_noise is None:
            step_noise = draw_step_noise(seeds, timesteps, noises.shape[1:], device)
        return sweep(noises, seeds, pairs, float(gs) if use_cfg else 1.0,
                     step_noise=step_noise)

    return fn


def make_paired_trajectory_fn(teacher_model, student_model, timesteps: int, config=None,
                              use_cfg: bool = True, device=None):
    """``fn(noises [S,H,W,C], seeds [S], gs, step_noise=None) ->
    (teacher_trajs, student_trajs)``, each ``[S, T+1, H, W, C]``.

    Both chains start from the same noises and take the same per-step
    noise (drawn once, by default paired in ``(seed, t)``), as the
    reference reseeds both chains alike."""
    teacher = make_batch_trajectory_fn(teacher_model, timesteps, config, use_cfg, device)
    student = make_batch_trajectory_fn(student_model, timesteps, config, use_cfg, device)
    device = _entry_device(config, device)

    def fn(noises, seeds, gs, step_noise=None):
        noises = torch.as_tensor(noises, dtype=torch.float32).to(device)
        if step_noise is None:
            step_noise = draw_step_noise(seeds, timesteps, noises.shape[1:], device)
        return (teacher(noises, seeds, gs, step_noise=step_noise),
                student(noises, seeds, gs, step_noise=step_noise))

    return fn


def make_sweep_trajectory_fn(model, timesteps: int, config=None):
    """``fn(noises [S,H,W,C], seeds [S], cond_pairs [2,2], gs, step_noise=None)
    -> trajs [S, T+1, H, W, C]`` for one model; CFG or not is the runtime
    ``cond_pairs`` input."""
    alphas = get_diffusion_params(timesteps, config)["alphas"]
    model_fn = make_eval_fn_from_config(model, config)
    store = _store_dtype(config)

    def fn(noises, seeds, cond_pairs, gs, step_noise=None):
        return generate_trajectory_batch_scan(
            model_fn, noises, timesteps, alphas, seeds, cond_pairs, gs,
            store_dtype=store, step_noise=step_noise,
        )

    return fn


def _sweep_inputs(config, num_samples: int, base_seed: int, timesteps: int,
                  device) -> SweepDraws:
    """Default draws of a sweep job: sample ``i`` has seed ``base_seed+i``;
    its starting noise comes from the generator of ``(seed, 0)`` and its
    step-t noise from that of ``(seed, t)``; the Wasserstein keys from one
    generator seeded with ``base_seed``."""
    seeds = [base_seed + i for i in range(num_samples)]
    shape = (config.image_size, config.image_size, config.channels)
    noises = seeded_normal([(s, 0) for s in seeds], shape, device)
    step_noise = draw_step_noise(seeds, timesteps, shape, device)
    d = int(np.prod(shape))
    uniforms = None
    if d > WASSERSTEIN_SAMPLE_SIZE:
        gen = torch.Generator(device=device).manual_seed(base_seed)
        uniforms = torch.rand(
            (num_samples, timesteps + 1, d), generator=gen, device=device
        )
    return SweepDraws(noises, step_noise, uniforms)


def sweep_compare_trajectories_multi(
    teacher_model,
    jobs: Sequence[dict],
    config,
    device=None,
    verbose: bool = True,
) -> List[Dict[float, Dict[str, Dict[float, Dict[str, float]]]]]:
    """Teacher-vs-student metric sweeps over many jobs at once.

    Each job is a dict with ``students`` (``{size_factor: model}``) and
    optionally ``guidance_scales`` (default ``(1.0, 3.0, 5.0)``),
    ``num_samples`` (3), ``base_seed`` (42), ``timesteps``
    (``config.timesteps``) and ``draws`` (a :class:`SweepDraws`; default
    drawn from ``base_seed``).  Teacher chains are cached across jobs per
    (T, scale, draws); student chains are freed once scored.  All metric
    scalars come to the host in one transfer at the end.

    Returns one ``{size_factor: {"teacher_metrics": {gs: {...}},
    "student_metrics": {gs: {...}}}}`` per job: per-sample scalar metrics
    averaged over samples, the same values under both keys in independent
    dicts.

    Under ``Config.mesh_shape`` (every rank calls this alike) a job whose
    ``num_samples`` the data axis divides runs this rank's rows of its
    draws; one all-gather before the means restores the sample axis in
    the unsharded order.  A job it does not divide runs unsharded, as in
    JAX.
    """
    mesh = mesh_from_config(config) if config is not None else None
    d = axis_size(mesh, DATA_AXIS)
    device = _entry_device(config, device)
    jobs = [dict(job) for job in jobs]
    for job in jobs:
        job.setdefault("guidance_scales", (1.0, 3.0, 5.0))
        job.setdefault("num_samples", 3)
        job.setdefault("base_seed", 42)
        job.setdefault("timesteps", config.timesteps)
        job.setdefault("draws", None)
    models = [teacher_model] + [m for job in jobs for m in job["students"].values()]
    for model in models:
        _check_model_device(model, device)

    t0 = time.perf_counter()
    draws_cache: Dict[tuple, SweepDraws] = {}
    fn_cache: Dict[tuple, object] = {}
    teacher_chain_cache: Dict[tuple, torch.Tensor] = {}

    def job_draws(job):
        if job["draws"] is not None:
            key = ("injected", id(job["draws"]))
            if key not in draws_cache:
                draws_cache[key] = job["draws"].to(device)
        else:
            key = (job["num_samples"], job["base_seed"], job["timesteps"])
            if key not in draws_cache:
                draws_cache[key] = _sweep_inputs(config, *key, device)
        return key, draws_cache[key]

    def fn_for(model, timesteps):
        key = (id(model), timesteps)
        if key not in fn_cache:
            fn_cache[key] = make_sweep_trajectory_fn(model, timesteps, config)
        return fn_cache[key]

    pending = []  # (job index, size factor, gs, {metric: [S] tensor}, sharded)
    for ji, job in enumerate(jobs):
        timesteps, s = job["timesteps"], job["num_samples"]
        dkey, draws = job_draws(job)
        seeds = np.arange(job["base_seed"], job["base_seed"] + s)
        sharded = d > 1 and s % d == 0
        if d > 1 and not sharded:
            print(f"[engine] num_samples={s} not divisible by data axis {d}; running unsharded")
        if sharded:
            dkey = ("rows", dkey)
            if dkey not in draws_cache:
                rows = lambda v, dim=0: None if v is None else shard_batch(v, mesh, dim)
                draws_cache[dkey] = SweepDraws(rows(draws.noises), rows(draws.step_noise, 1),
                                               rows(draws.uniforms))
            draws = draws_cache[dkey]
            seeds, s = shard_batch(seeds, mesh).numpy(), s // d
        for gs in job["guidance_scales"]:
            use_cfg = gs is not None and gs > 1.0
            pairs = CFG_COND_PAIRS if use_cfg else NOCFG_COND_PAIRS
            gs_host = float(1.0 if gs is None else gs)
            ck = (timesteps, use_cfg, gs_host, dkey)
            t_trajs = teacher_chain_cache.get(ck)
            if t_trajs is None:
                t_trajs = fn_for(teacher_model, timesteps)(
                    draws.noises, seeds, pairs, gs_host, step_noise=draws.step_noise
                )
                teacher_chain_cache[ck] = t_trajs
            for sf, model in job["students"].items():
                s_trajs = fn_for(model, timesteps)(
                    draws.noises, seeds, pairs, gs_host, step_noise=draws.step_noise
                )
                metrics = batch_metrics_core(t_trajs, s_trajs, draws.uniforms)
                # Scalar metrics only (shape [S]); per-step vectors are
                # dropped, as in the JAX sweep's output contract.
                scalars = {
                    k: v for k, v in metrics.items()
                    if v.ndim == 1 and v.shape[0] == s
                }
                pending.append((ji, sf, gs, scalars, sharded))

    # One all-gather restores the sharded jobs' samples (rank r holds rows
    # r·l … (r+1)·l of each vector), then one transfer brings every vector.
    vecs = [(v, sh) for *_, scalars, sh in pending for v in scalars.values()]
    local = [v for v, sh in vecs if sh]
    if local:
        every = gather_batch(torch.cat(local), mesh).view(d, -1)
        offsets = np.cumsum([0] + [v.numel() for v in local])
        full = iter(every[:, a:b].reshape(-1) for a, b in zip(offsets[:-1], offsets[1:]))
        vecs = [(next(full) if sh else v, sh) for v, sh in vecs]
    sizes = [v.numel() for v, _ in vecs]
    host = iter(np.split(torch.cat([v for v, _ in vecs]).cpu().numpy(), np.cumsum(sizes)[:-1])
                if vecs else ())
    outputs: List[dict] = [{sf: {} for sf in job["students"]} for job in jobs]
    for ji, sf, gs, scalars, _ in pending:
        outputs[ji][sf][gs] = {k: float(np.mean(next(host))) for k in scalars}
    results = [
        {
            sf: {
                "teacher_metrics": {gs: dict(m) for gs, m in per_gs.items()},
                "student_metrics": {gs: dict(m) for gs, m in per_gs.items()},
            }
            for sf, per_gs in out.items()
        }
        for out in outputs
    ]
    if verbose:
        n = sum(
            len(job["guidance_scales"]) * len(job["students"]) * job["num_samples"]
            for job in jobs
        )
        dt = time.perf_counter() - t0
        print(
            f"[sweep] generated+scored {n} trajectory pairs in {dt:.2f}s "
            f"({n / dt:.1f} pairs/s) on {device}"
        )
    return results


def sweep_compare_trajectories(
    teacher_model,
    students,
    config,
    guidance_scales: Sequence[float] = (1.0, 3.0, 5.0),
    num_samples: int = 3,
    base_seed: int = 42,
    draws: Optional[SweepDraws] = None,
    device=None,
    verbose: bool = True,
) -> Dict[float, Dict[str, Dict[float, Dict[str, float]]]]:
    """Single-job :func:`sweep_compare_trajectories_multi`; ``students`` is
    ``{size_factor: model}``."""
    return sweep_compare_trajectories_multi(
        teacher_model,
        [{
            "students": students,
            "guidance_scales": guidance_scales,
            "num_samples": num_samples,
            "base_seed": base_seed,
            "timesteps": config.timesteps,
            "draws": draws,
        }],
        config,
        device=device,
        verbose=verbose,
    )[0]


def compare_trajectories(
    teacher_model,
    student_model,
    config,
    guidance_scales: Sequence[float] = (1.0, 3.0, 5.0),
    size_factor: float = 1.0,
    num_samples: int = 3,
    base_seed: int = 42,
    draws: Optional[SweepDraws] = None,
    device=None,
) -> Dict[str, Dict[float, Dict[str, float]]]:
    """Compare one teacher/student pair across guidance scales: for each of
    ``num_samples`` noises (seed ``base_seed + i``) and each scale, paired
    trajectories from the same noise, scalar metrics averaged over samples.

    Returns ``{"teacher_metrics": {gs: {...}}, "student_metrics": {...}}``.
    """
    out = sweep_compare_trajectories(
        teacher_model,
        {size_factor: student_model},
        config,
        guidance_scales=guidance_scales,
        num_samples=num_samples,
        base_seed=base_seed,
        draws=draws,
        device=device,
        verbose=False,
    )
    return out[size_factor]
