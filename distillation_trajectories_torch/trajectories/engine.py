"""Trajectory generation and teacher/student comparison (port of
``trajectories/engine.py``).

A sweep runs one chain per (model, guidance scale) over all samples at once
(samples ride the U-Net's batch axis), with the teacher chains generated once
per (T, scale, draws) and shared by every student, and scores each pair
batch with the metric suite on the device.  The makers
(:func:`make_sweep_trajectory_fn`, :func:`make_batch_trajectory_fn`,
:func:`make_paired_trajectory_fn`) are the counterparts of JAX's jitted
ones: on the card each captures its chains into CUDA graphs and replays
them, a model's CFG and CFG-off graphs sharing one static set.  The sweep
keeps its makers across calls (:func:`sweep_compare_trajectories_multi`),
so a repeated sweep replays the graphs an earlier call captured.  The JAX
package's TPU host machinery (AOT compile pool, ``CompiledWithFallback``,
the watchdog) has no counterpart.

The random draws of a sweep — starting noises, per-step noise, the
Wasserstein subsample keys and, for a class-conditional teacher (the DiT of
``models/dit.py``), each sample's class label — form one
:class:`SweepDraws`, injectable as ``draws=`` so that a test can hand in
the JAX draws.

``Config.mesh_shape`` shards a sweep's sample axis over the mesh's data
axis (one process per rank): the draws are made for all samples on every
rank, each rank runs and scores its rows' chains, and the per-sample
metrics are gathered before the means, so every rank returns the
unsharded result.  ``Config.spatial_shape`` sends
:func:`generate_trajectory` through the spatially partitioned forward.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..diffusion.sampling import (
    CFG_COND_PAIRS,
    NOCFG_COND_PAIRS,
    draw_step_noise,
    generate_trajectory_scan,
    make_batch_chain_fn,
    sample_labels,
    seeded_normal,
)
from ..diffusion.schedules import get_diffusion_params
from ..metrics.trajectory_metrics import WASSERSTEIN_SAMPLE_SIZE, batch_metrics_core
from ..models.dit import require_unet
from ..parallel.mesh import DATA_AXIS, axis_size, gather_batch, mesh_from_config, shard_batch
from ..training.state import make_eval_fn_from_config
from ..utils.graphs import sampler_lane_captures
from ..utils.profiling import span


@dataclasses.dataclass
class SweepDraws:
    """The random inputs of one sweep job.

    ``noises``: ``[S, H, W, C]`` starting noise.
    ``step_noise``: ``[T-1, S, H, W, C]``; row ``j`` is step ``t = T-1-j``.
    ``uniforms``: ``[S, T+1, H·W·C]`` Wasserstein subsample keys, or None
    when a state has no more pixels than the subsample size.
    ``labels``: ``[S]`` int64 class labels of a class-conditional model's
    chains, or None for the U-Net.
    """

    noises: torch.Tensor
    step_noise: torch.Tensor
    uniforms: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None

    def to(self, device) -> "SweepDraws":
        return SweepDraws(
            *(None if v is None else torch.as_tensor(v).to(device)
              for v in (self.noises, self.step_noise, self.uniforms, self.labels))
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
    """``fn(noises [S,H,W,C], seeds [S], gs, step_noise=None, eager=False)
    -> trajs [S, T+1, H, W, C]`` for one model at a runtime guidance scale.

    Samples ride the U-Net's batch axis.  ``use_cfg`` selects the two CFG
    forwards (cond 0 and cond 1, both with mask 1) combined at ``gs``, or
    one cond-0 mask-0 forward.  The default step noise draws sample ``i``
    at step ``t`` from the generator of ``(seeds[i], t)``.  The chain is
    :func:`make_sweep_trajectory_fn`'s: captured on the card, one graph
    for every ``gs``, unless ``eager`` runs its body eagerly."""
    device = _entry_device(config, device)
    _check_model_device(model, device)
    sweep = make_sweep_trajectory_fn(model, timesteps, config)
    pairs = CFG_COND_PAIRS if use_cfg else NOCFG_COND_PAIRS

    def fn(noises, seeds, gs, step_noise=None, eager=False):
        noises = torch.as_tensor(noises, dtype=torch.float32).to(device)
        if step_noise is None:
            step_noise = draw_step_noise(seeds, timesteps, noises.shape[1:], device)
        return sweep(noises, seeds, pairs, float(gs) if use_cfg else 1.0,
                     step_noise=step_noise, eager=eager)

    fn.graphs = sweep.graphs
    return fn


def make_paired_trajectory_fn(teacher_model, student_model, timesteps: int, config=None,
                              use_cfg: bool = True, device=None):
    """``fn(noises [S,H,W,C], seeds [S], gs, step_noise=None, eager=False)
    -> (teacher_trajs, student_trajs)``, each ``[S, T+1, H, W, C]``.

    Both chains start from the same noises and take the same per-step
    noise (drawn once, by default paired in ``(seed, t)``), as the
    reference reseeds both chains alike.  Each model's chain is captured on
    the card (:func:`make_batch_trajectory_fn`) unless ``eager`` runs both
    eagerly."""
    teacher = make_batch_trajectory_fn(teacher_model, timesteps, config, use_cfg, device)
    student = make_batch_trajectory_fn(student_model, timesteps, config, use_cfg, device)
    device = _entry_device(config, device)

    def fn(noises, seeds, gs, step_noise=None, eager=False):
        noises = torch.as_tensor(noises, dtype=torch.float32).to(device)
        if step_noise is None:
            step_noise = draw_step_noise(seeds, timesteps, noises.shape[1:], device)
        return (teacher(noises, seeds, gs, step_noise=step_noise, eager=eager),
                student(noises, seeds, gs, step_noise=step_noise, eager=eager))

    fn.graphs = (teacher.graphs, student.graphs)
    return fn


def make_sweep_trajectory_fn(model, timesteps: int, config=None):
    """``fn(noises [S,H,W,C], seeds [S], cond_pairs [2,2], gs, step_noise=None,
    labels=None, eager=False) -> trajs [S, T+1, H, W, C]`` for one model;
    CFG or not is the runtime ``cond_pairs`` input, ``labels`` a DiT's
    ``[S]`` classes.

    The counterpart of JAX's jitted sweep function: on the card (unless the
    forward is spatially partitioned or the model sharded over a mesh,
    ``utils/graphs.py::sampler_lane_captures``) the first call of a draw
    shape runs eagerly, its warm-up, and each key — CFG on or off, the
    noises' shape and dtype — is captured into a CUDA graph on its next
    call and replayed from then on, the CFG and CFG-off graphs sharing
    their static inputs and output
    (:func:`..diffusion.sampling.make_batch_chain_fn`); ``gs`` is written
    into the graph's scalar table, so one graph serves every guidance
    scale.  A replay reads the model's weights where they are, so it sees
    them changed in place.  Each call returns fresh storage.  A call with
    ``eager=True`` runs the same body eagerly.

    A maker made here lives as long as its caller holds it.  The makers of
    :func:`sweep_compare_trajectories_multi` are resident instead: kept
    across its calls while their model lives and is as it was when they
    were built, bar the int8 ones, which fold the weights here."""
    alphas = get_diffusion_params(timesteps, config)["alphas"]
    model_fn = make_eval_fn_from_config(model, config)
    return make_batch_chain_fn(
        model_fn, timesteps, alphas, _store_dtype(config),
        captures=lambda device: sampler_lane_captures(device, model, config),
    )


# The Config fields a sweep maker reads when it is built: the schedule
# (get_diffusion_params), the forward (make_eval_fn_from_config), the store
# dtype and whether it captures (sampler_lane_captures).
_MAKER_FIELDS = ("noise_schedule", "beta_start", "beta_end", "compute_dtype", "sampler_quant",
                 "trajectory_store_dtype", "spatial_shape", "mesh_shape")


@dataclasses.dataclass
class _Resident:
    """A sweep maker: what it assumed of its model when built
    (:func:`_weights_stamp`), the maker, and whether the store keeps it
    across calls."""

    stamp: tuple
    fn: object
    kept: bool


# The sweep's resident makers: for each model (a weak key), the makers its
# latest sweep call used, by :func:`_maker_key`.
_RESIDENT: "weakref.WeakKeyDictionary[torch.nn.Module, Dict[tuple, _Resident]]" = (
    weakref.WeakKeyDictionary())


def _weights_stamp(model: torch.nn.Module) -> tuple:
    """Each parameter's and buffer's storage and in-place version, and each
    module's mode."""
    tensors = itertools.chain(model.parameters(), model.buffers())
    return (tuple((t.data_ptr(), t._version) for t in tensors),
            tuple(m.training for m in model.modules()))


def _maker_key(timesteps: int, config, device) -> tuple:
    """What a sweep maker is built from besides its model, and the TF32
    switches its graph's kernels were chosen under."""
    values = tuple(getattr(config, f, None) for f in _MAKER_FIELDS)
    return (int(timesteps), str(device),
            tuple(tuple(v) if isinstance(v, list) else v for v in values),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _resident_makers(wanted, config, device):
    """``({(id(model), T): _Resident}, makers built)`` for ``wanted``
    (``{(id(model), T): (model, T)}``): a resident maker whose model is as it
    was when the maker was built, else a new one.  Each model then keeps
    just the makers of this call.  A maker reaches its model through a weak
    proxy, so the store keeps no model alive.

    An int8 maker (``Config.sampler_quant="int8"``) folds the weights when
    it is built, so it is built every call and kept by none: a CUDA-graph
    replay, as the trainers' captured lanes run a step, changes weights in
    place without raising their ``_version``, and no stamp would see its
    fold go stale.  The other makers read the weights in place, and the
    store keeps them (``kept``)."""
    resident = getattr(config, "sampler_quant", "none") != "int8"
    makers, kept, built = {}, {}, 0
    for mkey, (model, timesteps) in wanted.items():
        key = _maker_key(timesteps, config, device)
        entry = _RESIDENT.get(model, {}).get(key) if resident else None
        if entry is None or entry.stamp != _weights_stamp(model):
            fn = make_sweep_trajectory_fn(weakref.proxy(model), timesteps, config)
            # Stamped after the build, which puts the model in eval mode.
            entry = _Resident(_weights_stamp(model), fn, resident)
            built += 1
        makers[mkey] = entry
        entries = kept.setdefault(model, {})
        if resident:
            entries[key] = entry
    for model, entries in kept.items():
        _RESIDENT[model] = entries
    return makers, built


def _sweep_inputs(config, num_samples: int, base_seed: int, timesteps: int,
                  num_classes: Optional[int], device) -> SweepDraws:
    """Default draws of a sweep job: sample ``i`` has seed ``base_seed+i``;
    its starting noise comes from the generator of ``(seed, 0)`` and its
    step-t noise from that of ``(seed, t)``; the Wasserstein keys from one
    generator seeded with ``base_seed``; with ``num_classes`` (a
    class-conditional teacher), its label from its seed
    (:func:`..diffusion.sampling.sample_labels`)."""
    seeds = [base_seed + i for i in range(num_samples)]
    shape = (config.image_size, config.image_size, config.channels)
    noises = seeded_normal([(s, 0) for s in seeds], shape, device)
    step_noise = draw_step_noise(seeds, timesteps, shape, device)
    d = int(np.prod(shape))
    uniforms = None
    if d > WASSERSTEIN_SAMPLE_SIZE:
        with span("draws", n=1):
            gen = torch.Generator(device=device).manual_seed(base_seed)
            uniforms = torch.rand(
                (num_samples, timesteps + 1, d), generator=gen, device=device
            )
    labels = None if num_classes is None else sample_labels(seeds, num_classes, device)
    return SweepDraws(noises, step_noise, uniforms, labels)


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

    The teacher and students are U-Nets, keyed by size factor, or DiTs
    (``models/dit.py``), keyed by any name (the variant's, say): a
    class-conditional family, whose chains take each sample's label as a
    further input of the captured chain (drawn from the sample's seed,
    :class:`SweepDraws`); the CFG pair is then null class against label.
    A sweep does not mix the two, and a DiT sweep takes no mesh.

    Returns one ``{size_factor: {"teacher_metrics": {gs: {...}},
    "student_metrics": {gs: {...}}}}`` per job: per-sample scalar metrics
    averaged over samples, the same values under both keys in independent
    dicts.

    Under ``Config.mesh_shape`` (every rank calls this alike) a job whose
    ``num_samples`` the data axis divides runs this rank's rows of its
    draws; one all-gather before the means restores the sample axis in
    the unsharded order.  A job it does not divide runs unsharded, as in
    JAX.

    Every chain runs through its model's maker (bar the int8 makers'
    CFG-off chains, below), each model's CFG chains
    (their scales in the jobs' order) before its CFG-off chain: on the
    card the first CFG chain warms the maker up, the second is captured,
    and the CFG-off chain is captured on its first run, on the static set
    the CFG graph holds.  Each returned dict lists the job's scales in its
    own order.  The chain makers are resident: kept across calls, one per
    model and T, so a later call with the same models, T, configuration
    and draw shapes replays the graphs an earlier call captured, with no
    warm-up and no capture.  A maker is built anew when its model has
    changed since: a parameter or buffer with other storage or an in-place change
    (``Tensor._version``: a write through ``.data`` is not counted), or a
    module put in training mode; or when a ``Config`` field the maker
    reads, or a TF32 switch, differs.  Under ``sampler_quant="int8"`` every
    call builds its makers, which fold the weights, and keeps none; their
    CFG-off chains run eagerly (``eager=True``), since a graph that the
    call's end drops would be captured for the one run.  The
    store holds each model weakly and keeps, per model, the makers of its
    latest call: dropping the models releases their graphs.  Until then
    their graphs stay allocated between calls, through whatever the caller
    runs next (a training epoch, say): each maker's static set holds its
    static noises, step noise and trajectories, 0.296 GiB for 256 samples
    of 32x32x3 at T=50 in float32, and the shared sampler pool stays
    reserved for them.

    A call is one ``sweep.call`` span (``jobs``, ``pairs``); inside it one
    ``sweep.makers`` span (``built`` and ``reused``: makers built and found
    resident), and each student chain's scoring a ``sweep.metrics`` span
    (``sf``, ``gs``).
    """
    jobs = [dict(job) for job in jobs]
    for job in jobs:
        job.setdefault("guidance_scales", (1.0, 3.0, 5.0))
        job.setdefault("num_samples", 3)
        job.setdefault("base_seed", 42)
        job.setdefault("timesteps", config.timesteps)
        job.setdefault("draws", None)
    n = sum(len(job["guidance_scales"]) * len(job["students"]) * job["num_samples"]
            for job in jobs)
    with span("sweep.call", jobs=len(jobs), pairs=n):
        return _sweep_multi(teacher_model, jobs, n, config, device, verbose)


def _sweep_multi(teacher_model, jobs, n, config, device, verbose):
    models = [teacher_model] + [m for job in jobs for m in job["students"].values()]
    num_classes = getattr(teacher_model, "num_classes", None)
    if any(getattr(m, "num_classes", None) != num_classes for m in models):
        raise ValueError("a sweep's teacher and students must all be U-Nets or all be "
                         "class-conditional DiTs of one label set")
    if config is not None and tuple(config.mesh_shape) != (1, 1):
        require_unet(teacher_model, "the sweep's mesh lane (Config.mesh_shape)")
    mesh = mesh_from_config(config) if config is not None else None
    d = axis_size(mesh, DATA_AXIS)
    device = _entry_device(config, device)
    for model in models:
        _check_model_device(model, device)

    t0 = time.perf_counter()
    draws_cache: Dict[tuple, SweepDraws] = {}

    def job_draws(job):
        if job["draws"] is not None:
            if (job["draws"].labels is None) != (num_classes is None):
                raise ValueError("a DiT sweep's draws carry labels, a U-Net sweep's none")
            key = ("injected", id(job["draws"]))
            if key not in draws_cache:
                draws_cache[key] = job["draws"].to(device)
        else:
            key = (job["num_samples"], job["base_seed"], job["timesteps"], num_classes)
            if key not in draws_cache:
                draws_cache[key] = _sweep_inputs(config, *key, device)
        return key, draws_cache[key]

    def job_rows(job):
        """``(draws key, draws, seeds, samples, sharded)``: this rank's rows."""
        s = job["num_samples"]
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
        return dkey, draws, seeds, s, sharded

    # The call's chains in the order they run: at each scale of a job the
    # teacher's (sf None; once per T, scale and draws, its trajectories
    # shared across jobs), then each student's; the CFG chains first, as
    # CapturedCall asks of a key called once (a model's CFG-off chain), so
    # that it is captured on its one call, on the static set the CFG graph
    # made.  A chain's maker is its model's at its T.
    rows = [job_rows(job) for job in jobs]
    plan, wanted, teachers = [], {}, set()
    for ji, (job, (dkey, *_)) in enumerate(zip(jobs, rows)):
        timesteps = job["timesteps"]
        for gs in job["guidance_scales"]:
            use_cfg = gs is not None and gs > 1.0
            tkey = (timesteps, use_cfg, float(1.0 if gs is None else gs), dkey)
            chains = list(job["students"].items())
            if tkey not in teachers:
                teachers.add(tkey)
                chains.insert(0, (None, teacher_model))
            for sf, model in chains:
                plan.append((ji, sf, gs, tkey, (id(model), timesteps)))
                wanted[plan[-1][-1]] = (model, timesteps)
    plan.sort(key=lambda chain: not chain[3][1])  # stable: CFG on, then off

    with span("sweep.makers") as record:
        makers, built = _resident_makers(wanted, config, device)
        if record is not None:
            record.attrs.update(built=built, reused=len(makers) - built)

    teacher_trajs: Dict[tuple, torch.Tensor] = {}
    pending = []  # (job index, size factor, gs, {metric: [S] tensor}, sharded)
    for ji, sf, gs, tkey, mkey in plan:
        _, draws, seeds, s, sharded = rows[ji]
        _, use_cfg, gs_host, _ = tkey
        # A U-Net's chain is called as it always was; a DiT's takes its labels.
        labels = {} if draws.labels is None else {"labels": draws.labels}
        entry = makers[mkey]
        trajs = entry.fn(
            draws.noises, seeds, CFG_COND_PAIRS if use_cfg else NOCFG_COND_PAIRS, gs_host,
            step_noise=draws.step_noise, eager=not (use_cfg or entry.kept), **labels)
        if sf is None:
            teacher_trajs[tkey] = trajs
            continue
        with span("sweep.metrics", sf=sf, gs=gs):
            metrics = batch_metrics_core(teacher_trajs[tkey], trajs, draws.uniforms)
        # Scalar metrics only (shape [S]); per-step vectors are dropped, as
        # in the JAX sweep's output contract.
        scalars = {k: v for k, v in metrics.items() if v.ndim == 1 and v.shape[0] == s}
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
    outputs: List[dict] = [{sf: dict.fromkeys(job["guidance_scales"]) for sf in job["students"]}
                           for job in jobs]
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
