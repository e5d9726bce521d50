#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its kernel
to its plain version.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, the Triton
package and ``nvidia-smi``.  The Triton kernel builds into ``build/triton/``
on first use.  Phases, each printing its own lines:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. the fused CFG-update kernel against its plain PyTorch version on the
   card: ``[256, 32, 32, 3]`` in float32 and bfloat16 and the odd
   ``(1, 7, 5, 1)`` shape, with errors, device times and the memory bound;
3. the sampler with the kernel tail (the kernel launched once a step, the
   plain version never called) against the plain tail on the card
   (float32, TF32 off, sf 0.1, T=10), and a small sweep on the card
   against the same sweep on the CPU;
4. the main path: ``sweep_compare_trajectories`` with the sf-1.0 teacher
   and students {0.1, 0.5} (seeded random weights), 32x32x3, 256 samples,
   T=50, guidance scales (1.0, 3.0), bf16 compute — with the kernel's
   launch count checked, the plain version checked unused, metrics checked
   finite, and traj/s, pairs/s and peak memory printed;
5. training: one teacher step and one distillation step on the card
   against the CPU (float32, TF32 off, sf 0.1, 16x16x1, batch 8, T=10,
   dropout 0, shared weights and draws); then ``train_teacher`` at full
   width (sf 1.0, the synthetic CIFAR-shaped set, batch 128, T=100, bf16,
   dropout 0.3, one epoch of 30 batches, a checkpoint and a 16-sample grid
   written to a temporary directory) and ``train_students`` for
   sf {0.1, 0.5} from that checkpoint, both through the trainers' default
   epoch lane (a captured CUDA graph replayed a batch) — with each epoch's
   seconds a step (capture included), images/s, checkpoint and grid
   times, peak memory, and a few per-batch teacher steps timed and
   profiled (forward, backward, optimizer) printed, the PNG writer that
   wrote the grids named (the raw grid where matplotlib does not import),
   and a failure when a loss is not finite or does not fall, no graph was
   captured, the checkpoint read back does not reproduce the trained
   model, or anything ran on the CPU;
6. analysis, on phase 5's checkpoints (teacher, students {0.1, 0.5}):
   (a) the InceptionV3 trunk (299x299, batch 2), its preprocessing,
   AlexNet-LPIPS (64x64, batch 8), the paired trajectory function (T=10)
   and the trajectory manager (4 pairs written, read back and scored) on
   the card against the CPU, in float32 with TF32 off; (b) the CFG-sweep
   CLI's ``run`` half with the full sweep's two jobs (``heatmaps``: 10
   guidance scales, 10 samples, T=100; ``trio``: T=50), the kernel's launch
   count checked and every transformed metric checked in [0, 1], with
   wall seconds, traj/s, peak memory and a profiled T=100 teacher chain;
   (c) the FID CLI's ``run`` half (50 samples per model, 100 sampling
   steps, InceptionV3 at 299x299 in batches of 32), FIDs checked finite
   and stamped ``seeded-random``, the comparison figures' PNG writer
   named, with sampling, feature and Fréchet seconds, images/s, peak
   memory and the device time of one batch-32 trunk forward against its
   FLOP bound.  Nothing here imports matplotlib;
7. the other analysis CLIs, on phase 5's checkpoints: (a) the
   noise-prediction compute half (teacher vs sf-0.5 student, 10 images),
   the sweep function's averaged chains at T=10, the consecutive-step
   distances and the effectiveness cosine / Euclid on the card against the
   CPU, in float32 with TF32 off; (b) the ``run`` halves of
   ``analyze_trajectories``, ``analyze_effectiveness``,
   ``analyze_dimensionality``, ``analyze_noise_prediction`` and
   ``analyze_time_dependent`` at the JAX CLIs' defaults with the size
   lists cut to {0.1, 0.5} (bf16), the kernel's launches checked against
   the count derived from each CLI's arguments, wall seconds, traj/s and
   peak memory printed, and the outputs checked (finite chains, distances
   and metrics, cosines in [-1, 1], variance ratios in [0, 1], the text
   and npz files written); (c) one batch-1 T=100 paired call timed and
   profiled.  Nothing here imports matplotlib either;
8. editing and progressive distillation: (a) the editing chain (engine
   mode, inpainting ``post_step``) and the plain, guided and
   ``teacher_guided`` progressive steps on the card against the CPU, in
   float32 with TF32 off; (b) the editing demo CLI's ``run`` half at its
   defaults on phase 5's teacher (T=50, 32 direction samples, bf16), its
   270 launches checked against the count its arguments give, its images,
   trajectories and directions checked, each stage's wall seconds printed;
   (c) ``progressive_distill`` from phase 5's teacher (batch 128,
   teacher_steps 100, bf16, dropout 0.3): two plain rounds (100 → 50 → 25)
   and one guided round (w ~ U[1, 5], 100 → 50) of 10 batches, with step
   times, images/s and peak memory per round and every checkpoint read
   back (phase 12 times the students' chains);
9. the sampler's opt-in lanes, migration and the orchestrator, on phase 5's
   checkpoints: (a) ``int8_matmul`` (``torch._int_mm``, zero-padded) on the
   card against the exact product, ``_qconv`` card vs CPU bit for bit and
   the int8 forward card vs CPU (float32, TF32 off: the teacher's int8
   weights, then its forward fed the CPU's codes at every site, held
   exactly up to rounding ties; free-running, near the float forward);
   then each Block conv's int8 time beside the bf16 cuDNN conv of the same
   layer (the arms' chains are phase 12(c)'s); (b) the teacher exported to
   a reference ``.pt`` and imported back through the CLI, read back equal;
   (c) ``run_full_sweep --skip-training`` as a subprocess (its CFG stage at
   2 of 10 guidance scales), each stage's seconds and ``ok`` from
   ``SWEEP_torch_chip.json``; (d) the engine's window dispatch
   (``Config.parallel_sampling="window"``, W=8, tol 0) through
   ``generate_trajectory`` on the teacher, B=1, float32 with TF32 off,
   within 1e-5 of the sequential chain and launching no kernel (the
   window sampler's grid is phase 12(b)'s);
10. the multi-device lanes, on two ranks spawned here that share the card
   (gloo; nothing here is a multi-GPU speed-up): (a) the data-sharded sweep
   on (2, 1) at the main path's width (256 samples, 128 a rank, T=50,
   bf16) with each rank's launches, traj/s and peak memory, after a T=10
   float32 hold against the unsharded sweep; (b) three teacher steps
   (sf 1.0, batch 128, T=100, dropout 0.3) on (2, 1) and on (1, 2) held in
   float32 to the unsharded steps (losses rtol 1e-4, parameters rtol 2e-2 /
   atol 5e-4), then timed in bf16; (c) the (1, 2) state written by both
   ranks with ``save_checkpoint_sharded`` and read back whole here; (d)
   ``train_students`` {0.1, 0.5} from phase 5's teacher, 10 batches,
   sequential and ``sweep_parallel``: losses held in float32, then both
   timed in bf16 with wall seconds and the device's idle share; (e) phase 5's teacher spatially partitioned on (1, 2): the
   32x32 forward (2e-5) and a T=50 CFG chain (2e-4) against the unsharded
   ones, and one 256x256 batch-1 bf16 forward's peak memory per rank;
11. the last entry points, on phase 5's outputs: (a) the sampler profiler's
   ``capture`` and ``summarize`` at the JAX script's defaults (sf 1.0, batch
   256, 32x32x3, T=50, guidance 3.0, bf16: one warm-up and three traced
   chains), its table's top 10 rows and the device's idle share printed,
   the kernel's 147 traced launches checked; (b) the seven-stage smoke
   suite on ``cuda``, 7/7; (c) ``run_on_cpu train_teacher`` at tiny flags:
   the child reports that CUDA sees no card and writes a checkpoint, and
   this process's device memory does not move; (d) ``analyze_latest_sample``
   on phase 5's grid, its structure score equal to numpy's on the pixels
   decoded with ``zlib``; (e) ``show_real_samples.run`` on the synthetic
   stand-in;
12. the bench entry points, each through its module's ``run`` at its
   defaults (full width: sf 1.0, 32x32x3, bf16), the kernel's launches
   checked against the count each bench's arguments give and its JSON
   record printed with the card's name and power limit: (a) ``bench`` (the
   main path's traj/s over 5 timed chains, the metric suite's pairs/s, the
   CPU baseline, the update tail it ran, ``use_pallas`` true, in its record
   and its ledger line in the workdir; then its chain timed again in
   turns with the step noise drawn inside and before each timed call, the
   mean and the best of each); (b) ``bench_r2`` ``pallas``
   (the kernel against the plain tail in turns, batch 256, T=50, bf16,
   each arm's seconds printed and the chains' deviation held under
   ``PALLAS_CHAIN_ATOL``), ``ablate`` (batch 256) and
   ``paradigms`` (B=1, windows {4, 8, 16} x tol {1e-3, 3e-3, 1e-2});
   (c) ``bench_quant --use_checkpoint`` on phase 5's teacher (the five
   arms, the int8 census); (d) ``bench_progressive --measure_only`` on
   phase 8(c)'s plain steps_25 and guided steps_50 students against phase
   5's teacher at T=100 (the guided one with a w-sweep of 1, 3, 5);
   (e) ``bench_fast --teacher_steps 100 --student_steps 50 --fid_samples 64``
   on the same teacher and guided student;
13. the trainers' default lanes: (a) the teacher's graph-replayed epoch
   lane against the eager per-batch loop from one seed (float32, TF32 off,
   cuDNN deterministic, sf 0.1, 16x16x1, batch 8, T=10, dropout 0.3, two
   epochs of 8 batches): the draw generator's end state equal, each step's
   loss at rtol 1e-5, the weights held as ``_hold_weights`` says; (b) the
   teacher at full width (sf 1.0, the synthetic CIFAR-shaped set, batch
   128, T=100, bf16, dropout 0.3, 30 batches), loop and graph in turns
   (loop, graph, graph, loop): each turn's epoch seconds, median
   synchronized step, the device's idle share and kernels a step over 4
   profiled steps, capture seconds and peak memory, after the dataset
   upload's bytes and seconds; (c) ``train_students`` {0.01, 0.05, 0.1}
   from phase 5's teacher, 10 batches, float32 with TF32 off: {0.01, 0.05}
   as one group step and 0.1 alone, held against ``vmap_students=False``
   (losses rtol 1e-5), with the group's epoch seconds against the two
   sequential ones.

The kernel record counts the launches of phases 4, 6(b), 7(b), 8(b), 9(d),
10 (the ranks' included), 11 and 12.  The last
lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU or when any
phase fails.
"""

import itertools
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
MAIN_SHAPE = (256, 32, 32, 3)
MAIN_T = 50
MAIN_GS = (1.0, 3.0)
STUDENTS = (0.1, 0.5)
SAMPLES = 256
TRAIN_BATCHES = 30
TRAIN_T = 100


def device_time_ms(fn, iters):
    """Device time of one ``fn()`` call: a sleep kernel holds the stream
    while the host enqueues every launch, so the events time the device
    alone, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, rtol, atol, card=None):
    diff = (got.float() - want.float()).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.float().abs().clamp_min(1e-30)).max())
    print(f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(rtol={rtol:g}, atol={atol:g})" + (f" [{card}]" if card else ""))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    return max_abs


def phase_kernel(card):
    from distillation_trajectories_torch.diffusion.sampling import _engine_scalars
    from distillation_trajectories_torch.diffusion.schedules import get_diffusion_params
    from distillation_trajectories_torch.ops.cfg_update import (
        cfg_engine_update,
        cfg_engine_update_reference,
    )

    alphas = get_diffusion_params(MAIN_T)["alphas"]
    scalars = (*_engine_scalars(alphas[25], alphas[24]), 3.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {}
    for label, shape, dtype, tol in (
        ("f32", MAIN_SHAPE, torch.float32, 1e-6),
        ("bf16", MAIN_SHAPE, torch.bfloat16, 1e-2),
        ("f32-odd", (1, 7, 5, 1), torch.float32, 1e-6),
    ):
        # Eight operand sets (126 MB in f32) cycled so each call finds its
        # inputs outside the 50 MB L2, as the sampler does.
        sets = [
            [torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4)]
            for _ in range(8)
        ]
        got = cfg_engine_update(*sets[0], *scalars)
        torch.cuda.synchronize()
        want = cfg_engine_update_reference(*sets[0], *scalars)
        max_abs = compare(f"kernel vs plain {label} {shape}", got, want, tol, tol)
        if label == "f32-odd":
            continue
        ring = itertools.cycle(sets)
        kernel_ms = device_time_ms(
            lambda: cfg_engine_update(*next(ring), *scalars), 100)
        plain_ms = device_time_ms(
            lambda: cfg_engine_update_reference(*next(ring), *scalars), 100)
        numel = int(np.prod(shape))
        bytes_moved = 5 * numel * torch.finfo(dtype).bits // 8
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = 8 * numel / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"cfg_engine_update {label} {shape}: kernel_ms={kernel_ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
              f"(bytes {bytes_moved} at 3.35 TB/s; bound by "
              f"{'bytes' if bytes_ms >= ops_ms else 'operations'}) "
              f"share_of_bound={bound_ms / kernel_ms:.3f} "
              f"library_ms=null (no single PyTorch call computes this "
              f"function; torch.lerp covers only the combine) [{card}]")
        if label == "f32":
            record = dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms,
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return record


class _PlainCalls:
    """Counts the calls of the kernel's plain version while in place (its
    wrapper looks it up at each call)."""

    def __enter__(self):
        from distillation_trajectories_torch.ops import cfg_update

        self.count, plain = 0, cfg_update.cfg_engine_update_reference

        def counted(*args):
            self.count += 1
            return plain(*args)

        self._patch = mock.patch.object(cfg_update, "cfg_engine_update_reference", counted)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def phase_sampler(card):
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import sampling
    from distillation_trajectories_torch.diffusion.schedules import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.ops.cfg_update import (
        cfg_engine_update,
        cfg_engine_update_reference,
    )
    from distillation_trajectories_torch.training import make_eval_model_fn
    from distillation_trajectories_torch.trajectories import sweep_compare_trajectories
    from distillation_trajectories_torch.trajectories.engine import _sweep_inputs

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("sampler check: float32 compute, torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    cfg = Config(timesteps=10, sample_steps=10, compute_dtype="float32")
    model_fn = make_eval_model_fn(make_unet(cfg, size_factor=0.1, seed=3))
    alphas = get_diffusion_params(10)["alphas"]
    seeds = list(range(8))
    noises = sampling.seeded_normal([(s, 0) for s in seeds], (32, 32, 3), "cuda")
    run = lambda: sampling.generate_trajectory_batch_scan(
        model_fn, noises, 10, alphas, seeds, sampling.CFG_COND_PAIRS, 3.0)
    before = cfg_engine_update.launches
    with _PlainCalls() as plain_calls:
        kernel_traj = run()
    made = cfg_engine_update.launches - before
    print(f"sampler kernel tail: {made} kernel launches a T=10 chain (expected 9), the plain "
          f"version called {plain_calls.count} times [{card}]")
    if made != 9 or plain_calls.count:
        raise RuntimeError("the sampler did not launch the kernel once a step, or the plain "
                           "version ran on the card")
    with mock.patch.object(sampling, "cfg_engine_update", cfg_engine_update_reference):
        plain_traj = run()
    compare("sampler kernel tail vs plain tail [8, 11, 32, 32, 3]",
            kernel_traj, plain_traj, 2e-5, 1e-5, card)

    # The small sweep of tests/test_torch_engine.py, on the card against the
    # CPU (which the CPU tests hold to the JAX package), on shared draws.
    kw = dict(image_size=16, channels=1, timesteps=10, sample_steps=10,
              compute_dtype="float32")
    results = {}
    draws = _sweep_inputs(Config(device="cpu", **kw), 4, 42, 10, "cpu")
    for device in ("cuda", "cpu"):
        dcfg = Config(device=device, **kw)
        teacher = make_unet(dcfg, size_factor=0.2, seed=0)
        student = make_unet(dcfg, size_factor=0.1, seed=1)
        results[device] = sweep_compare_trajectories(
            teacher, {0.1: student}, dcfg, guidance_scales=(1.0, 3.0),
            num_samples=4, draws=draws, verbose=False)[0.1]["teacher_metrics"]
    worst = 0.0
    for gs, metrics in results["cpu"].items():
        for k, want in metrics.items():
            got = results["cuda"][gs][k]
            if not (np.isnan(want) and np.isnan(got)):
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                                           err_msg=f"gs={gs} {k}")
                worst = max(worst, abs(got - want) / max(abs(want), 1e-30))
    print(f"small sweep card vs CPU (16x16x1, T=10, 4 samples, f32): every "
          f"scalar metric within rtol 1e-3 / atol 1e-5; max rel diff {worst:.3e}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _busy_and_window(kernels):
    """Device busy time and window of profiler events, in µs."""
    from distillation_trajectories_torch.utils.profiling import busy_and_window

    return busy_and_window((e.time_range.start, e.time_range.end) for e in kernels)


def profile_breakdown(run, chain_s, card, label="one teacher CFG chain"):
    """Device time of one ``run()`` by kernel kind (torch.profiler, CUPTI),
    the device's idle share between its first and last kernel with the
    profiler on, and the idle share that busy time implies for the
    unprofiled call of ``chain_s`` seconds.  Device activity only: the
    host operator events (about 150,000 for a T=100 CFG chain) would make
    the profiled run and the reading of its events several times slower."""
    from torch.profiler import ProfilerActivity, profile

    from distillation_trajectories_torch.utils.profiling import tally

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: torch.profiler recorded no device events: breakdown not measured")
        return
    busy, window = _busy_and_window(kernels)
    by_kind, by_name = tally((e.name, e.time_range.elapsed_us()) for e in kernels)
    total = sum(t for _, t in by_kind.values())
    print(f"profile ({label}, profiler on): {len(kernels)} kernels, "
          f"device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window, "
          f"idle share {1 - busy / window:.3f}; against the unprofiled "
          f"{chain_s * 1e3:.3f} ms call, idle share {1 - busy / 1e6 / chain_s:.3f} [{card}]")
    for kind, (n, t) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        print(f"  {kind}: {t / 1e3:.3f} ms ({t / total:.1%}) in {n} launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  top kernel {t / 1e3:.3f} ms x{n}: {name[:110]}")


def phase_main_path(card):
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion.sampling import CFG_COND_PAIRS
    from distillation_trajectories_torch.models import make_unet, param_count
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.trajectories import (
        make_sweep_trajectory_fn,
        sweep_compare_trajectories,
    )
    from distillation_trajectories_torch.trajectories.engine import _sweep_inputs

    cfg = Config(timesteps=MAIN_T, sample_steps=MAIN_T)  # 32x32x3, bf16, cuda
    teacher = make_unet(cfg, size_factor=1.0, seed=0)
    students = {sf: make_unet(cfg, size_factor=sf, seed=i + 1)
                for i, sf in enumerate(STUDENTS)}
    print(f"main path: teacher sf 1.0 ({param_count(teacher)} params), students "
          f"{list(STUDENTS)}, {SAMPLES} samples of 32x32x3, T={MAIN_T}, "
          f"guidance {list(MAIN_GS)}, compute {cfg.compute_dtype}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg_engine_update.launches = 0
    t0 = time.perf_counter()
    with _PlainCalls() as plain_calls:
        out = sweep_compare_trajectories(
            teacher, students, cfg, guidance_scales=MAIN_GS, num_samples=SAMPLES,
            base_seed=42, verbose=False)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cfg_engine_update.launches
    peak = torch.cuda.max_memory_allocated()
    chains = len(MAIN_GS) * (1 + len(STUDENTS))
    print(f"main path kernel launches: {launches} (expected {MAIN_T - 1} x "
          f"{chains} chains = {(MAIN_T - 1) * chains}), the plain version called "
          f"{plain_calls.count} times")
    if launches != (MAIN_T - 1) * chains or plain_calls.count:
        raise RuntimeError("the main path did not launch the kernel once per step, or the "
                           "plain version ran on the card")

    for sf, per_role in out.items():
        for gs, metrics in per_role["teacher_metrics"].items():
            bad = [k for k, v in metrics.items()
                   if not np.isfinite(v) and k != "trajectory_mse"]
            if bad or len(metrics) != 20:
                raise RuntimeError(f"sf={sf} gs={gs}: bad metrics {bad} of {len(metrics)}")
            print(f"sf={sf} gs={gs}: " + " ".join(
                f"{k}={metrics[k]:.6g}" for k in
                ("endpoint_distance", "trajectory_mse", "path_length_similarity",
                 "mean_directional_consistency", "mean_wasserstein")))

    pairs = len(MAIN_GS) * len(STUDENTS) * SAMPLES
    t0 = time.perf_counter()
    sweep_compare_trajectories(
        teacher, students, cfg, guidance_scales=MAIN_GS, num_samples=SAMPLES,
        base_seed=43, verbose=False)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0

    draws = _sweep_inputs(cfg, SAMPLES, 42, MAIN_T, "cuda")
    chain = make_sweep_trajectory_fn(teacher, MAIN_T, cfg)
    seeds = np.arange(42, 42 + SAMPLES)
    run = lambda: chain(draws.noises, seeds, CFG_COND_PAIRS, 3.0,
                        step_noise=draws.step_noise)
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        traj = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if tuple(traj.shape) != (SAMPLES, MAIN_T + 1, 32, 32, 3) or not torch.isfinite(traj).all():
        raise RuntimeError("teacher chain output is not finite or has the wrong shape")
    chain_s = min(times)
    print(f"teacher CFG chain (sf 1.0, gs 3.0, T={MAIN_T}, {SAMPLES} samples): "
          f"{SAMPLES / chain_s:.2f} traj/s, best of {[round(t, 4) for t in times]} s [{card}]")
    profile_breakdown(run, chain_s, card)
    print(f"sweep ({pairs} pairs: {len(STUDENTS)} students x {len(MAIN_GS)} scales x "
          f"{SAMPLES} samples, {chains} chains, draws and scoring included): "
          f"first call {first_s:.3f} s = {pairs / first_s:.2f} pairs/s; "
          f"second call {second_s:.3f} s = {pairs / second_s:.2f} pairs/s [{card}]")
    print(f"peak device memory (first sweep): {peak} bytes = {peak / 2**30:.3f} GiB [{card}]")
    return launches


def _close_grads(label, got_model, want_model):
    """Gradients at the CPU tests' tolerances: conv biases that feed a
    BatchNorm (true gradient zero) below 1e-6 in both, the rest rtol 1e-4
    with an atol of 5e-5 of the tensor's largest |g|."""
    want = dict(want_model.named_parameters())
    worst = 0.0
    for name, p in got_model.named_parameters():
        g, w = p.grad.cpu(), want[name].grad
        if name.endswith(("conv1.bias", "conv2.bias")):
            if not (g.abs().max() < 1e-6 and w.abs().max() < 1e-6):
                raise RuntimeError(f"{label}: gradient of {name} is not ~0")
            continue
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=max(1e-7, 5e-5 * scale), msg=name)
        worst = max(worst, float((g - w).abs().max()) / max(scale, 1e-30))
    return worst


def _close_batch_stats(label, got_model, want_model):
    want = want_model.state_dict()
    worst = 0.0
    for name, v in got_model.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(v.cpu(), want[name], rtol=1e-5, atol=1e-6, msg=name)
            worst = max(worst, float((v.cpu() - want[name]).abs().max()))
    return worst


def phase_train_check():
    """One teacher step and one distill step on the card against the CPU."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training.state import (
        TorchDraws,
        make_distill_train_step,
        make_teacher_train_step,
    )

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(device="cpu", image_size=16, channels=1, timesteps=10, sample_steps=10,
                 compute_dtype="float32", dropout=0.0)
    dp = get_diffusion_params(10)
    images = torch.rand((8, 16, 16, 1), generator=torch.Generator().manual_seed(0)) * 2 - 1
    source = TorchDraws(1, "cpu")
    cases = (
        ("teacher step", source.teacher_step(images, 10),
         lambda device: make_teacher_train_step(dp, 10)),
        ("distill step", source.distill_step(images, 10),
         lambda device: make_distill_train_step(
             make_unet(cfg, size_factor=0.2, device=device, seed=9), dp, 10, 5)),
    )
    for label, draws, make_step in cases:
        _hold_step_card_vs_cpu(label, cfg, images, draws, make_step)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _hold_step_card_vs_cpu(label, cfg, images, draws, make_step):
    """One train step of a seeded sf-0.1 student on the CPU and on the card
    from the same draws: the loss at rtol 1e-5, the gradients and the
    BatchNorm statistics at the CPU tests' tolerances."""
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training.state import StepDraws, create_train_state

    runs = {}
    for device in ("cpu", "cuda"):
        model = make_unet(cfg, size_factor=0.1, device=device, seed=0)
        moved = StepDraws(draws.t.to(device), tuple(n.to(device) for n in draws.noises),
                          w=None if draws.w is None else draws.w.to(device))
        _, loss = make_step(device)(create_train_state(model, cfg, draws=None),
                                    images.to(device), moved)
        runs[device] = (float(loss), model)
    (want, cpu_model), (got, card_model) = runs["cpu"], runs["cuda"]
    if not abs(got - want) <= 1e-5 * abs(want):
        raise RuntimeError(f"{label}: card loss {got!r} vs CPU {want!r}")
    grad_err = _close_grads(label, card_model, cpu_model)
    stats_err = _close_batch_stats(label, card_model, cpu_model)
    print(f"{label} card vs CPU (f32, TF32 off, sf 0.1, 16x16x1, batch 8, T=10): "
          f"loss {got:.7f} vs {want:.7f} (rtol 1e-5); gradients within rtol 1e-4 / "
          f"atol 5e-5 of each tensor's max, worst {grad_err:.3e} of it; batch_stats "
          f"within rtol 1e-5 / atol 1e-6, worst abs {stats_err:.3e}")


_TRAIN_KINDS = (  # first match wins
    ("optimizer (multi-tensor)", ("multi_tensor",)),
    ("upsample", ("upsample",)),
    ("max pool", ("max_pool",)),
    ("batch norm", ("batch_norm",)),
    ("dropout mask", ("bernoulli",)),
    ("concat", ("CatArray", "cat_")),
    ("random normal / randint", ("normal", "philox", "random")),
    ("reduction", ("reduce_kernel",)),
    ("copy / cast", ("copy",)),
    ("convolution", ("conv", "xmma", "implicit_gemm", "cudnn", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Functor")),
)


def _phase_of(event):
    """forward / backward / optimizer of a CPU op, by its ancestors."""
    while event is not None:
        if event.name.startswith("Optimizer.step"):
            return "optimizer"
        if event.name.startswith("autograd::engine::evaluate_function"):
            return "backward"
        event = event.cpu_parent
    return "forward"


def profile_train_steps(step, n_steps, step_s, card):
    """Device time of ``n_steps`` teacher steps by kernel kind and by phase
    (torch.profiler, CUPTI), and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from distillation_trajectories_torch.utils.profiling import kernel_kind, tally

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    events = prof.events()
    # Device rows of record_function ranges (Optimizer.step#Adam.step) span
    # kernels and gaps: they are not kernels.
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("train profile: torch.profiler recorded no device events: not measured")
        return
    busy, window = _busy_and_window(kernels)
    kind_of = lambda name: kernel_kind(name, _TRAIN_KINDS)
    by_kind, by_name = tally(((e.name, e.time_range.elapsed_us()) for e in kernels),
                             _TRAIN_KINDS)
    by_phase = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
            phase = _phase_of(e)
            for k in e.kernels:
                n, t = by_phase.get((phase, kind_of(k.name)), (0, 0.0))
                by_phase[(phase, kind_of(k.name))] = (n + 1, t + k.duration)
    total = sum(t for _, t in by_kind.values())
    print(f"train profile ({n_steps} teacher steps, sf 1.0, batch 128, bf16, profiler on): "
          f"{len(kernels)} kernels ({len(kernels) / n_steps:.0f} per step), device busy "
          f"{busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window, idle share "
          f"{1 - busy / window:.3f}; against {n_steps} unprofiled median steps "
          f"({n_steps * step_s * 1e3:.3f} ms) idle share {1 - busy / 1e6 / (n_steps * step_s):.3f} [{card}]")
    for kind, (n, t) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        print(f"  {kind}: {t / 1e3:.3f} ms ({t / total:.1%}) in {n} launches")
    if by_phase:
        for phase in ("forward", "backward", "optimizer"):
            rows = {k: v for (p, k), v in by_phase.items() if p == phase}
            t_phase = sum(t for _, t in rows.values())
            print(f"  {phase}: {t_phase / 1e3:.3f} ms ({t_phase / total:.1%}) in "
                  f"{sum(n for n, _ in rows.values())} launches: " + ", ".join(
                      f"{k} {t / 1e3:.3f} ms" for k, (n, t) in
                      sorted(rows.items(), key=lambda kv: -kv[1][1])[:6]))
    else:
        print("  forward / backward split: not measured (no kernels linked to CPU ops)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  top kernel {t / 1e3:.3f} ms x{n}: {name[:110]}")


class _TimedSteps:
    """Wraps a train-step factory so every step it makes is timed between
    device synchronizations, with its loss kept and its device checked."""

    def __init__(self, factory):
        self.factory, self.runs = factory, []

    def __call__(self, *args, **kwargs):
        step, record = self.factory(*args, **kwargs), []
        self.runs.append(record)

        def timed(state, images, draws=None):
            if images.device.type != "cuda" or next(state.model.parameters()).device.type != "cuda":
                raise RuntimeError("a train step ran off the card")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, images, draws)
            torch.cuda.synchronize()
            record.append((time.perf_counter() - t0, float(loss)))
            return state, loss

        return timed


def _step_summary(label, record, batch, card):
    times = [t for t, _ in record]
    losses = [l for _, l in record]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{label}: a loss is not finite: {losses}")
    med = statistics.median(times[3:])
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"{label}: {len(record)} steps, median step {med * 1e3:.3f} ms after 3 warm-up "
          f"steps (first step {times[0] * 1e3:.1f} ms), {batch / med:.1f} images/s; loss "
          f"{first:.5f} (mean of first 5) -> {last:.5f} (last 5) [{card}]")
    return med, first, last


class _TimedEpochs:
    """Wraps an epoch-lane factory so every epoch it runs is timed between
    device synchronizations, with its losses kept, its capture's seconds
    read and its device checked."""

    def __init__(self, factory):
        self.factory, self.runs = factory, []

    def __call__(self, *args, **kwargs):
        epoch_fn, record = self.factory(*args, **kwargs), []
        self.runs.append(record)

        def timed(state, dataset, idx):
            if dataset.device.type != "cuda" or next(state.model.parameters()).device.type != "cuda":
                raise RuntimeError("an epoch ran off the card")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses = epoch_fn(state, dataset, idx)
            torch.cuda.synchronize()
            captured = epoch_fn.captured[0]
            if not isinstance(captured.graph, torch.cuda.CUDAGraph):
                raise RuntimeError("the epoch lane captured no CUDA graph")
            record.append((time.perf_counter() - t0, losses.cpu().tolist(), captured.capture_s))
            return state, losses

        timed.captured = epoch_fn.captured
        return timed


def _epoch_summary(label, record, batch, card):
    """One epoch of the epoch lane: its wall seconds a step (the warm-up
    steps and the capture included), images/s and the loss's fall."""
    seconds, losses, capture_s = record[0]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{label}: a loss is not finite: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step = seconds / len(losses)
    print(f"{label}: epoch lane, {len(losses)} steps in {seconds:.3f} s ({step * 1e3:.3f} ms a "
          f"step, capture {capture_s:.3f} s and the warm-up steps included), "
          f"{batch / step:.1f} images/s; loss {first:.5f} (mean of first 5) -> {last:.5f} "
          f"(last 5) [{card}]")
    return step, first, last


def _png_writers(label, before, card):
    """Print which PNG writers wrote files since ``before`` (a copy of
    ``utils.viz.png_writes``); fail when none did."""
    from distillation_trajectories_torch.utils import viz

    made = {k: n - before.get(k, 0) for k, n in viz.png_writes.items() if n > before.get(k, 0)}
    if not made:
        raise RuntimeError(f"{label} wrote no PNG")
    print(f"{label} PNG writer: " + ", ".join(f"{k} x{n}" for k, n in made.items())
          + f" [{card}]")


def phase_train_main(card, workdir):
    """The training path at full width through the port's trainers."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import load_unet_variables, make_unet, param_count
    from distillation_trajectories_torch.training import students, teacher
    from distillation_trajectories_torch.training.checkpoints import (
        load_checkpoint,
        save_checkpoint,
        variables_from_checkpoint,
    )
    from distillation_trajectories_torch.training.state import TorchDraws
    from distillation_trajectories_torch.utils import viz

    png_before = dict(viz.png_writes)
    cfg = Config(base_dir=workdir, dataset="CIFAR10", epochs=1, timesteps=TRAIN_T,
                 sample_steps=TRAIN_T, limit_batches_per_epoch=TRAIN_BATCHES,
                 num_samples_to_generate=16, samples_grid_size=4).create_directories()
    print(f"training: teacher sf 1.0 on {cfg.dataset} shapes {cfg.image_size}x{cfg.image_size}x"
          f"{cfg.channels} (synthetic stand-in, no dataset files), batch {cfg.batch_size}, "
          f"T={cfg.timesteps}, compute {cfg.compute_dtype}, dropout {cfg.dropout}, lr {cfg.lr}, "
          f"1 epoch of {TRAIN_BATCHES} batches; seeded random init")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = _TimedEpochs(teacher.make_teacher_epoch_fn)
    t0 = time.perf_counter()
    with mock.patch.object(teacher, "make_teacher_epoch_fn", timed):
        state = teacher.train_teacher(cfg, seed=0)
    torch.cuda.synchronize()
    teacher_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model = state.model
    if any(t.device.type != "cuda" for t in model.state_dict().values()):
        raise RuntimeError("the trained teacher is not on the card")
    _, first, last = _epoch_summary(
        f"train_teacher (sf 1.0, {param_count(model)} params)", timed.runs[0],
        cfg.batch_size, card)
    if not last < first:
        raise RuntimeError(f"teacher loss did not fall: {first} -> {last}")
    ckpt = os.path.join(cfg.teacher_models_dir, "model_epoch_1.msgpack")
    grid = os.path.join(cfg.results_dir, "samples_epoch_1.png")
    if not (os.path.getsize(ckpt) > 0 and os.path.getsize(grid) > 0):
        raise RuntimeError("the teacher wrote no checkpoint or no grid")
    print(f"train_teacher: {teacher_s:.3f} s in all (dataset, {TRAIN_BATCHES} steps, async "
          f"checkpoint, grid); peak device memory {peak} bytes = {peak / 2**30:.3f} GiB [{card}]")

    # The checkpoint, read back, is the trained model.
    restored = make_unet(cfg, size_factor=1.0)
    load_unet_variables(restored, variables_from_checkpoint(load_checkpoint(cfg.teacher_models_dir, 1)))
    trained = model.state_dict()
    for k, v in restored.state_dict().items():
        if not k.endswith("num_batches_tracked") and not torch.equal(v, trained[k]):
            raise RuntimeError(f"checkpoint entry {k} differs from the trained model")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 32, 32, 3), device="cuda", generator=gen)
    t = torch.arange(8, device="cuda") * 12
    c = (torch.arange(8, device="cuda") % 2).float()[:, None]
    with torch.no_grad():
        want = model.eval()(x, t, c, torch.ones_like(c))
        got = restored.eval()(x, t, c, torch.ones_like(c))
    diff = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and diff == 0.0):
        raise RuntimeError(f"the checkpoint's eval forward differs from the trained model's: {diff}")
    print("checkpoint read back: every weight and statistic equal, eval forward max abs diff "
          f"{diff} (bf16 compute, 8 images)")

    # Checkpoint write and grid, timed alone.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(workdir, "timed"), 1, model, state.optimizer)
    ckpt_s = time.perf_counter() - t0
    grid_fn = teacher.make_grid_fn(model, cfg, get_diffusion_params(cfg.timesteps, cfg))
    noise, step_noise = TorchDraws(1, "cuda").sample(grid_fn.shape, grid_fn.n_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = grid_fn(noise, step_noise)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    if samples.shape != (16, 32, 32, 3):
        raise RuntimeError(f"grid samples have shape {tuple(samples.shape)}")
    print(f"checkpoint write (params + batch stats + Adam, {os.path.getsize(ckpt)} bytes, "
          f"fetch + encode + write): {ckpt_s:.3f} s; 16-sample grid (p_sample_loop, "
          f"T={TRAIN_T}, 2 forwards per step): {grid_s:.3f} s [{card}]")

    # A few more teacher steps of the per-batch lane, timed, then profiled
    # (phase 13 profiles the graph-replayed lane beside it).
    step = teacher.make_teacher_train_step(get_diffusion_params(cfg.timesteps, cfg),
                                           cfg.timesteps)
    images = torch.rand((cfg.batch_size, 32, 32, 3), device="cuda", generator=gen) * 2 - 1
    record = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = step(state, images)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t0, float(loss)))
    med, _, _ = _step_summary("teacher per-batch step (sf 1.0, the same state)", record,
                              cfg.batch_size, card)
    profile_train_steps(lambda: step(state, images), 4, med, card)

    # Students from the teacher's checkpoint.
    distill = _TimedEpochs(students.make_distill_epoch_fn)
    t0 = time.perf_counter()
    with mock.patch.object(students, "make_distill_epoch_fn", distill):
        trained_students = students.train_students(cfg, custom_size_factors=list(STUDENTS), seed=0)
    torch.cuda.synchronize()
    students_s = time.perf_counter() - t0
    for sf, record in zip(STUDENTS, distill.runs):
        student = trained_students[sf]
        if next(student.parameters()).device.type != "cuda":
            raise RuntimeError(f"student {sf} is not on the card")
        _epoch_summary(f"distill sf {sf} ({param_count(student)} params)", record,
                       cfg.batch_size, card)
        for name in (os.path.join(cfg.student_dir(sf), "model_epoch_1.msgpack"),
                     os.path.join(cfg.results_dir, f"student_samples_size_{sf}_epoch_1.png")):
            if not os.path.getsize(name) > 0:
                raise RuntimeError(f"missing {name}")
    print(f"train_students {list(STUDENTS)}: {students_s:.3f} s in all [{card}]")
    _png_writers("training (the teacher's grid and the students')", png_before, card)


TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores (dense)
SWEEP_JOBS = (  # the two jobs of the full sweep's CFG stage, cut to the trained sizes
    {"output_dir": "analysis/heatmaps", "size_factors": "0.1,0.5"},
    {"size_factors": "0.1,0.5", "timesteps": 50, "output_dir": "analysis/trio"},
)
FID_SIZES = "0.1,0.5"


def _tf32_off():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return saved


def phase_analysis_check(card, workdir):
    """Phase 6(a): the analysis modules on the card against the CPU."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion.sampling import draw_step_noise, seeded_normal
    from distillation_trajectories_torch.metrics.lpips import create_lpips
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.models.inception import (
        create_inception,
        preprocess_for_inception,
    )
    from distillation_trajectories_torch.trajectories import (
        TrajectoryManager,
        make_paired_trajectory_fn,
    )

    saved = _tf32_off()
    gen = torch.Generator().manual_seed(0)
    images = torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
    pre = preprocess_for_inception(images)
    compare("preprocess_for_inception card vs CPU ([2,32,32,3] -> [2,299,299,3])",
            preprocess_for_inception(images.cuda()).cpu(), pre, 0, 1e-5, card)
    feats = {}
    for device in ("cpu", "cuda"):
        model, pretrained = create_inception(device=device)
        with torch.no_grad():
            feats[device] = model(pre.to(device)).cpu()
    scale = float(feats["cpu"].abs().max())
    err = float((feats["cuda"] - feats["cpu"]).abs().max()) / scale
    print(f"InceptionV3 trunk card vs CPU (299x299, batch 2, f32, TF32 off, "
          f"{'pretrained' if pretrained else 'seeded'} weights): max abs err "
          f"{err * scale:.3e} = {err:.3e} of the largest feature {scale:.4f} "
          f"(tolerance 1e-4 of it) [{card}]")
    if not (torch.isfinite(feats["cuda"]).all() and err <= 1e-4):
        raise RuntimeError("the Inception trunk on the card disagrees with the CPU")

    x, y = (torch.rand((8, 64, 64, 3), generator=gen) * 2 - 1 for _ in range(2))
    dist = {}
    for device in ("cpu", "cuda"):
        scorer, _ = create_lpips(device=device)
        with torch.no_grad():
            dist[device] = scorer(x.to(device), y.to(device)).cpu()
    compare("LPIPSAlex card vs CPU (seeded weights, 64x64, batch 8)", dist["cuda"], dist["cpu"],
            1e-4, 0, card)

    kw = dict(image_size=16, channels=1, timesteps=10, sample_steps=10, compute_dtype="float32")
    seeds = [0, 1, 2, 3]
    noises = seeded_normal([(s, 0) for s in seeds], (16, 16, 1), "cpu")
    step_noise = draw_step_noise(seeds, 10, (16, 16, 1), "cpu")
    trajs, models = {}, {}
    for device in ("cpu", "cuda"):
        cfg = Config(device=device, **kw)
        models[device] = (make_unet(cfg, size_factor=0.2, seed=0),
                          make_unet(cfg, size_factor=0.1, seed=1))
        fn = make_paired_trajectory_fn(*models[device], 10, cfg)
        trajs[device] = [t.cpu() for t in fn(noises, seeds, 3.0, step_noise=step_noise)]
    for role, got, want in zip(("teacher", "student"), trajs["cuda"], trajs["cpu"]):
        compare(f"make_paired_trajectory_fn {role} card vs CPU (sf 0.2/0.1, 16x16x1, T=10, "
                f"4 samples, gs 3.0, f32, TF32 off)", got, want, 1e-4, 1e-4, card)

    cfg = Config(device="cuda", base_dir=os.path.join(workdir, "manager"), **kw)
    manager = TrajectoryManager(*models["cuda"], cfg, size_factor=0.1)
    paths = manager.generate_and_save_trajectories(4)
    pairs = manager.load_trajectories()
    if len(paths) != 4 or len(pairs) != 4 or any(
            t.dtype != np.float32 or t.shape != (11, 16, 16, 1) or not np.isfinite(t).all()
            for pair in pairs for t in pair):
        raise RuntimeError("the trajectory manager did not write 4 finite float32 pairs")
    on_card = manager.compute_trajectory_metrics_batch()
    on_cpu = TrajectoryManager(None, None, cfg, size_factor=0.1,
                               device="cpu").compute_trajectory_metrics_batch()
    averages = [k for k in on_cpu if k.endswith("_avg")]
    for k in averages:
        np.testing.assert_allclose(on_card[k], on_cpu[k], rtol=1e-4, atol=1e-6, err_msg=k)
    print(f"TrajectoryManager on the card: 4 pairs written and read back "
          f"({', '.join(os.path.basename(p) for p in paths[:2])}, ...); its {len(averages)} "
          f"averaged metrics equal the CPU's scoring of the same files within rtol 1e-4 "
          f"[{card}]")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_analysis_sweep(card, workdir):
    """Phase 6(b): the CFG-sweep CLI's ``run`` half at full width on the
    checkpoints phase 5 wrote."""
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.scripts import analyze_trajectory_metrics as cli
    from distillation_trajectories_torch.scripts._common import load_teacher_from_arg
    from distillation_trajectories_torch.trajectories import make_sweep_trajectory_fn
    from distillation_trajectories_torch.trajectories.engine import _sweep_inputs

    args = cli.parse_args(["--base_dir", workdir, "--jobs", json.dumps(SWEEP_JOBS),
                           "--device", "cuda"])
    config = cli.make_config(args)
    specs = cli.job_specs(args, config)
    teacher_chains = {(s["timesteps"], gs) for s in specs for gs in s["guidance_scales"]}
    student_chains = [(s["timesteps"], gs) for s in specs for gs in s["guidance_scales"]
                      for _ in s["size_factors"]]
    expected = sum(t - 1 for t, _ in teacher_chains) + sum(t - 1 for t, _ in student_chains)
    chains = len(teacher_chains) + len(student_chains)
    trajectories = sum(s["num_samples"] * len(s["guidance_scales"]) * (1 + len(s["size_factors"]))
                       for s in specs)
    shown = [(os.path.basename(s["output_dir"]), s["size_factors"], len(s["guidance_scales"]),
              s["num_samples"], s["timesteps"]) for s in specs]
    print(f"CFG-sweep CLI: jobs (name, sizes, scales, samples, T) {shown}, scales "
          f"{specs[0]['guidance_scales']}, compute {config.compute_dtype}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg_engine_update.launches = 0
    t0 = time.perf_counter()
    results = cli.run(args, config, specs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cfg_engine_update.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"CFG-sweep CLI kernel launches: {launches} (expected {expected}: T-1 per chain over "
          f"{len(teacher_chains)} teacher chains, each (T, scale) once, and "
          f"{len(student_chains)} student chains) [{card}]")
    if launches != expected:
        raise RuntimeError("the CFG-sweep CLI did not launch the kernel once per step")

    for spec, metrics_by_size in zip(specs, results):
        if sorted(metrics_by_size) != sorted(spec["size_factors"]):
            raise RuntimeError(f"job {spec['output_dir']} lacks sizes: {sorted(metrics_by_size)}")
        for key, _ in cli.METRICS_TO_ANALYZE:
            m = cli.transformed_matrix(metrics_by_size, spec["guidance_scales"], key)
            defined = m[~np.isnan(m)] if key == "trajectory_mse" else m
            if not (np.isfinite(defined).all() and ((defined >= 0) & (defined <= 1)).all()):
                raise RuntimeError(f"{spec['output_dir']} {key}: transformed values {m}")
            print(f"  {os.path.basename(spec['output_dir'])} {key}: {m.shape} in "
                  f"[{np.nanmin(m) if defined.size else float('nan'):.4f}, "
                  f"{np.nanmax(m) if defined.size else float('nan'):.4f}], "
                  f"{int(np.isnan(m).sum())} NaN [{card}]")
    print(f"CFG-sweep CLI run (checkpoint loading, draws, {chains} chains, scoring): "
          f"{wall:.3f} s, {trajectories} trajectories = {trajectories / wall:.2f} traj/s at "
          f"batch {specs[0]['num_samples']}; peak device memory {peak} bytes = "
          f"{peak / 2**30:.3f} GiB [{card}]")

    teacher = load_teacher_from_arg(config)
    chain = make_sweep_trajectory_fn(teacher, 100, config)
    draws = _sweep_inputs(config, 10, 42, 100, "cuda")
    from distillation_trajectories_torch.diffusion.sampling import CFG_COND_PAIRS

    run = lambda: chain(draws.noises, np.arange(42, 52), CFG_COND_PAIRS, 3.0,
                        step_noise=draws.step_noise)
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"CLI teacher chain (sf 1.0, T=100, batch 10, gs 3.0): best of "
          f"{[round(t, 4) for t in times]} s = {10 / min(times):.2f} traj/s [{card}]")
    profile_breakdown(run, min(times), card, label="one CLI teacher chain, T=100, batch 10")
    return launches


def phase_analysis_fid(card, workdir):
    """Phase 6(c): the FID CLI's ``run`` half at full width."""
    from distillation_trajectories_torch.metrics.fid import (
        InceptionModel,
        default_draw,
        generate_samples,
    )
    from distillation_trajectories_torch.models.inception import preprocess_for_inception
    from distillation_trajectories_torch.scripts import analyze_fid
    from distillation_trajectories_torch.scripts._common import load_student, load_teacher_from_arg
    from distillation_trajectories_torch.utils import viz
    from distillation_trajectories_torch.utils.profiling import conv_flops

    png_before = dict(viz.png_writes)
    args = analyze_fid.parse_args(["--base_dir", workdir, "--size_factors", FID_SIZES,
                                   "--device", "cuda"])
    config = analyze_fid.make_config(args)
    t0 = time.perf_counter()
    inception = InceptionModel(device="cuda")
    build_s = time.perf_counter() - t0
    print(f"FID: teacher + students {FID_SIZES}, {args.num_samples} samples each of "
          f"{config.image_size}x{config.image_size}x{config.channels}, p_sample_loop over "
          f"sample_steps={config.sample_steps}, InceptionV3 at 299x299 in batches of "
          f"{inception.batch_size}, f32 (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}), "
          f"features {'pretrained' if inception.pretrained else 'seeded-random'}; "
          f"featurizer built in {build_s:.3f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    fid_by_size = analyze_fid.run(args, config, inception=inception, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(config.fid_dir, "fid_summary.json")) as f:
        summary = json.load(f)
    wanted = sorted(float(s) for s in FID_SIZES.split(","))
    if (sorted(fid_by_size) != wanted
            or not all(np.isfinite(v) and v >= 0 for v in fid_by_size.values())
            or summary["features"] != "seeded-random"
            or summary["imagenet_fid_comparable"] is not False):
        raise RuntimeError(f"FID run: {fid_by_size}, summary {summary}")
    images = (1 + len(fid_by_size)) * args.num_samples
    print("FID " + ", ".join(f"sf {sf}: {v:.6f}" for sf, v in sorted(fid_by_size.items()))
          + f" (fid_summary.json features={summary['features']}) [{card}]")
    _png_writers("FID (the sample comparison figures)", png_before, card)
    print(f"FID run {wall:.3f} s (checkpoint loading included): sampling "
          f"{timings['sampling_s']:.3f} s ({timings['samplers']} samplers), features "
          f"{timings['features_s']:.3f} s ({images} images = "
          f"{images / timings['features_s']:.1f} images/s, preprocessing included), "
          f"transfer {timings['transfer_s']:.4f} s, Frechet math {timings['frechet_s']:.4f} s, "
          f"artifacts {timings['artifacts_s']:.4f} s; peak device memory {peak} bytes = "
          f"{peak / 2**30:.3f} GiB [{card}]")

    # The run's samples again (the default draws: teacher stream 1, the
    # students' shared stream 2), for their range and a warm feature pass.
    teacher = load_teacher_from_arg(config)
    sets = {"teacher": generate_samples(teacher, config, args.num_samples,
                                        default_draw(config, args.num_samples, 0, 1, "cuda"))}
    for sf in wanted:
        sets[f"sf {sf}"] = generate_samples(
            load_student(config, sf), config, args.num_samples,
            default_draw(config, args.num_samples, 0, 2, "cuda"))
    print("FID samples (range, std): " + ", ".join(
        f"{k} [{float(v.min()):.4g}, {float(v.max()):.4g}] std {float(v.std()):.4g}"
        for k, v in sets.items()) + f" [{card}]")
    every = torch.cat(list(sets.values()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inception.features_device(every)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"features again, warm ({every.shape[0]} images, preprocessing included): "
          f"{warm_s:.4f} s = {every.shape[0] / warm_s:.1f} images/s [{card}]")

    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = preprocess_for_inception(
        torch.rand((inception.batch_size, 32, 32, 3), device="cuda", generator=gen) * 2 - 1)
    flops = conv_flops(inception.model, batch)
    with torch.no_grad():
        # Three forwards (~1,000 launches) stay inside the sleep kernel's
        # hold on the stream, so the events time the device, not the host.
        ms = device_time_ms(lambda: inception.model(batch), 3)
        forward_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inception.model(batch)
            torch.cuda.synchronize()
            forward_s.append(time.perf_counter() - t0)
        profile_breakdown(lambda: inception.model(batch), min(forward_s), card,
                          label=f"one batch-{inception.batch_size} InceptionV3 forward")
    tf32 = torch.backends.cudnn.allow_tf32
    rate = TF32_FLOPS_PER_S if tf32 else F32_FLOPS_PER_S
    bound_ms = flops / rate * 1e3
    print(f"InceptionV3 trunk, one batch-{inception.batch_size} forward at 299x299: device "
          f"{ms:.4f} ms = {inception.batch_size / ms * 1e3:.1f} images/s (host-timed best of "
          f"{[round(t * 1e3, 3) for t in forward_s]} ms); convolutions "
          f"{flops / 1e9:.2f} GFLOP ({flops / inception.batch_size / 1e9:.3f} per image), "
          f"bound {bound_ms:.4f} ms at {rate / 1e12:.0f} TFLOP/s "
          f"({'TF32' if tf32 else 'f32'}), share of bound {bound_ms / ms:.3f} [{card}]")


def phase_analysis(card, workdir):
    t0 = time.perf_counter()
    phase_analysis_check(card, workdir)
    print(f"phase analysis (a) card vs CPU: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    launches = phase_analysis_sweep(card, workdir)
    print(f"phase analysis (b) CFG-sweep CLI: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    phase_analysis_fid(card, workdir)
    print(f"phase analysis (c) FID: {time.perf_counter() - t0:.1f} s [{card}]")
    if "matplotlib" in sys.modules:
        raise RuntimeError("the analysis path imported matplotlib")
    return launches


CLI_SIZES = "0.1,0.5"  # phase 5's students: the analysis CLIs' size lists, cut


def phase_cli_check(card, workdir):
    """Phase 7(a): the analysis CLIs' device pieces on the card against the
    CPU, in float32 with TF32 off, on phase 5's teacher and sf-0.5 student
    with shared images and draws."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.analysis.noise_prediction import noise_prediction_metrics
    from distillation_trajectories_torch.data import get_real_images
    from distillation_trajectories_torch.diffusion.sampling import (
        CFG_COND_PAIRS,
        draw_step_noise,
        seeded_normal,
    )
    from distillation_trajectories_torch.metrics.time_dependent import consecutive_distances
    from distillation_trajectories_torch.scripts._common import load_student, load_teacher_from_arg
    from distillation_trajectories_torch.scripts.analyze_effectiveness import _pair_metrics
    from distillation_trajectories_torch.trajectories import make_sweep_trajectory_fn

    saved = _tf32_off()
    cfgs = {d: Config(base_dir=workdir, device=d, compute_dtype="float32") for d in ("cpu", "cuda")}
    models = {d: (load_teacher_from_arg(c), load_student(c, 0.5)) for d, c in cfgs.items()}
    images = get_real_images(cfgs["cpu"], 10)
    gen = torch.Generator().manual_seed(7)
    noise = torch.randn((10, *images.shape), generator=gen)
    metrics = {d: noise_prediction_metrics(*models[d], cfgs[d], images=images, noise=noise)[0]
               for d in cfgs}
    worst = 0.0
    for t, want in metrics["cpu"]["metrics_by_timestep"].items():
        for k, w in want.items():
            got = metrics["cuda"]["metrics_by_timestep"][t][k]
            np.testing.assert_allclose(got, w, rtol=1e-4, err_msg=f"noise prediction t={t} {k}")
            worst = max(worst, abs(got - w) / max(abs(w), 1e-30))
    print(f"noise prediction card vs CPU (sf 1.0 vs sf 0.5, 10 images 32x32x3, 10 timesteps of "
          f"T={cfgs['cpu'].timesteps}, f32, TF32 off): every MSE / MAE / cosine within rtol "
          f"1e-4, max rel diff {worst:.3e} [{card}]")

    seeds = list(range(5))
    noises = seeded_normal([(s, 0) for s in seeds], (32, 32, 3), "cpu")
    step_noise = draw_step_noise(seeds, 10, (32, 32, 3), "cpu")
    chains = {}
    for d, cfg in cfgs.items():
        chains[d] = [make_sweep_trajectory_fn(m, 10, cfg)(
            noises.to(d), seeds, CFG_COND_PAIRS, 3.0, step_noise=step_noise.to(d)).cpu()
            for m in models[d]]
    for role, got, want in zip(("teacher", "student"), chains["cuda"], chains["cpu"]):
        compare(f"sweep fn {role} chains averaged over 5 samples card vs CPU (T=10, gs 3.0, "
                f"f32, TF32 off)", got.mean(0), want.mean(0), 2e-5, 1e-5, card)
    t_cpu, s_cpu = chains["cpu"]
    compare("consecutive_distances card vs CPU (teacher [5, 11, 32, 32, 3] chains)",
            consecutive_distances(t_cpu, "cuda").cpu(), consecutive_distances(t_cpu, "cpu"),
            1e-5, 0, card)
    compare("effectiveness cosine / Euclid card vs CPU (same chains)",
            _pair_metrics(t_cpu.cuda(), s_cpu.cuda()).cpu(), _pair_metrics(t_cpu, s_cpu),
            1e-5, 0, card)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _chain_plan(name, args, config):
    """``(chains, batch, steps)`` that a CLI's ``run`` samples, from its
    arguments and the config it builds; each chain launches the kernel
    ``steps - 1`` times."""
    from distillation_trajectories_torch.scripts._common import parse_float_list

    if name == "analyze_trajectories":  # per scale, a teacher and a student chain
        return 2 * len(parse_float_list(args.guidance_scales)), args.num_samples, config.timesteps
    if name == "analyze_noise_prediction":  # forwards only
        return 0, 0, 0
    sizes = len(parse_float_list(args.size_factors))
    if name == "analyze_effectiveness":  # a teacher chain per scale, shared by the sizes
        scales = len(parse_float_list(args.guidance_scales))
        return scales * (1 + sizes), args.num_samples, config.timesteps
    if name == "analyze_dimensionality":  # a batch-1 pair per sample, on teacher_steps
        return 2 * sizes * args.num_samples, 1, config.teacher_steps
    return 2 * sizes, args.num_samples, config.teacher_steps  # one batch of pairs per size


def _cli_runs(workdir):
    """The five ``run`` halves at the JAX CLIs' defaults, the size lists cut
    to phase 5's students: ``(name, module, args, config, expected
    launches, trajectories, steps)``."""
    from distillation_trajectories_torch.scripts import (
        analyze_dimensionality,
        analyze_effectiveness,
        analyze_noise_prediction,
        analyze_time_dependent,
        analyze_trajectories,
    )

    base = ["--base_dir", workdir, "--device", "cuda"]
    sizes = ["--size_factors", CLI_SIZES]
    runs = []
    for cli, extra in ((analyze_trajectories, []), (analyze_effectiveness, sizes),
                       (analyze_dimensionality, sizes), (analyze_noise_prediction, sizes),
                       (analyze_time_dependent, sizes)):
        name = cli.__name__.rsplit(".", 1)[1]
        args = cli.parse_args(base + extra)
        config = cli.make_config(args)
        chains, batch, steps = _chain_plan(name, args, config)
        runs.append((name, cli, args, config, chains * max(steps - 1, 0), chains * batch, steps))
    return runs


def _check_cli_outputs(name, out, config, card):
    """Finite chains, distances and metrics; cosines in [-1, 1]; variance
    ratios in [0, 1]; the text and npz files written."""
    sizes = sorted(float(s) for s in CLI_SIZES.split(","))
    if name == "analyze_trajectories":
        teacher, student = out
        bad = [gs for d in (teacher, student) for gs, v in d.items()
               if v.shape != (config.timesteps + 1, 32, 32, 3) or not np.isfinite(v).all()]
        if bad or sorted(teacher) != [1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0]:
            raise RuntimeError(f"{name}: averaged chains not finite or misshapen at {bad}")
        return (f"{len(teacher)} scales, averaged chains [{config.timesteps + 1}, 32, 32, 3] "
                f"finite; teacher final-state std at gs 1 / 100: "
                f"{teacher[1.0][-1].std():.4g} / {teacher[100.0][-1].std():.4g}")
    if name == "analyze_effectiveness":
        cosine, euclid, source = out
        values = [c for row in cosine.values() for c in row]
        if (source != "real" or sorted(cosine) != sizes or not all(-1 <= c <= 1 for c in values)
                or not np.isfinite([e for row in euclid.values() for e in row]).all()):
            raise RuntimeError(f"{name}: {source} {cosine} {euclid}")
        return "cosine " + "; ".join(f"sf {sf}: {[round(c, 4) for c in cosine[sf]]}" for sf in sizes)
    if name == "analyze_dimensionality":
        if sorted(out) != sizes:
            raise RuntimeError(f"{name}: sizes {sorted(out)}")
        ratios = []
        for r in out.values():
            for entry in r["embeddings"]:
                ratios += list(entry["pca_ratio"])
                if not all(np.isfinite(entry[k]).all() for k in ("pca", "umap")):
                    raise RuntimeError(f"{name}: an embedding is not finite")
            ratios += list(r["latent"]["ratio"])
        if not all(0 <= x <= 1 for x in ratios) or len(r["pairs"][0][0]) != config.teacher_steps + 1:
            raise RuntimeError(f"{name}: variance ratios {ratios}")
        tsne = out[sizes[0]]["embeddings"][0]["tsne_skipped"] or "run"
        return (f"{len(ratios)} explained-variance ratios in [0, 1]; UMAP by "
                f"{out[sizes[0]]['embeddings'][0]['umap_method']}; t-SNE: {tsne}")
    if name == "analyze_noise_prediction":
        for sf in sizes:
            results = out[sf][0]
            path = os.path.join(config.analysis_dir, "noise_prediction", f"size_{sf}",
                                f"noise_metrics_size_{sf}.txt")
            if not (os.path.getsize(path) > 0 and all(
                    np.isfinite(m["mse"]) and np.isfinite(m["mae"])
                    and -1 <= m["cosine_similarity"] <= 1
                    for m in results["metrics_by_timestep"].values())):
                raise RuntimeError(f"{name}: sf {sf} {results}")
        return "; ".join(f"sf {sf}: avg MSE {out[sf][0]['avg_mse']:.6g}, cosine "
                         f"{out[sf][0]['avg_cosine_similarity']:.4f}" for sf in sizes)
    distances, all_metrics = out
    files = [f for f in os.listdir(config.trajectory_dir) if f.endswith(".npz")]
    averages = {k: v for m in all_metrics.values() for k, v in m.items() if k.endswith("_avg")}
    if (sorted(distances) != sizes or len(files) != 5 * len(sizes)
            or not all(np.isfinite(d["teacher_avg_per_timestep"]).all()
                       and np.isfinite(d["student_avg_per_timestep"]).all()
                       for d in distances.values())
            or not np.isfinite(list(averages.values())).all()):
        raise RuntimeError(f"{name}: {len(files)} npz files, distances or metrics not finite")
    return (f"{len(files)} npz files; avg step distance " + "; ".join(
        f"sf {sf}: teacher {distances[sf]['teacher_avg_distance']:.4f} student "
        f"{distances[sf]['student_avg_distance']:.4f}" for sf in sizes))


def phase_cli_runs(card, workdir):
    """Phase 7(b): the five ``run`` halves at full width, the kernel's
    launches counted over all five."""
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update

    runs = _cli_runs(workdir)
    expected = sum(r[4] for r in runs)
    print("analysis CLIs (run halves, bf16, phase 5's checkpoints): " + "; ".join(
        f"{name} {n_traj} trajectories of T={steps}, {launches} launches" if n_traj else
        f"{name} forwards only, no chain" for name, _, _, _, launches, n_traj, steps in runs)
        + f"; expected {expected} launches")
    torch.cuda.synchronize()
    cfg_engine_update.launches = 0
    for name, cli, args, config, launches, n_traj, steps in runs:
        before = cfg_engine_update.launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = cli.run(args, config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        made = cfg_engine_update.launches - before
        summary = _check_cli_outputs(name, out, config, card)
        rate = f", {n_traj / wall:.2f} traj/s" if n_traj else ""
        print(f"{name}.run: {wall:.3f} s{rate}, {made} launches (expected {launches}), peak "
              f"device memory {peak} bytes = {peak / 2**30:.3f} GiB; {summary} [{card}]")
        if made != launches:
            raise RuntimeError(f"{name} launched the kernel {made} times, expected {launches}")
    total = cfg_engine_update.launches
    print(f"analysis CLIs kernel launches: {total} (expected {expected}) [{card}]")
    if total != expected:
        raise RuntimeError("the analysis CLIs did not launch the kernel once per step")
    return total


def phase_cli_profile(card, workdir):
    """Phase 7(c): one batch-1 T=100 paired call, the dimensionality CLI's
    unit, timed and profiled."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion.sampling import draw_step_noise, seeded_normal
    from distillation_trajectories_torch.scripts._common import load_student, load_teacher_from_arg
    from distillation_trajectories_torch.trajectories import make_paired_trajectory_fn

    cfg = Config(base_dir=workdir)  # bf16, cuda, teacher_steps 100
    fn = make_paired_trajectory_fn(load_teacher_from_arg(cfg), load_student(cfg, 0.5),
                                   cfg.teacher_steps, cfg, use_cfg=False)
    noise = seeded_normal([(0, 0)], (32, 32, 3), "cuda")
    step_noise = draw_step_noise([0], cfg.teacher_steps, (32, 32, 3), "cuda")
    run = lambda: fn(noise, [0], 1.0, step_noise=step_noise)
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"paired call (teacher sf 1.0 + student sf 0.5, batch 1, T={cfg.teacher_steps}, "
          f"no CFG, {2 * (cfg.teacher_steps - 1)} forwards): best of "
          f"{[round(t, 4) for t in times]} s [{card}]")
    profile_breakdown(run, min(times), card,
                      label=f"one batch-1 T={cfg.teacher_steps} paired call")


def phase_clis(card, workdir):
    t0 = time.perf_counter()
    phase_cli_check(card, workdir)
    print(f"phase CLIs (a) card vs CPU: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    launches = phase_cli_runs(card, workdir)
    print(f"phase CLIs (b) five run halves: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    phase_cli_profile(card, workdir)
    print(f"phase CLIs (c) profiled paired call: {time.perf_counter() - t0:.1f} s [{card}]")
    if "matplotlib" in sys.modules:
        raise RuntimeError("the analysis CLIs imported matplotlib")
    return launches


PROG_BATCHES = 10  # batches per progressive round (one epoch)
PROG_GUIDANCE = (1.0, 5.0)
PROG_W = 3.0


def phase_edit_check():
    """Phase 8(a): the editing chain and the three forms of the progressive
    step on the card against the CPU, in float32 with TF32 off."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.editing import EditingDraws, denoise_with_trajectory
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.training import make_eval_model_fn
    from distillation_trajectories_torch.training.progressive import make_progressive_distill_step
    from distillation_trajectories_torch.training.state import TorchDraws

    saved = _tf32_off()
    cfg = Config(device="cpu", image_size=16, channels=1, timesteps=10, sample_steps=10,
                 compute_dtype="float32", dropout=0.0)
    dp = get_diffusion_params(10)
    gen = torch.Generator().manual_seed(3)
    original = torch.rand((2, 16, 16, 1), generator=gen) * 2 - 1
    mask = (torch.rand((1, 16, 16, 1), generator=gen) > 0.5).float()
    noise, step_noise = EditingDraws("cpu").chain(0, (2, 16, 16, 1), 9)
    trajs = {}
    for device in ("cpu", "cuda"):
        m, o = mask.to(device), original.to(device)
        model_fn = make_eval_model_fn(make_unet(cfg, size_factor=0.1, device=device, seed=4))
        before = cfg_engine_update.launches
        _, traj = denoise_with_trajectory(
            model_fn, m * noise.to(device) + (1 - m) * o, dp["alphas"], 9,
            step_noise=step_noise.to(device), post_step=lambda z: m * z + (1 - m) * o,
            diffusion_params=dp)
        trajs[device] = (traj.cpu(), cfg_engine_update.launches - before)
    if (trajs["cpu"][1], trajs["cuda"][1]) != (0, 9):
        raise RuntimeError(f"editing chain launches (CPU, card): {trajs['cpu'][1]}, {trajs['cuda'][1]}")
    compare("editing chain (engine mode, inpainting post_step, 9 kernel launches) card vs CPU "
            "(sf 0.1, 16x16x1, batch 2, T=10, f32, TF32 off)", trajs["cuda"][0], trajs["cpu"][0],
            2e-5, 1e-5)

    images = torch.rand((8, 16, 16, 1), generator=torch.Generator().manual_seed(0)) * 2 - 1
    dpt, dps = get_diffusion_params(10), get_diffusion_params(5)
    for label, guidance_range, teacher_guided in (
            ("progressive step (plain)", None, False),
            ("progressive step (guided)", PROG_GUIDANCE, False),
            ("progressive step (teacher_guided)", PROG_GUIDANCE, True)):
        _hold_step_card_vs_cpu(
            label, cfg, images, TorchDraws(2, "cpu").progressive_step(images, 5, guidance_range),
            lambda device: make_progressive_distill_step(
                make_unet(cfg, size_factor=0.1, device=device, seed=9), dpt["alphas"],
                dps["alphas"], 10, dpt, guidance_range=guidance_range,
                teacher_guided=teacher_guided))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _finite_in_unit(name, a):
    if not (np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1):
        raise RuntimeError(f"{name}: not finite or outside [0, 1]: [{a.min()}, {a.max()}]")


def phase_edit_demo(card, workdir):
    """Phase 8(b): the editing demo CLI's ``run`` half at its defaults on
    phase 5's teacher, with the kernel's launches checked against the
    count its arguments give."""
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.scripts import run_editing_demo as cli

    args = cli.parse_args(["--base_dir", workdir, "--device", "cuda"])
    config = cli.make_config(args)
    t = config.timesteps
    # Chains of T-1 steps: inpainting, the batched directions, the latent's
    # generation, prompt editing's two; the re-denoise from T//2.
    expected = 5 * (t - 1) + t // 2
    print(f"editing demo: teacher sf 1.0, {config.image_size}x{config.image_size}x"
          f"{config.channels}, T={t}, {cli.DIRECTION_SAMPLES} direction samples, strength "
          f"{args.strength}, seed {args.seed}, {args.sample_mode} mode, compute "
          f"{config.compute_dtype}; expected launches {expected}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg_engine_update.launches = 0
    timings = {}
    t0 = time.perf_counter()
    out = cli.run(args, config, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cfg_engine_update.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"editing demo kernel launches: {launches} (expected {expected}) [{card}]")
    if launches != expected:
        raise RuntimeError("the editing demo did not launch the kernel once per step")

    inpaint, latent, prompt = out["inpainting"], out["latent_manipulation"], out["prompt_editing"]
    for name, a in (("inpainted", inpaint["inpainted_image"]),
                    ("latent original", latent["original_image"]),
                    ("latent manipulated", latent["manipulated_image"]),
                    ("prompt original", prompt["original_image"]),
                    ("prompt edited", prompt["edited_image"])):
        _finite_in_unit(name, a)
    outside = inpaint["mask"] == 0
    kept = float(np.abs(inpaint["inpainted_image"][outside] - inpaint["original_image"][outside]).max())
    if kept > 1e-6:
        raise RuntimeError(f"the inpainted image differs from the original outside the mask: {kept}")
    rows = {k: v.shape[0] for k, v in (("inpainting", inpaint["trajectory"]),
                                       ("latent", latent["trajectory"]),
                                       ("prompt original", prompt["original_trajectory"]),
                                       ("prompt edited", prompt["edited_trajectory"]))}
    if rows != {"inpainting": t + 1, "latent": t // 2 + 2, "prompt original": t + 1,
                "prompt edited": t + 1}:
        raise RuntimeError(f"trajectory rows {rows}")
    directions = np.stack([out["directions"][f"pca_{i}"] for i in range(10)])
    if len(out["directions"]) != 10 or not np.isfinite(directions).all():
        raise RuntimeError("the directions are not 10 finite vectors")
    print(f"editing outputs: images finite in [0, 1]; inpainted = original outside the mask "
          f"(max diff {kept:.2e}, {int(outside.sum())} pixels kept); trajectory rows {rows}; "
          f"10 finite PCA directions of {directions.shape[1]} (norms "
          f"{np.linalg.norm(directions, axis=1).min():.6f}-"
          f"{np.linalg.norm(directions, axis=1).max():.6f}) [{card}]")
    print(f"editing demo run {wall:.3f} s: teacher load {timings['teacher_load_s']:.3f} s, "
          f"inpainting {timings['inpainting_s']:.3f} s, latent manipulation (directions + "
          f"generation + re-denoise) {timings['latent_manipulation_s']:.3f} s, prompt editing "
          f"{timings['prompt_editing_s']:.3f} s; peak device memory {peak} bytes = "
          f"{peak / 2**30:.3f} GiB [{card}]")
    return launches


class _RoundSteps(_TimedSteps):
    """``_TimedSteps`` that also keeps, for each step it makes (one per
    progressive round), the model that round trains and the peak device
    memory of its steps."""

    def __init__(self, factory):
        super().__init__(factory)
        self.models, self.peaks = [], []

    def __call__(self, *args, **kwargs):
        timed = super().__call__(*args, **kwargs)
        i = len(self.models)
        self.models.append(None)
        self.peaks.append(0)
        torch.cuda.reset_peak_memory_stats()

        def step(state, images, draws=None):
            out = timed(state, images, draws)
            self.models[i] = state.model
            self.peaks[i] = torch.cuda.max_memory_allocated()
            return out

        return step


def phase_progressive(card, workdir):
    """Phase 8(c): ``progressive_distill`` at full width from phase 5's
    teacher, two plain rounds and one guided round, every checkpoint read
    back (phase 12(d) and (e) time the students' chains)."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.models import load_unet_variables, make_unet
    from distillation_trajectories_torch.scripts._common import load_teacher_from_arg
    from distillation_trajectories_torch.training import progressive
    from distillation_trajectories_torch.training.checkpoints import (
        load_checkpoint,
        variables_from_checkpoint,
    )

    cfg = Config(base_dir=workdir, dataset="CIFAR10", epochs=1, timesteps=TRAIN_T,
                 sample_steps=TRAIN_T, limit_batches_per_epoch=PROG_BATCHES)
    teacher = load_teacher_from_arg(cfg)
    print(f"progressive: from phase 5's teacher (sf 1.0), {cfg.dataset} shapes "
          f"{cfg.image_size}x{cfg.image_size}x{cfg.channels} (synthetic stand-in), batch "
          f"{cfg.batch_size}, teacher_steps {cfg.teacher_steps}, compute {cfg.compute_dtype}, "
          f"dropout {cfg.dropout}; rounds of one epoch of {PROG_BATCHES} batches: plain "
          f"{cfg.teacher_steps} -> {cfg.teacher_steps // 2} -> {cfg.teacher_steps // 4}, guided "
          f"w ~ U{list(PROG_GUIDANCE)} {cfg.teacher_steps} -> {cfg.teacher_steps // 2}")
    timed = _RoundSteps(progressive.make_progressive_distill_step)
    with mock.patch.object(progressive, "make_progressive_distill_step", timed):
        t0 = time.perf_counter()
        plain, plain_steps = progressive.progressive_distill(cfg, teacher, rounds=2, seed=0)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        guided, guided_steps = progressive.progressive_distill(
            cfg, teacher, rounds=1, seed=0, guidance_range=PROG_GUIDANCE)
        torch.cuda.synchronize()
        guided_s = time.perf_counter() - t0
    if (plain_steps, guided_steps) != (cfg.teacher_steps // 4, cfg.teacher_steps // 2):
        raise RuntimeError(f"progressive rounds ended at {plain_steps} / {guided_steps} steps")
    rounds = (("plain", cfg.teacher_steps // 2, "2 teacher forwards"),
              ("plain", cfg.teacher_steps // 4, "2 teacher forwards"),
              ("guided", cfg.teacher_steps // 2, "4 teacher forwards (CFG pair x 2 updates)"))
    for (kind, n, forwards), record, model, peak in zip(rounds, timed.runs, timed.models,
                                                          timed.peaks):
        _step_summary(f"progressive step {kind} -> {n} steps ({forwards} + student forward "
                      f"and backward)", record, cfg.batch_size, card)
        print(f"  peak device memory of the round's steps: {peak} bytes = "
              f"{peak / 2**30:.3f} GiB [{card}]")
        family = "progressive" if kind == "plain" else "progressive_cfg"
        ckpt_dir = os.path.join(cfg.models_dir, family, f"steps_{n}")
        restored = load_unet_variables(make_unet(cfg, size_factor=1.0),
                                       variables_from_checkpoint(load_checkpoint(ckpt_dir, 1)))
        trained = model.state_dict()
        for k, v in restored.state_dict().items():
            if not k.endswith("num_batches_tracked") and not torch.equal(v, trained[k]):
                raise RuntimeError(f"{ckpt_dir}: checkpoint entry {k} differs from the trained model")
        print(f"  {family}/steps_{n}/model_epoch_1.msgpack read back equal to the trained model")
    if timed.models[1] is not plain or timed.models[2] is not guided:
        raise RuntimeError("progressive_distill did not return the last round's student")
    print(f"progressive_distill wall: plain 2 rounds {plain_s:.3f} s, guided 1 round "
          f"{guided_s:.3f} s (datasets, steps and async checkpoints included) [{card}]")


def phase_edit(card, workdir):
    t0 = time.perf_counter()
    phase_edit_check()
    print(f"phase editing/progressive (a) card vs CPU: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    launches = phase_edit_demo(card, workdir)
    print(f"phase editing/progressive (b) editing demo: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    phase_progressive(card, workdir)
    print(f"phase editing/progressive (c) progressive distillation: "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    if "matplotlib" in sys.modules:
        raise RuntimeError("the editing and progressive paths imported matplotlib")
    return launches


INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores (dense)


def phase_int8_check(card, workdir):
    """9(a), first: the int8 pieces on the card against the CPU."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.models.quantized import (
        _qconv,
        int8_matmul,
        make_quantized_eval_fn,
        quantize_unet_variables,
        quantized_unet_apply,
    )
    from distillation_trajectories_torch.scripts._common import load_teacher_from_arg

    saved = _tf32_off()
    gen = torch.Generator().manual_seed(0)
    shapes = ((4, 27, 32), (512, 27, 128), (17, 2304, 256), (4096, 4608, 256), (48, 144, 20),
              (262144, 3, 128))
    for m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen)
        got = int8_matmul(a.cuda(), b.cuda())
        if got.dtype != torch.int32 or not torch.equal(got.cpu().long(), a.long() @ b.long()):
            raise RuntimeError(f"int8_matmul on the card differs from the exact product at {m, k, n}")
    print(f"int8_matmul (torch._int_mm, column-major b, zero-padded to M >= 32 and M, K, N multiples of 8) on the "
          f"card equals the exact int64 product at (M, K, N) {list(shapes)} [{card}]")
    q = {"w_int8": torch.randint(-127, 128, (3, 3, 64, 24), dtype=torch.int8, generator=gen),
         "scale": torch.rand(24, generator=gen) * 1e-2, "bias": torch.randn(24, generator=gen)}
    xq = torch.randint(-127, 128, (2, 8, 8, 64), dtype=torch.int8, generator=gen)
    want = _qconv(q, xq, torch.tensor(0.05), 1)
    got = _qconv({k: v.cuda() for k, v in q.items()}, xq.cuda(), torch.tensor(0.05).cuda(), 1)
    if not torch.equal(got.cpu(), want):
        raise RuntimeError("_qconv on the card is not bit for bit the CPU's")
    print(f"_qconv (3x3, 64 -> 24, int8 operands) card vs CPU: bit for bit [{card}]")

    rel = lambda a, b: float((a - b).norm() / b.norm())
    # A small input (seeded sf-0.1 U-Net, 2 x 16x16x1): no activation code
    # sits near a rounding tie, so the two devices agree to float rounding.
    small = {}
    x = torch.randn((2, 16, 16, 1), generator=gen)
    t, c = torch.tensor([2.0, 7.0]), torch.ones((2, 1))
    for d in ("cpu", "cuda"):
        cfg = Config(device=d, image_size=16, channels=1, compute_dtype="float32")
        fn = make_quantized_eval_fn(make_unet(cfg, size_factor=0.1, seed=3))
        small[d] = fn(x.to(d), t.to(d), c.to(d), c.to(d)).cpu()
    small_rel = rel(small["cuda"], small["cpu"])
    print(f"int8 forward card vs CPU (seeded sf 0.1, f32, TF32 off, 2 x 16x16x1): relative L2 "
          f"{small_rel:.3e} (tolerance 1e-4) [{card}]")
    if not (torch.isfinite(small["cuda"]).all() and small_rel <= 1e-4):
        raise RuntimeError("the int8 forward on the card disagrees with the CPU's")
    # Phase 5's teacher at 4 x 32x32x3. The weights and the activations
    # (16 sites, per-tensor scales from each site's max) round to int8
    # codes; an ulp of difference between the devices (BatchNorm's rsqrt in
    # the fold, expf in the time embedding) flips a code at a rounding tie,
    # and one flipped code moves later sites' values, maxima and codes, so
    # two free-running forwards differ by up to the int8 noise itself. The
    # card is held where it can be held exactly: its fold and int8 weights
    # to the CPU's (codes one apart only at a tie), then, on the CPU's tree
    # and fed the CPU's codes at every site, its pre-rounding values within
    # 1e-3 of a code (float32 rounding and the time path's ulps stay below
    # 2e-4), its scales within 1e-5 relative and its output within 1e-5
    # relative L2. Free-running, it must stay as near the float forward as
    # the CPU does.
    models = {d: load_teacher_from_arg(Config(base_dir=workdir, device=d, compute_dtype="float32"))
              for d in ("cpu", "cuda")}
    x = torch.randn((4, 32, 32, 3), generator=gen)
    t = torch.tensor([3.0, 17.0, 41.0, 99.0])
    c = torch.tensor([[0.0], [1.0], [0.0], [1.0]])
    m = torch.ones((4, 1))
    inputs = (x, t, c, m)
    qvars = {d: quantize_unet_variables(models[d]) for d in models}
    folded = {d: quantize_unet_variables(models[d], nbits=None) for d in models}
    wflips, wcodes = _hold_int8_weights(qvars, folded)
    shared = _tree_to(qvars["cpu"], "cuda")
    fns = {"cpu": lambda *a: quantized_unet_apply(models["cpu"], qvars["cpu"], *a),
           "cuda": lambda *a: quantized_unet_apply(models["cuda"], shared, *a)}
    forced, sites = _int8_forced_forward(fns, inputs)
    cpu_out = fns["cpu"](*inputs)
    own = quantized_unet_apply(models["cuda"], qvars["cuda"], *(v.cuda() for v in inputs)).cpu()
    with torch.no_grad():
        float_out = models["cpu"].eval()(*inputs)
    one_flip = rel(_tied_flip_forward(fns["cpu"], inputs), cpu_out)
    gap, drift, own_drift = rel(own, cpu_out), rel(cpu_out, float_out), rel(own, float_out)
    forced_gap = rel(forced, cpu_out)
    dv = max(s["dv"] for s in sites)
    ds = max(s["ds"] for s in sites)
    flips = sum(s["flips"] for s in sites)
    codes = sum(s["n"] for s in sites)
    print(f"int8 weights card vs CPU (phase 5's sf-1.0 teacher): folded floats, scales and "
          f"biases within 1e-6 of their largest value, {wflips} of {wcodes} int8 codes one apart, "
          f"each at a rounding tie [{card}]")
    print(f"int8 forward card vs CPU (the CPU's tree, f32, TF32 off, 4 x 32x32x3), fed the "
          f"CPU's codes at all {len(sites)} sites: pre-rounding values within {dv:.3e} of a code "
          f"(tolerance 1e-3), scales within {ds:.3e} relative (1e-5), {flips} of {codes} codes "
          f"at a tie, output relative L2 {forced_gap:.3e} (1e-5) [{card}]")
    print(f"int8 forward free-running (the card's own tree): card vs CPU relative L2 {gap:.3e} "
          f"(one tied input code flipped on the CPU moves its output by {one_flip:.3e}); int8 vs "
          f"float {own_drift:.3e} on the card, {drift:.3e} on the CPU (tolerance 0.15) [{card}]")
    if not (torch.isfinite(own).all() and dv <= 1e-3 and ds <= 1e-5 and forced_gap <= 1e-5
            and own_drift < 0.15 and drift < 0.15):
        raise RuntimeError("the int8 forward on the card disagrees with the CPU's")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _hold_int8_weights(qvars, folded):
    """The card's BatchNorm fold and int8 weights (``qvars["cuda"]``)
    against the CPU's: float leaves within 1e-6 of the CPU leaf's largest
    magnitude, dense leaves equal, int8 codes equal or one apart where the
    CPU's ``w / scale`` sits within 1e-3 of a rounding tie. Returns
    ``(codes one apart, codes)``; raises on any other difference."""
    near = lambda a, b: float((a.cpu() - b).abs().max()) <= 1e-6 * float(b.abs().max())
    cpu, dev = qvars["cpu"], qvars["cuda"]
    for key in ("time_dense", "cond_dense1", "cond_dense2", "final"):
        if not all(torch.equal(dev[key][k].cpu(), cpu[key][k]) for k in cpu[key]):
            raise RuntimeError(f"the int8 tree's {key} differs between the card and the CPU")
    flips = n = 0
    for name, blk in cpu["blocks"].items():
        for conv, q in blk.items():
            qc = dev["blocks"][name][conv]
            if conv == "time_mlp":
                if not all(torch.equal(qc[k].cpu(), q[k]) for k in q):
                    raise RuntimeError(f"{name}.time_mlp differs between the card and the CPU")
                continue
            w = folded["cpu"]["blocks"][name][conv]["w"]
            if not (near(folded["cuda"]["blocks"][name][conv]["w"], w)
                    and near(qc["scale"], q["scale"]) and near(qc["bias"], q["bias"])):
                raise RuntimeError(f"{name}.{conv}: the card's fold differs from the CPU's")
            diff = qc["w_int8"].cpu().int() - q["w_int8"].int()
            v = w / q["scale"]
            tie = ((v - v.floor()) - 0.5).abs() <= 1e-3
            if int(diff.abs().max()) > 1 or bool(((diff != 0) & ~tie).any()):
                raise RuntimeError(f"{name}.{conv}: the card's int8 weights differ from the CPU's "
                                   f"away from a rounding tie")
            flips += int((diff != 0).sum())
            n += diff.numel()
    return flips, n


def _tied_flip_forward(fn, inputs):
    """``fn(*inputs)`` with the input site's most tied code rounded the
    other way: what one code's flip does to the int8 forward."""
    from distillation_trajectories_torch.models import quantized

    aquant = quantized._aquant
    done = []

    def flip(x, static_scale=None):
        xq, s = aquant(x, static_scale)
        if not done:
            v = (x.float() / s).flatten()
            j = int(((v - v.floor()) - 0.5).abs().argmin())
            xq = xq.flatten().clone()
            xq[j] += 1 if float(v[j]) > float(xq[j]) else -1
            xq = xq.view(x.shape)
            done.append(j)
        return xq, s

    try:
        quantized._aquant = flip
        return fn(*inputs)
    finally:
        quantized._aquant = aquant


def _int8_forced_forward(fns, inputs):
    """The card's int8 forward with every activation site fed the CPU's codes
    and scale: ``(output on the CPU, per-site records)``. Each record holds
    the largest gap between the two devices' pre-rounding values in code
    units (``dv``, the card's value over the CPU's scale), the scales'
    relative gap (``ds``), the codes the card would have rounded otherwise
    (``flips``) and the site's size (``n``)."""
    from distillation_trajectories_torch.models import quantized

    aquant = quantized._aquant
    cpu_sites, sites = [], []

    def record(x, static_scale=None):
        xq, s = aquant(x, static_scale)
        cpu_sites.append((x.float() / s, xq, s))
        return xq, s

    def forced(x, static_scale=None):
        xq, s = aquant(x, static_scale)
        v_cpu, xq_cpu, s_cpu = cpu_sites[len(sites)]
        v = (x.float() / s_cpu.to(x.device)).cpu()
        sites.append({
            "dv": float((v - v_cpu).abs().max()),
            "ds": abs(float(s) / float(s_cpu) - 1.0),
            "flips": int((xq.cpu() != xq_cpu).sum()),
            "n": xq_cpu.numel(),
        })
        return xq_cpu.to(x.device), s_cpu.to(x.device)

    try:
        quantized._aquant = record
        fns["cpu"](*inputs)
        quantized._aquant = forced
        out = fns["cuda"](*(v.cuda() for v in inputs)).cpu()
    finally:
        quantized._aquant = aquant
    if len(sites) != len(cpu_sites):
        raise RuntimeError(f"the card's forward quantized {len(sites)} sites, the CPU's "
                           f"{len(cpu_sites)}")
    return out, sites


def _int8_layer_times(teacher, card):
    """Each Block conv at the main path's batch: the int8 conv (im2col +
    torch._int_mm + dequantization), its product alone, and the bf16 cuDNN
    conv of the same layer, device times by CUDA events."""
    import torch.nn.functional as F

    from distillation_trajectories_torch.models.quantized import (
        _aquant,
        _im2col,
        _qconv,
        int8_matmul,
        quantize_unet_variables,
    )

    from distillation_trajectories_torch.scripts._common import block_sizes

    qvars = quantize_unet_variables(teacher)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sums = [0.0, 0.0, 0.0]
    print(f"int8 conv per layer at batch {SAMPLES} (device ms; product bound at 1979 TOP/s int8 and "
          f"3.35 TB/s):")
    with torch.no_grad():
        for name, hw in block_sizes(32).items():
            block = getattr(teacher, name)
            for conv_name, key, pad in (("conv1", "conv1", 1), ("conv2", "conv2", 1),
                                        ("residual_conv", "residual", 0)):
                if key not in qvars["blocks"][name]:
                    continue
                conv, q = getattr(block, conv_name), qvars["blocks"][name][key]
                k, cin, cout = conv.kernel_size[0], conv.in_channels, conv.out_channels
                x = torch.randn((SAMPLES, hw, hw, cin), device="cuda", generator=gen)
                xq, s = _aquant(x)
                a, wmat = _im2col(xq, k, k, pad), q["w_int8"].reshape(-1, cout)
                xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
                wb, bb = conv.weight.to(torch.bfloat16), conv.bias.to(torch.bfloat16)
                times = (device_time_ms(lambda: _qconv(q, xq, s, pad), 10),
                         device_time_ms(lambda: int8_matmul(a, wmat), 10),
                         device_time_ms(lambda: F.conv2d(xb, wb, bb, padding=pad), 10))
                m_, k_ = a.shape
                ops_ms = 2 * m_ * k_ * cout / INT8_OPS_PER_S * 1e3
                bytes_ms = (m_ * k_ + k_ * cout + 4 * m_ * cout) / HBM_BYTES_PER_S * 1e3
                sums = [u + v for u, v in zip(sums, times)]
                print(f"  {name}.{conv_name} {hw}x{hw} {cin}->{cout} k{k} (M {m_}, K {k_}, N "
                      f"{cout}): int8 conv {times[0]:.4f} ms (product {times[1]:.4f} ms, bound "
                      f"{max(ops_ms, bytes_ms):.4f} ms by {'operations' if ops_ms > bytes_ms else 'bytes'}) "
                      f"vs bf16 cuDNN {times[2]:.4f} ms")
                del x, xq, a, xb
    print(f"  all Block convs of one forward: int8 {sums[0]:.3f} ms (products {sums[1]:.3f} ms) vs "
          f"bf16 cuDNN {sums[2]:.3f} ms [{card}]")


def phase_migration(card, workdir):
    """9(b): phase 5's teacher to a reference .pt and back through the CLIs."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.models import load_unet_variables, make_unet
    from distillation_trajectories_torch.models.torch_port import export_reference_unet_state_dict
    from distillation_trajectories_torch.scripts import (
        export_reference_checkpoint,
        import_reference_checkpoint,
    )
    from distillation_trajectories_torch.scripts._common import load_teacher_from_arg
    from distillation_trajectories_torch.training.checkpoints import (
        load_checkpoint,
        variables_from_checkpoint,
    )

    cfg = Config(base_dir=workdir)
    teacher = load_teacher_from_arg(cfg)
    exported = export_reference_unet_state_dict(teacher)
    pt = os.path.join(workdir, "teacher_reference.pt")
    t0 = time.perf_counter()
    torch.save(exported, pt)
    moved = os.path.join(workdir, "migrated")
    path = import_reference_checkpoint.main([pt, "--base_dir", moved, "--epoch", "1"])
    import_s = time.perf_counter() - t0
    mcfg = Config(base_dir=moved)
    restored = load_unet_variables(make_unet(mcfg, size_factor=1.0),
                                   variables_from_checkpoint(load_checkpoint(mcfg.teacher_models_dir, 1)))
    t0 = time.perf_counter()
    pt2 = export_reference_checkpoint.main([os.path.join(workdir, "again.pt"), "--base_dir", workdir])
    export_s = time.perf_counter() - t0
    again = torch.load(pt2, map_location="cpu", weights_only=True)
    state = restored.state_dict()
    for k, v in exported.items():
        if k.endswith("num_batches_tracked"):
            continue
        if not (torch.equal(state[k].cpu(), v) and torch.equal(again[k], v)):
            raise RuntimeError(f"migration changed {k}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 32, 32, 3), device="cuda", generator=gen)
    t = torch.arange(8, device="cuda") * 12
    c = (torch.arange(8, device="cuda") % 2).float()[:, None]
    with torch.no_grad():
        diff = float((restored.eval()(x, t, c, torch.ones_like(c))
                      - teacher.eval()(x, t, c, torch.ones_like(c))).abs().max())
    if diff != 0.0:
        raise RuntimeError(f"the migrated teacher's forward differs: {diff}")
    print(f"migration: teacher -> {os.path.basename(pt)} ({os.path.getsize(pt)} bytes, "
          f"{len(exported)} entries) -> import CLI -> {os.path.relpath(path, workdir)} "
          f"({import_s:.3f} s with the save); export CLI from phase 5's checkpoint "
          f"{export_s:.3f} s; every weight and statistic equal bit for bit, the eval forward "
          f"identical (max abs diff {diff}, bf16, 8 images) [{card}]")


# 9(c)'s CFG stage at 2 of its 10 guidance scales: phase 6(b) runs the same
# CLI with both jobs at full depth, and the script's time limit is shared.
ORCHESTRATOR_STAGE_ARGS = {"cfg_trio": ["--guidance_scales", "1.0,3.0"]}


def phase_orchestrator(card, workdir):
    """9(c): the full-sweep orchestrator with --skip-training on phase 5's
    checkpoints, as a subprocess (each stage a subprocess of its own), its
    CFG stage cut to two guidance scales."""
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    run = ("import sys; from distillation_trajectories_torch.scripts import run_full_sweep as r; "
           f"r.STAGE_ARGS = {ORCHESTRATOR_STAGE_ARGS!r}; sys.exit(r.main(sys.argv[1:]))")
    cmd = [sys.executable, "-c", run,
           "--skip-training", "--tag", "chip", "--base_dir", workdir, "--size_factors", CLI_SIZES]
    t0 = time.perf_counter()
    # Its own session, so that a timeout stops the stages it started too.
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError("run_full_sweep did not finish in 400 s")
    wall = time.perf_counter() - t0
    print("\n".join("  " + line for line in stdout.splitlines()
                    if line.startswith("[sweep]") and "log:" not in line))
    with open(os.path.join(workdir, "SWEEP_torch_chip.json")) as f:
        payload = json.load(f)
    stages = payload["stages"]
    print(f"run_full_sweep --skip-training (sizes {CLI_SIZES}, cuda, CFG stage at guidance "
          f"1.0,3.0): exit {proc.returncode}, "
          f"{wall:.3f} s; SWEEP_torch_chip.json ok={payload['ok']}, device "
          f"{payload['preflight_probe'].get('name')}, stages " + ", ".join(
              f"{k} {v['seconds']} s ok={v['ok']}" for k, v in stages.items()) + f" [{card}]")
    if proc.returncode != 0 or not payload["ok"] or set(stages) != {"cfg_sweep", "trio", "fid"}:
        print(stdout[-3000:], stderr[-3000:])
        raise RuntimeError("the orchestrator's stages did not all pass")


PARADIGMS_W = 8  # 9(d)'s window


def phase_window_dispatch(card, workdir):
    """9(d): the engine's window dispatch (``Config.parallel_sampling``)
    on phase 5's teacher, B=1, float32 with TF32 off: ``generate_trajectory``
    sequential (the kernel at every step) and with the window sampler at
    tol 0 (no kernel), the latter within 1e-5 of the former; returns the
    kernel's launches."""
    import dataclasses

    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import parallel_sampling
    from distillation_trajectories_torch.diffusion.sampling import seeded_normal
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.scripts._common import load_teacher_from_arg
    from distillation_trajectories_torch.trajectories import generate_trajectory

    sweeps = []
    window = parallel_sampling.sliding_window_trajectory

    def recorded(*args, **kwargs):
        traj, n = window(*args, **kwargs)
        sweeps.append(n)
        return traj, n

    saved = _tf32_off()
    try:
        cfg = Config(base_dir=workdir, timesteps=MAIN_T, sample_steps=MAIN_T,
                     compute_dtype="float32")
        teacher = load_teacher_from_arg(cfg)
        runs = {"sequential": cfg, "window": dataclasses.replace(
            cfg, parallel_sampling="window", paradigms_window=PARADIGMS_W, paradigms_tol=0.0)}
        noise = seeded_normal([(7, 0)], MAIN_SHAPE[1:], "cuda")
        outs, made, secs = {}, {}, {}
        with mock.patch.object(parallel_sampling, "sliding_window_trajectory", recorded):
            for label, rcfg in runs.items():
                before = cfg_engine_update.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[label] = generate_trajectory(teacher, noise, MAIN_T, seed=7,
                                                  guidance_scale=3.0, config=rcfg)
                torch.cuda.synchronize()
                secs[label] = time.perf_counter() - t0
                made[label] = cfg_engine_update.launches - before
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    gap = float((outs["window"] - outs["sequential"]).abs().max())
    print(f"window dispatch (phase 5's teacher, B=1, T={MAIN_T}, W={PARADIGMS_W}, tol 0, gs 3.0, "
          f"float32, TF32 off): {sweeps} sweeps, {made} kernel launches, seconds (first calls) "
          f"{ {k: round(v, 3) for k, v in secs.items()} }, max abs gap to the sequential chain "
          f"{gap:.3e} (at most 1e-5) [{card}]")
    if (made != {"sequential": MAIN_T - 1, "window": 0} or len(sweeps) != 1 or not gap <= 1e-5
            or not all(torch.isfinite(o).all() for o in outs.values())):
        raise RuntimeError("the window dispatch did not hold to the sequential chain")
    return made["sequential"]


def phase_lanes(card, workdir):
    """Phase 9 (the int8 arms' chains and the window sampler's grid are
    phase 12's: ``bench_quant``, ``bench_r2``); returns the kernel's
    launches (9(d)'s sequential chain)."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.scripts._common import load_teacher_from_arg

    t0 = time.perf_counter()
    phase_int8_check(card, workdir)
    _int8_layer_times(load_teacher_from_arg(Config(base_dir=workdir)), card)
    print(f"phase lanes (a) int8: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    phase_migration(card, workdir)
    print(f"phase lanes (b) migration: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    phase_orchestrator(card, workdir)
    print(f"phase lanes (c) orchestrator: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    launches = phase_window_dispatch(card, workdir)
    print(f"phase lanes (d) window dispatch: {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


# --- Phase 10: the multi-device lanes, two ranks sharing the card -----------

LANE_HOLD_T = 10  # the numerical holds' chains (float32, TF32 off)
LANE_STEPS = 3  # train steps a mesh: the hold's, then the timed ones (bf16)
LANE_SPATIAL_PX = 256  # the spatial lane's big image (batch 1)


def _lane_models(cfg):
    """Phase 4's seeded teacher and students, built for ``cfg``."""
    from distillation_trajectories_torch.models import make_unet

    return (make_unet(cfg, size_factor=1.0, seed=0),
            {sf: make_unet(cfg, size_factor=sf, seed=i + 1) for i, sf in enumerate(STUDENTS)})


def _lane_images():
    """The global batches of 10(b)'s train steps, seeded on the host."""
    gen = torch.Generator().manual_seed(11)
    return torch.rand((LANE_STEPS, 128, 32, 32, 3), generator=gen) * 2 - 1


def _lane_teacher_state(cfg, mesh):
    """10(b)'s teacher train state (TorchDraws seed 0), sharded on
    ``mesh`` when there is one."""
    from distillation_trajectories_torch.parallel import shard_train_state
    from distillation_trajectories_torch.training.state import TorchDraws, create_train_state

    source = TorchDraws(0, "cuda")
    state = create_train_state(source.init_unet(cfg, 1.0), cfg, source)
    return shard_train_state(state, mesh) if mesh is not None else state


def _rank_sweep(rank):
    """10(a): the data-sharded sweep on (2, 1): the T=10 float32 hold, then
    the main path's width in bf16, timed."""
    import torch.distributed as dist

    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.trajectories import sweep_compare_trajectories

    saved = _tf32_off()
    cfg = Config(timesteps=LANE_HOLD_T, sample_steps=LANE_HOLD_T, compute_dtype="float32",
                 mesh_shape=(2, 1))
    teacher, students = _lane_models(cfg)
    cfg_engine_update.launches = 0
    hold = sweep_compare_trajectories(teacher, students, cfg, guidance_scales=MAIN_GS,
                                      num_samples=SAMPLES, base_seed=42, verbose=False)
    hold_launches = cfg_engine_update.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    cfg = Config(timesteps=MAIN_T, sample_steps=MAIN_T, mesh_shape=(2, 1))  # bf16
    teacher, students = _lane_models(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    cfg_engine_update.launches = 0
    t0 = time.perf_counter()
    out = sweep_compare_trajectories(teacher, students, cfg, guidance_scales=MAIN_GS,
                                     num_samples=SAMPLES, base_seed=42, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(hold=hold, hold_launches=hold_launches, launches=cfg_engine_update.launches,
                seconds=seconds, peak=torch.cuda.max_memory_allocated(), out=out)


def _rank_train(rank, ckpt_dir):
    """10(b) and the write of 10(c): three teacher steps on (2, 1) and on
    (1, 2), float32 for the hold, then bf16 timed; the (1, 2) bf16 state
    written with ``save_checkpoint_sharded``."""
    import dataclasses

    import torch.distributed as dist

    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.parallel import mesh_from_config, shard_batch
    from distillation_trajectories_torch.parallel.collectives import gather_state_dict
    from distillation_trajectories_torch.training import save_checkpoint_sharded
    from distillation_trajectories_torch.training.state import make_teacher_train_step

    images = _lane_images()
    out = {}
    for shape in ((2, 1), (1, 2)):
        saved = _tf32_off()
        cfg = Config(timesteps=TRAIN_T, sample_steps=TRAIN_T, compute_dtype="float32",
                     mesh_shape=shape)
        mesh = mesh_from_config(cfg)
        step = make_teacher_train_step(get_diffusion_params(TRAIN_T, cfg), TRAIN_T)
        state = _lane_teacher_state(cfg, mesh)
        losses = [float(step(state, shard_batch(images[i], mesh).cuda())[1])
                  for i in range(LANE_STEPS)]
        hold_state = {k: v.cpu() for k, v in gather_state_dict(state.model).items()}
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
        state = _lane_teacher_state(cfg, mesh)
        times = []
        for i in range(LANE_STEPS + 1):  # one warm-up step
            x = shard_batch(images[i % LANE_STEPS], mesh).cuda()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            step(state, x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rec = dict(losses=losses, hold_state=hold_state if rank == 0 else None,
                   times=times[1:],
                   local_shapes={k: tuple(v.shape) for k, v in state.model.state_dict().items()})
        if shape == (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint_sharded(ckpt_dir, 1, state.model, optimizer=state.optimizer)
            rec["write_s"] = time.perf_counter() - t0
            rec["saved"] = {k: v.cpu() for k, v in gather_state_dict(state.model).items()}
        out[shape] = rec
    return out


def _rank_spatial(rank, workdir):
    """10(e): phase 5's teacher spatially partitioned on (1, 2): the
    32x32 forward and a T=50 CFG chain through ``generate_trajectory``
    (float32, TF32 off), then one batch-1 forward at 256x256 in bf16 with
    this rank's peak memory."""
    import dataclasses

    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.trajectories import generate_trajectory
    from distillation_trajectories_torch.training import make_eval_fn_from_config
    from distillation_trajectories_torch.training.students import load_teacher

    saved = _tf32_off()
    cfg = Config(base_dir=workdir, compute_dtype="float32", spatial_shape=(1, 2))
    teacher = load_teacher(cfg)
    x, t, c, noise = _spatial_inputs()
    forward = make_eval_fn_from_config(teacher, cfg)(x.cuda(), t.cuda(), c.cuda(), c.cuda())
    cfg_engine_update.launches = 0
    traj = generate_trajectory(teacher, noise, MAIN_T, seed=3, guidance_scale=3.0, config=cfg)
    launches = cfg_engine_update.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", image_size=LANE_SPATIAL_PX)
    fn = make_eval_fn_from_config(load_teacher(cfg), cfg)
    big, tb, cb = _spatial_big()
    fn(big, tb, cb, cb)  # warm-up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(big, tb, cb, cb)
    torch.cuda.synchronize()
    return dict(forward=forward.cpu(), traj=traj.cpu(), launches=launches,
                big_ms=(time.perf_counter() - t0) * 1e3, big_finite=bool(torch.isfinite(out).all()),
                big_peak=torch.cuda.max_memory_allocated() - before)


def _spatial_inputs():
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((8, 32, 32, 3), generator=gen)
    t = torch.arange(8, dtype=torch.float32) * 11
    c = (torch.arange(8) % 2).float()[:, None]
    return x, t, c, torch.randn((8, 32, 32, 3), generator=gen)


def _spatial_big():
    gen = torch.Generator().manual_seed(13)
    big = torch.randn((1, LANE_SPATIAL_PX, LANE_SPATIAL_PX, 3), generator=gen).cuda()
    return big, torch.full((1,), 40.0, device="cuda"), torch.ones((1, 1), device="cuda")


def _lane_rank(rank, workdir):
    """Everything phase 10 runs in each of the two ranks, in order."""
    from distillation_trajectories_torch.parallel.collectives import all_gather_cat

    import torch.distributed as dist

    out = {"backend": dist.get_backend()}
    t0 = time.perf_counter()
    out["sweep"] = _rank_sweep(rank)
    out["sweep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"] = _rank_train(rank, os.path.join(workdir, "lanes_ckpt"))
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["spatial"] = _rank_spatial(rank, workdir)
    out["spatial_s"] = time.perf_counter() - t0
    # How the gather travelled: gloo's all_gather of CUDA tensors.
    probe = all_gather_cat(torch.full((2,), float(rank), device="cuda"), dist.group.WORLD)
    out["gather_probe"] = probe.cpu().tolist()
    return out


def _hold_sweep(card):
    """10(a)'s reference: phase 4's sweep unsharded at T=10 in float32."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.trajectories import sweep_compare_trajectories

    saved = _tf32_off()
    cfg = Config(timesteps=LANE_HOLD_T, sample_steps=LANE_HOLD_T, compute_dtype="float32")
    teacher, students = _lane_models(cfg)
    cfg_engine_update.launches = 0
    want = sweep_compare_trajectories(teacher, students, cfg, guidance_scales=MAIN_GS,
                                      num_samples=SAMPLES, base_seed=42, verbose=False)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return want, cfg_engine_update.launches


def _hold_train():
    """10(b)'s reference: the three float32 teacher steps unsharded."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.training.state import make_teacher_train_step

    saved = _tf32_off()
    cfg = Config(timesteps=TRAIN_T, sample_steps=TRAIN_T, compute_dtype="float32")
    step = make_teacher_train_step(get_diffusion_params(TRAIN_T, cfg), TRAIN_T)
    state = _lane_teacher_state(cfg, None)
    images = _lane_images()
    losses = [float(step(state, images[i].cuda())[1]) for i in range(LANE_STEPS)]
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return losses, {k: v.detach().cpu() for k, v in state.model.named_parameters()}


def _hold_spatial(workdir):
    """10(e)'s references: the unsharded forward and chain (float32, TF32
    off) and the unsharded 256x256 bf16 forward's peak memory."""
    import dataclasses

    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.trajectories import generate_trajectory
    from distillation_trajectories_torch.training import make_eval_model_fn
    from distillation_trajectories_torch.training.students import load_teacher

    saved = _tf32_off()
    cfg = Config(base_dir=workdir, compute_dtype="float32")
    teacher = load_teacher(cfg)
    x, t, c, noise = _spatial_inputs()
    with torch.no_grad():
        forward = make_eval_model_fn(teacher)(x.cuda(), t.cuda(), c.cuda(), c.cuda()).cpu()
    cfg_engine_update.launches = 0
    traj = generate_trajectory(teacher, noise, MAIN_T, seed=3, guidance_scale=3.0,
                               config=cfg).cpu()
    launches = cfg_engine_update.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", image_size=LANE_SPATIAL_PX)
    fn = make_eval_model_fn(load_teacher(cfg))
    big, tb, cb = _spatial_big()
    fn(big, tb, cb, cb)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn(big, tb, cb, cb)
    torch.cuda.synchronize()
    return dict(forward=forward, traj=traj, launches=launches,
                big_ms=(time.perf_counter() - t0) * 1e3,
                big_peak=torch.cuda.max_memory_allocated() - before)


def _close_metrics(label, got, want, rtol=1e-4, atol=1e-6):
    worst = 0.0
    for sf, roles in want.items():
        for gs, metrics in roles["student_metrics"].items():
            for k, v in metrics.items():
                g = got[sf]["student_metrics"][gs][k]
                if not np.isfinite(v) and not np.isfinite(g):
                    continue
                if not abs(g - v) <= atol + rtol * abs(v):
                    raise RuntimeError(f"{label}: sf={sf} gs={gs} {k}: {g} against {v}")
                worst = max(worst, abs(g - v) / max(abs(v), 1e-30))
    return worst


def _students_run(workdir, tag, compute_dtype, sweep_parallel):
    """``train_students`` {0.1, 0.5} from phase 5's teacher for 10 batches
    in a tree of its own, profiled (device activity only): wall s, device
    busy and window µs, and each student's epoch losses."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.training import students as port_students

    cfg = Config(base_dir=os.path.join(workdir, f"lanes_{tag}"), dataset="CIFAR10", epochs=1,
                 timesteps=TRAIN_T, sample_steps=TRAIN_T, limit_batches_per_epoch=10,
                 num_samples_to_generate=0, compute_dtype=compute_dtype).create_directories()
    shutil.copy(os.path.join(workdir, "output", "models", "teacher", "model_epoch_1.msgpack"),
                cfg.teacher_models_dir)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        port_students.train_students(cfg, custom_size_factors=list(STUDENTS), seed=0,
                                     sweep_parallel=sweep_parallel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, window = _busy_and_window(kernels) if kernels else (float("nan"),) * 2
    if sweep_parallel:
        recs = _jsonl_records(os.path.join(cfg.results_dir, "sweep_parallel_metrics.jsonl"))
        losses = {sf: [r["avg_loss"] for r in recs if r["size_factor"] == sf] for sf in STUDENTS}
    else:
        losses = {sf: _jsonl_losses(os.path.join(cfg.results_dir,
                                                 f"distill_metrics_size_{sf}.jsonl"))
                  for sf in STUDENTS}
    return dict(wall=wall, busy=busy, window=window, losses=losses)


def _sweep_parallel_runs(card, workdir):
    """10(d): ``train_students`` sequential and with ``sweep_parallel``
    (both students' streams on the one card): the losses held in float32
    with TF32 off (rtol 1e-4: the upsample's backward adds with atomics in
    no fixed order), then both timed in bf16 with the device's idle share."""
    saved = _tf32_off()
    hold = {mode: _students_run(workdir, f"f32_{mode}", "float32", mode)
            for mode in (False, True)}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for sf in STUDENTS:
        got, want = hold[True]["losses"][sf], hold[False]["losses"][sf]
        if len(got) != 1 or not np.allclose(got, want, rtol=1e-4, atol=0):
            raise RuntimeError(f"sweep_parallel sf={sf}: losses {got} against {want}")
    print(f"lanes (d) float32 losses, sweep_parallel against sequential: "
          f"{hold[True]['losses']} against {hold[False]['losses']} (rtol 1e-4) [{card}]")
    runs = {}
    for mode, label in ((False, "sequential"), (True, "sweep_parallel")):
        runs[label] = run = _students_run(workdir, f"bf16_{label}", "bfloat16", mode)
        print(f"lanes (d) {label}: students {list(STUDENTS)} from phase 5's teacher, 10 batches "
              f"of 128, bf16: wall {run['wall']:.3f} s (dataset, teacher load and checkpoints "
              f"included; profiler on, device activity only); device busy "
              f"{run['busy'] / 1e6:.3f} s of a {run['window'] / 1e6:.3f} s window, idle share "
              f"{1 - run['busy'] / run['window']:.3f}; losses {run['losses']} [{card}]")
    print(f"lanes (d) sweep_parallel / sequential wall: "
          f"{runs['sweep_parallel']['wall'] / runs['sequential']['wall']:.3f} [{card}]")


def _jsonl_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _jsonl_losses(path):
    return [r["avg_loss"] for r in _jsonl_records(path) if "avg_loss" in r]


def phase_lanes_multi(card, workdir):
    """Phase 10: the multi-device lanes on two ranks that share the card
    (gloo); returns the kernel launches of its runs, the ranks' included."""
    from distillation_trajectories_torch.models import variables_from_unet_state_dict
    from distillation_trajectories_torch.parallel.launch import spawn_ranks
    from distillation_trajectories_torch.training import load_checkpoint_sharded

    t_phase = time.perf_counter()
    want_sweep, parent_launches = _hold_sweep(card)
    want_losses, want_state = _hold_train()
    want_spatial = _hold_spatial(workdir)
    parent_launches += want_spatial["launches"]
    print(f"lanes: unsharded references {time.perf_counter() - t_phase:.1f} s [{card}]")

    t0 = time.perf_counter()
    ranks = spawn_ranks(2, _lane_rank, (workdir,), backend=None, timeout=600, threads=0)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"lanes: 2 ranks sharing the card, backend {r0['backend']}, {spawn_s:.1f} s in all "
          f"(sweep {r0['sweep_s']:.1f} s, training {r0['train_s']:.1f} s, spatial "
          f"{r0['spatial_s']:.1f} s); gloo all_gather of CUDA tensors: {r0['gather_probe']} "
          f"[{card}]")

    # (a) The data-sharded sweep.
    chains = len(MAIN_GS) * (1 + len(STUDENTS))
    for r, out in enumerate(ranks):
        worst = _close_metrics(f"lanes (a) rank {r}", out["sweep"]["hold"], want_sweep)
        if out["sweep"]["launches"] != (MAIN_T - 1) * chains:
            raise RuntimeError(f"rank {r}: {out['sweep']['launches']} launches in the sweep")
        for sf, roles in out["sweep"]["out"].items():
            for gs, metrics in roles["student_metrics"].items():
                bad = [k for k, v in metrics.items()
                       if not np.isfinite(v) and k != "trajectory_mse"]
                if bad or len(metrics) != 20:
                    raise RuntimeError(f"rank {r} sf={sf} gs={gs}: bad metrics {bad}")
        print(f"lanes (a) rank {r}: sharded sweep (2, 1), {SAMPLES // 2} of {SAMPLES} samples, "
              f"T={LANE_HOLD_T} float32 hold against the unsharded sweep: worst rel diff "
              f"{worst:.3e} (rtol 1e-4, atol 1e-6); bf16 T={MAIN_T}: "
              f"{out['sweep']['launches']} launches ({MAIN_T - 1} x {chains} chains), "
              f"{out['sweep']['seconds']:.3f} s, "
              f"{SAMPLES * chains / out['sweep']['seconds']:.2f} traj/s for the whole sweep "
              f"(two ranks sharing one card), peak {out['sweep']['peak'] / 2**30:.3f} GiB [{card}]")

    # (b) Training steps on (2, 1) and (1, 2).
    for shape in ((2, 1), (1, 2)):
        rec = r0["train"][shape]
        np.testing.assert_allclose(rec["losses"], want_losses, rtol=1e-4)
        worst = 0.0
        for k, v in want_state.items():  # the parameters, as JAX's _assert_spmd_parity
            got = rec["hold_state"][k]
            if not torch.allclose(got, v, rtol=2e-2, atol=5e-4):
                raise RuntimeError(f"lanes (b) {shape} {k}: max abs diff "
                                   f"{float((got - v).abs().max())} of max {float(v.abs().max())}")
            worst = max(worst, float((got - v).abs().max()))
        med = statistics.median(rec["times"])
        print(f"lanes (b) teacher step on {shape}: float32 losses {rec['losses']} against "
              f"{want_losses} (rtol 1e-4), worst parameter diff {worst:.3e} (rtol 2e-2, atol "
              f"5e-4; BatchNorm statistics not held: Adam's noise on the conv biases that "
              f"feed them moves their means); bf16 median step {med * 1e3:.3f} ms of {[round(t * 1e3, 3) for t in rec['times']]}, "
              f"{128 / med:.1f} images/s (two ranks sharing one card) [{card}]")
    local = r0["train"][(1, 2)]["local_shapes"]
    print("lanes (b) local shapes on (1, 2): " + ", ".join(
        f"{k} {local[k]} of {tuple(want_state[k].shape)}"
        for k in ("enc1.conv1.weight", "time_mlp.1.weight", "enc1.norm1.weight",
                  "final.weight")))

    # (c) The sharded checkpoint, read back here without a topology.
    t0 = time.perf_counter()
    payload = load_checkpoint_sharded(os.path.join(workdir, "lanes_ckpt"), 1)
    read_s = time.perf_counter() - t0
    want = variables_from_unet_state_dict(r0["train"][(1, 2)]["saved"])
    for col in ("params", "batch_stats"):
        _leaves_equal_np(payload[col], want[col])
    print(f"lanes (c) sharded checkpoint of the (1, 2) state: written by both ranks in "
          f"{r0['train'][(1, 2)]['write_s']:.3f} s, read whole in one process in {read_s:.3f} s, "
          f"equal bit for bit to gather_state_dict [{card}]")

    # (d) sweep_parallel on the one card.
    t0 = time.perf_counter()
    _sweep_parallel_runs(card, workdir)
    print(f"lanes (d): {time.perf_counter() - t0:.1f} s [{card}]")

    # (e) Spatial partitioning on (1, 2).
    rank_launches = 0
    for r, out in enumerate(ranks):
        sp = out["spatial"]
        fwd = compare(f"lanes (e) rank {r} spatial forward (1, 2), 8 x 32x32x3, float32",
                      sp["forward"], want_spatial["forward"], 2e-5, 2e-5, card)
        chain = compare(f"lanes (e) rank {r} spatial T={MAIN_T} CFG chain", sp["traj"],
                        want_spatial["traj"], 2e-4, 2e-4, card)
        if sp["launches"] != MAIN_T - 1 or not sp["big_finite"]:
            raise RuntimeError(f"rank {r}: spatial chain launches {sp['launches']}")
        print(f"lanes (e) rank {r}: forward max abs err {fwd:.3e}, chain {chain:.3e}, "
              f"{sp['launches']} launches; {LANE_SPATIAL_PX}x{LANE_SPATIAL_PX} batch-1 bf16 "
              f"forward: peak {sp['big_peak'] / 2**20:.1f} MiB above its inputs, "
              f"{sp['big_ms']:.3f} ms; unsharded {want_spatial['big_peak'] / 2**20:.1f} MiB, "
              f"{want_spatial['big_ms']:.3f} ms [{card}]")
        rank_launches += out["sweep"]["hold_launches"] + out["sweep"]["launches"] + sp["launches"]
    print(f"lanes: launches {parent_launches} (unsharded references) + {rank_launches} "
          f"(both ranks) in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return parent_launches + rank_launches


def _leaves_equal_np(a, b):
    if isinstance(a, dict):
        if set(a) != set(b):
            raise RuntimeError(f"checkpoint trees differ: {sorted(a)} against {sorted(b)}")
        for k in a:
            _leaves_equal_np(a[k], b[k])
    elif not np.array_equal(np.asarray(a), np.asarray(b)):
        raise RuntimeError("a sharded checkpoint leaf differs from the gathered state")


# --- Phase 11: the last entry points, on phase 5's outputs --------------------

CPU_RUN_ARGS = ("--epochs 1 --limit_batches 2 --dataset MNIST --image_size 16 "
                "--timesteps 10 --num_samples 0")


def phase_profile_sampler(card, workdir):
    """11(a): the sampler profiler at the JAX script's defaults (sf 1.0,
    batch 256, 32x32x3, T=50, guidance 3.0, bf16)."""
    from distillation_trajectories_torch.scripts import profile_sampler

    logdir = os.path.join(workdir, "profile")
    t0 = time.perf_counter()
    path, out = profile_sampler.capture(logdir)
    capture_s = time.perf_counter() - t0
    if tuple(out.shape) != (MAIN_T + 1, SAMPLES, 32, 32, 3) or not torch.isfinite(out).all():
        raise RuntimeError("the profiled chain's output is not finite or has the wrong shape")
    print(f"profile_sampler.capture (sf 1.0, batch {SAMPLES}, 32x32x3, T={MAIN_T}, gs "
          f"{profile_sampler.GUIDANCE}, bf16; one warm-up and three traced chains, CUDA "
          f"activity): {capture_s:.3f} s, trace {os.path.getsize(path)} bytes [{card}]")
    t0 = time.perf_counter()
    summary = profile_sampler.summarize(logdir, top=10)
    print(card)
    traced = summary.launches("cfg_engine_update_kernel")
    update_us = sum(t for name, _, t in summary.rows if "cfg_engine_update_kernel" in name)
    n_kernels = sum(n for _, n, _ in summary.rows)
    print(f"profile_sampler.summarize: {traced} launches of cfg_engine_update_kernel "
          f"(expected 3 x {MAIN_T - 1} = {3 * (MAIN_T - 1)}), {update_us / 1e3:.3f} ms "
          f"({update_us / max(traced, 1):.3f} us a launch, {update_us / summary.busy_us:.3%} of "
          f"the busy time); {n_kernels} device events "
          f"({n_kernels / 3:.0f} a chain), busy {summary.busy_us / 3e3:.3f} ms a chain, idle "
          f"share {summary.idle_share:.3f}; read in {time.perf_counter() - t0:.3f} s [{card}]")
    if not summary.on_device or traced != 3 * (MAIN_T - 1):
        raise RuntimeError("the profiler's table does not show the kernel once a step of "
                           "each traced chain")


def phase_smoke_suite(card):
    """11(b): the seven-stage smoke suite on the card."""
    from distillation_trajectories_torch.scripts import smoke_diffusion

    with tempfile.TemporaryDirectory() as base_dir:
        if not smoke_diffusion.run_tests("cuda", base_dir):
            raise RuntimeError("the smoke suite did not pass 7/7 on cuda")
    print(f"smoke suite: 7/7 on cuda [{card}]")


def phase_run_on_cpu(card, workdir):
    """11(c): ``run_on_cpu train_teacher`` in a child that must see no card,
    with this process's device memory unmoved."""
    from distillation_trajectories_torch import Config

    base = os.path.join(workdir, "cpu_run")
    cmd = [sys.executable, "-m", "distillation_trajectories_torch.scripts.run_on_cpu",
           "train_teacher", "--args", f"{CPU_RUN_ARGS} --base_dir {base}"]
    torch.cuda.synchronize()
    before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    after = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-6:])
    if proc.returncode != 0:
        raise RuntimeError(f"run_on_cpu train_teacher exited {proc.returncode}:\n{tail}")
    if "torch.cuda.is_available()=False" not in proc.stdout:
        raise RuntimeError(f"the dispatched child did not report that it saw no card:\n{tail}")
    ckpt = os.path.join(Config(base_dir=base).teacher_models_dir, "model_epoch_1.msgpack")
    if not (os.path.exists(ckpt) and os.path.getsize(ckpt) > 0):
        raise RuntimeError(f"run_on_cpu train_teacher wrote no checkpoint at {ckpt}")
    if after != before:
        raise RuntimeError(f"this process's device memory moved: (allocated, reserved) "
                           f"{before} -> {after}")
    print(f"run_on_cpu train_teacher ({CPU_RUN_ARGS}): exit 0 in {wall:.3f} s; the child "
          f"printed torch.cuda.is_available()=False; checkpoint {os.path.getsize(ckpt)} bytes; "
          f"this process's device memory (allocated, reserved) {before} bytes before and "
          f"after [{card}]")


def _write_png_pixels(path):
    """The pixels of a PNG ``write_png`` wrote (one IDAT, filter 0 rows),
    decoded with ``zlib`` alone."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise RuntimeError(f"{path} has filtered rows: not written by write_png")
    return rows[:, 1:].reshape(h, w, 3)


def phase_analyze_sample(card, workdir):
    """11(d): ``analyze_latest_sample`` on phase 5's ``samples_epoch_1.png``."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.scripts import analyze_latest_sample

    results_dir = Config(base_dir=workdir).results_dir
    grid = os.path.join(results_dir, "samples_epoch_1.png")
    got = analyze_latest_sample.run(results_dir)
    pixels = _write_png_pixels(grid)
    want = analyze_latest_sample.structure_score(pixels)
    if got is None or got["file"] != grid or not np.array_equal(got["image"], pixels):
        raise RuntimeError("analyze_latest_sample did not read phase 5's grid as written")
    if got["structure_score"] != want:
        raise RuntimeError(f"structure score {got['structure_score']!r} against {want!r} "
                           "from the zlib-decoded pixels")
    print(f"analyze_latest_sample: phase 5's grid {pixels.shape}, structure score "
          f"{want:.6f}, equal to numpy's on the zlib-decoded pixels [{card}]")


def phase_real_samples(card, workdir):
    """11(e): ``show_real_samples.run`` on the synthetic stand-in."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.data import get_real_images
    from distillation_trajectories_torch.scripts import show_real_samples
    from distillation_trajectories_torch.utils.viz import read_png

    cfg = Config(base_dir=os.path.join(workdir, "real"))
    path, images = show_real_samples.run(cfg)
    grid = read_png(path)
    if not (np.array_equal(images, get_real_images(cfg, 16)) and images.shape == (16, 32, 32, 3)
            and grid.shape == (4 * 34 + 2, 4 * 34 + 2, 3)):
        raise RuntimeError(f"show_real_samples: images {images.shape}, grid {grid.shape}")
    print(f"show_real_samples.run: 16 test images of the {cfg.dataset} stand-in, grid "
          f"{grid.shape} [{card}]")


def phase_last_entry_points(card, workdir):
    """Phase 11; returns the kernel's launches, checked against 11(a)'s
    warm-up and three traced chains (the smoke suite samples through
    ``p_sample_loop``, and the dispatched child runs on the CPU)."""
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update

    cfg_engine_update.launches = 0
    for label, run in (("(a) sampler profiler", lambda: phase_profile_sampler(card, workdir)),
                       ("(b) smoke suite", lambda: phase_smoke_suite(card)),
                       ("(c) run_on_cpu", lambda: phase_run_on_cpu(card, workdir)),
                       ("(d) latest-sample analysis", lambda: phase_analyze_sample(card, workdir)),
                       ("(e) real samples", lambda: phase_real_samples(card, workdir))):
        t0 = time.perf_counter()
        run()
        print(f"phase last entry points {label}: {time.perf_counter() - t0:.1f} s [{card}]")
    launches = cfg_engine_update.launches
    print(f"last entry points kernel launches: {launches} (expected 4 x {MAIN_T - 1} = "
          f"{4 * (MAIN_T - 1)})")
    if launches != 4 * (MAIN_T - 1):
        raise RuntimeError("phase 11 did not launch the kernel once a step of each chain")
    return launches


# --- Phase 12: the bench entry points, through each module's run ------------


def _bench_run(label, module, flags, expected, card):
    """``module.run`` on ``flags`` with the kernel's launches counted from 0:
    the record, after the launches are checked against ``expected(args)``
    and the record printed."""
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update

    args = module.parse_args(flags)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    cfg_engine_update.launches = 0
    t0 = time.perf_counter()
    record = module.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, want = cfg_engine_update.launches, expected(args)
    print(f"{label}: {' '.join(flags)}")
    print(json.dumps(record))
    print(f"{label}: {wall:.1f} s, {launches} kernel launches (expected {want} from its "
          f"arguments) [{card}]")
    if launches != want:
        raise RuntimeError(f"{label} launched the kernel {launches} times, not {want}")
    return record, launches


def _finite(label, *values):
    if not all(v is not None and np.isfinite(v) for v in values):
        raise RuntimeError(f"{label}: a value is not finite: {values}")


def phase_bench(card, workdir):
    """12(a): ``bench`` with the main path's workload, its ledger and
    baseline cache in the workdir."""
    from distillation_trajectories_torch.scripts import bench

    ledger = os.path.join(workdir, "bench_ledger.jsonl")
    with mock.patch.multiple(bench, LEDGER=ledger,
                             CACHE=os.path.join(workdir, "bench_baseline.json")):
        rec, launches = _bench_run(
            "bench", bench, [], lambda a: (1 + a.iters) * (a.timesteps - 1), card)
    with open(ledger) as f:
        lines = f.read().splitlines()
    if rec["preflight"]["status"] != "ok" or rec["card"] != card or len(lines) != 1:
        raise RuntimeError(f"bench: preflight {rec['preflight']}, card {rec['card']!r}, "
                           f"{len(lines)} ledger lines")
    if rec["use_pallas"] is not True or json.loads(lines[0])["use_pallas"] is not True:
        raise RuntimeError("bench did not record its update tail (use_pallas true)")
    _finite("bench", rec["value"], rec["pairs_per_s"], rec["vs_baseline"], *rec["seconds"])
    print(f"bench: {rec['value']} traj/s (calls {rec['seconds']} s), {rec['pairs_per_s']} "
          f"pairs/s, x{rec['vs_baseline']} {rec['baseline_source']}; update tail "
          f"use_pallas={rec['use_pallas']} (record and ledger line) [{card}]")
    return launches + _bench_method_split(card)


class _PreDrawn:
    """``BenchDraws`` with each seed's step noise drawn ahead of the timed
    calls: the timing then holds the chain alone.  ``seconds`` holds each
    seed's draw, timed alone between synchronizations."""

    def __init__(self, draws, seeds, timesteps, shape):
        self.noise, self.uniforms = draws.noise, draws.uniforms
        self.steps, self.seconds = {}, []
        for seed in seeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.steps[seed] = draws.step_noise(seed, timesteps, shape)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)

    def step_noise(self, seed, timesteps, shape):
        return self.steps[seed]


def _bench_method_split(card, turns=2):
    """``bench_main_path`` at its defaults, in turns with its step noise
    drawn inside each timed call (as ``bench`` and the JAX bench draw it)
    and before it: the traj/s of each from the mean call (``bench``'s
    method) and from the best call (phase 4's); returns the launches."""
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.scripts import bench
    from distillation_trajectories_torch.scripts._common import BenchDraws

    args = bench.parse_args([])
    shape = (args.batch, args.image_size, args.image_size, 3)
    draws = BenchDraws("cuda")
    before = cfg_engine_update.launches
    seconds, draw_s = {"inside": [], "before": []}, []
    for _ in range(turns):
        for label in seconds:
            pre = (None if label == "inside" else
                   _PreDrawn(draws, range(args.iters + 1), args.timesteps, shape))
            seconds[label] += bench.bench_main_path(args, pre)[1]
            draw_s += pre.seconds[1:] if pre else []  # seed 0's draw is the warm-up's
            del pre
    launches = cfg_engine_update.launches - before
    want = 2 * turns * (1 + args.iters) * (args.timesteps - 1)
    rate = {label: (args.batch * len(s) / sum(s), args.batch / min(s))
            for label, s in seconds.items()}
    print(f"bench method split ({turns} turns of {args.iters} timed chains each, batch "
          f"{args.batch}, T={args.timesteps}): step noise drawn inside the timed call "
          f"{rate['inside'][0]:.3f} traj/s from the mean call, {rate['inside'][1]:.3f} from the "
          f"best; drawn before {rate['before'][0]:.3f} / {rate['before'][1]:.3f}; one chain's "
          f"draw alone {statistics.median(draw_s) * 1e3:.3f} ms (median of {len(draw_s)}, "
          f"{min(draw_s) * 1e3:.3f}-{max(draw_s) * 1e3:.3f}); calls (s) "
          f"{ {k: [round(x, 4) for x in v] for k, v in seconds.items()} }; {launches} kernel "
          f"launches (expected {want}) [{card}]")
    _finite("bench method split", *(x for r in rate.values() for x in r))
    if launches != want:
        raise RuntimeError(f"bench method split launched the kernel {launches} times, not {want}")
    return launches


# The kernel's bf16 chain against the plain tail's (batch 256, T=50, gs 7.5):
# both compute the same float32 update and differ in rounding alone (phase 3
# holds them within 2e-5 / 1e-5 on a float32 chain); a rounding difference in
# the carry reaches the later bf16 forwards, so the chains spread further here.
# The limit is ten times the 9.465e-4 this comparison read on an H100
# (700 W) before it was held.
PALLAS_CHAIN_ATOL = 1e-2


def phase_bench_r2(card, workdir):
    """12(b): ``bench_r2`` pallas, ablate (batch 256) and paradigms (B=1,
    the full 3x3 grid of windows and tolerances)."""
    from distillation_trajectories_torch.scripts import bench_r2

    flags = ["--exp", "pallas,ablate,paradigms", "--base_dir", workdir]
    out, launches = _bench_run(
        "bench_r2", bench_r2, flags,
        lambda a: (2 + a.iters + 2 * (1 + a.iters) + 2 + a.iters) * (a.timesteps - 1), card)
    pallas, ablate, par = out["pallas"], out["ablate"], out["paradigms"]
    _finite("bench_r2", pallas["max_abs_deviation"], pallas["speedup"], ablate["mfu_vs_bf16_peak"],
            *(r["max_abs_dev_vs_exact"] for r in par["rows"]))
    if len(par["rows"]) != 9 or not 0 < ablate["mfu_vs_bf16_peak"] < 1:
        raise RuntimeError(f"bench_r2: {len(par['rows'])} window rows, "
                           f"MFU {ablate['mfu_vs_bf16_peak']}")
    print(f"bench_r2 pallas (batch 256, gs 7.5, T=50, bf16), the plain tail: "
          f"{pallas['jnp_seconds']} s a chain = {pallas['traj_per_s_jnp']} traj/s "
          f"(calls {[round(x, 4) for x in pallas['jnp_call_seconds']]}) [{card}]")
    print(f"bench_r2 pallas (batch 256, gs 7.5, T=50, bf16), the Triton kernel: "
          f"{pallas['pallas_seconds']} s a chain = {pallas['traj_per_s_pallas']} traj/s "
          f"(calls {[round(x, 4) for x in pallas['pallas_call_seconds']]}); x{pallas['speedup']} "
          f"the plain tail, max abs deviation {pallas['max_abs_deviation']:.3e} (limit "
          f"{PALLAS_CHAIN_ATOL:g}) [{card}]")
    if not pallas["max_abs_deviation"] <= PALLAS_CHAIN_ATOL:
        raise RuntimeError("bench_r2 pallas: the kernel's chain left the plain tail's by "
                           f"{pallas['max_abs_deviation']:.3e}")
    print(f"bench_r2 ablate (batch 256, gs 3.0): {ablate['ms_per_step_full']} ms a step, two "
          f"forwards {ablate['two_fwd_share']}, upsample {ablate['upsample_cost_share']}, tail "
          f"{ablate['update_tail_share']} of the chain; {ablate['per_step_flops']} conv FLOPs a "
          f"step, MFU {ablate['mfu_vs_bf16_peak']} of 989 TFLOP/s [{card}]")
    print(f"bench_r2 paradigms (B=1, gs 7.5): sequential {par['sequential_seconds']} s; " + "; ".join(
        f"W={r['window']} tol={r['tol']:g}: {r['sweeps_at_seed3']} sweeps, {r['seconds']} s, "
        f"x{r['speedup_vs_scan']}, gap {r['max_abs_dev_vs_exact']:.2e}" for r in par["rows"])
        + f" [{card}]")
    return launches


def phase_bench_quant(card, workdir):
    """12(c): ``bench_quant --use_checkpoint`` on phase 5's teacher."""
    from distillation_trajectories_torch.scripts import bench_quant

    rec, launches = _bench_run(
        "bench_quant", bench_quant, ["--use_checkpoint", "--base_dir", workdir],
        lambda a: (len(a.arm_list) * (1 + a.iters) + 1) * (a.timesteps - 1), card)
    arms = rec["arms"]
    if rec["weights"] != "teacher-checkpoint" or set(arms) != set(bench_quant.ALL_ARMS):
        raise RuntimeError(f"bench_quant: weights {rec['weights']!r}, arms {sorted(arms)}")
    n = arms["int8"]["census"]["convs"]
    if not (arms["int8"]["census"]["int8_convs"] == n - 1
            and 0 < arms["int8_static_mixed"]["census"]["int8_convs"] < n - 1):
        raise RuntimeError(f"bench_quant: int8 census {[arms[a].get('census') for a in arms]}")
    _finite("bench_quant", *(a["traj_per_s"] for a in arms.values()),
            *(a["endpoint_rel_l2"] for k, a in arms.items() if k != "float"))
    print("bench_quant arms (phase 5's teacher, 256 x 32x32x3, T=50, gs 3.0): " + "; ".join(
        f"{k} {a['traj_per_s']} traj/s" + (f" x{a['speedup_vs_float']}, endpoint rel L2 "
                                           f"{a['endpoint_rel_l2']:.5f}" if k != "float" else "")
        for k, a in arms.items()) + f"; best {rec['int8_mode']} [{card}]")
    return launches


def _progressive_launches(a):
    t, s = a.timesteps - 1, (a.timesteps >> a.rounds) - 1
    sweep = len(a.w_sweep.split(",")) if a.guidance_range and a.w_sweep else 0
    return (a.iters + 1) * (t + s) + (1 + sweep + (a.fid_samples > 0)) * (t + s)


def phase_bench_progressive(card, workdir):
    """12(d): ``bench_progressive --measure_only`` on phase 8(c)'s plain
    steps_25 and guided steps_50 students."""
    from distillation_trajectories_torch.scripts import bench_progressive

    launches = 0
    for label, flags in (
        ("bench_progressive plain", ["--timesteps", str(TRAIN_T), "--rounds", "2"]),
        ("bench_progressive guided", ["--timesteps", str(TRAIN_T), "--rounds", "1",
                                      "--guidance_range", ",".join(map(str, PROG_GUIDANCE)),
                                      "--w_sweep", "1.0,3.0,5.0"]),
    ):
        rec, n = _bench_run(label, bench_progressive,
                            flags + ["--measure_only", "--base_dir", workdir],
                            _progressive_launches, card)
        launches += n
        tp, q = rec["throughput"], rec["quality"]
        _finite(label, *(v["traj_per_s"] for v in tp.values()), q["endpoint_mse"],
                *(v["endpoint_mse"] for v in q.get("w_sweep", {}).values()))
        t, s = str(rec["teacher_steps"]), str(rec["final_steps"])
        print(f"{label}: teacher T={t} {tp[t]['traj_per_s']} traj/s, student T={s} "
              f"{tp[s]['traj_per_s']} traj/s (x{tp[s]['traj_per_s'] / tp[t]['traj_per_s']:.2f}); "
              f"endpoint MSE {q['endpoint_mse']:.4g} [{card}]")
    return launches


def _fast_launches(a):
    t, s = a.teacher_steps - 1, a.student_steps - 1
    arms = a.arms.split(",")
    sweep = len(a.w_sweep.split(",")) if a.w_sweep else 0
    return ((a.iters + 2) * t + any(x.startswith("int8_static") for x in arms) * s
            + len(arms) * (a.iters + 2) * s + (sweep + (a.fid_samples > 0)) * (t + s))


def phase_bench_fast(card, workdir):
    """12(e): ``bench_fast`` on phase 5's teacher (T=100) and phase 8(c)'s
    guided steps_50 student, FID on 64 samples."""
    from distillation_trajectories_torch.scripts import bench_fast

    rec, launches = _bench_run(
        "bench_fast", bench_fast,
        ["--teacher_steps", str(TRAIN_T), "--student_steps", str(TRAIN_T // 2),
         "--fid_samples", "64", "--base_dir", workdir], _fast_launches, card)
    arms = rec["arms"]
    if len(arms) != 5 or rec["fid_features"] != "seeded-random":
        raise RuntimeError(f"bench_fast: arms {sorted(arms)}, features {rec['fid_features']}")
    _finite("bench_fast", *(a["traj_per_s"] for a in arms.values()), rec["fid_teacher_vs_best"],
            *(a["endpoint_mse_vs_teacher"] for k, a in arms.items() if k.startswith("student")),
            *(v["endpoint_mse"] for v in rec["w_sweep_best_arm"].values()))
    print("bench_fast (phase 5's teacher T=100 CFG vs the guided student T=50): " + "; ".join(
        f"{k} {a['traj_per_s']} traj/s" + (f" x{a['speedup_vs_teacher']}, endpoint MSE "
                                           f"{a['endpoint_mse_vs_teacher']:.4g}"
                                           if k.startswith("student") else "")
        for k, a in arms.items()) + f"; best {rec['best_arm']}, FID {rec['fid_teacher_vs_best']:.4g} "
        f"(self floor {rec.get('fid_teacher_self_floor', float('nan')):.4g}) [{card}]")
    return launches


def phase_benches(card, workdir):
    """Phase 12; returns the kernel's launches, each bench's checked
    against the count its arguments give."""
    launches = 0
    for label, run in (("(a) bench", phase_bench), ("(b) bench_r2", phase_bench_r2),
                       ("(c) bench_quant", phase_bench_quant),
                       ("(d) bench_progressive", phase_bench_progressive),
                       ("(e) bench_fast", phase_bench_fast)):
        t0 = time.perf_counter()
        launches += run(card, workdir)
        print(f"phase benches {label}: {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


# --- Phase 13: the trainers' default lanes on the card ------------------------

EPOCH_HOLD_IMAGES = 64  # 13(a): 8 batches of 8 an epoch
EPOCH_HOLD_EPOCHS = 2
EPOCH_TURNS = ("loop", "graph", "graph", "loop")  # 13(b)
GROUP_SIZES = (0.01, 0.05, 0.1)  # 13(c): 0.01 and 0.05 floor to one U-Net
GROUP_BATCHES = 10


def _hold_weights(label, got_model, want_model, steps, lr, rel_limit=5e-3):
    """Two trainings' weights from one seed.  The upsample's backward adds
    with atomics in no fixed order, and Adam's first steps turn that
    rounding into moves of about ±lr on weights whose gradient is near 0,
    so two eager per-batch runs differ too (13(a) prints by how much).
    Each tensor is held to a relative norm difference of ``rel_limit``
    (5e-3) and each weight to 2.2 x ``steps`` x ``lr`` (in its first 16
    steps Adam (0.9, 0.999) moves a weight by at most 1.1 lr a step),
    except the conv biases that feed a BatchNorm (true gradient 0, so they
    follow the rounding alone), held to the second only.  Returns the worst relative
    norm difference and the worst single difference."""
    worst_rel, worst_abs, want = 0.0, 0.0, dict(want_model.named_parameters())
    with torch.no_grad():
        for name, p in got_model.named_parameters():
            diff = (p - want[name]).abs()
            worst_abs = max(worst_abs, float(diff.max()))
            if float(diff.max()) > 2.2 * steps * lr:
                raise RuntimeError(f"{label}: {name} moved {float(diff.max())} apart in {steps} "
                                   "steps, beyond what Adam can")
            if not name.endswith(("conv1.bias", "conv2.bias")):
                rel = float(diff.norm() / want[name].norm())
                if rel > rel_limit:
                    raise RuntimeError(f"{label}: {name} differs by {rel} of its norm")
                worst_rel = max(worst_rel, rel)
    return worst_rel, worst_abs


def _hold_epoch_lane(card):
    """13(a): the teacher's graph-replayed epoch lane against the eager
    per-batch loop from one seed, float32, TF32 off, cuDNN deterministic,
    sf 0.1, 16x16x1, batch 8, T=10, dropout 0.3, two epochs of 8 batches;
    the loop runs twice, and how far it lands from itself is printed
    beside the graph's distance to it.  The draw generators must end in
    the same state (the replays advance them as the eager steps do).
    Tolerances: each step's loss at rtol 1e-5, the weights as
    :func:`_hold_weights` holds them."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.data.datasets import DataLoader
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training.loop import run_train_epoch
    from distillation_trajectories_torch.training.state import (
        TorchDraws,
        create_train_state,
        make_teacher_epoch_fn,
        make_teacher_train_step,
    )

    saved, det = _tf32_off(), torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cfg = Config(image_size=16, channels=1, batch_size=8, timesteps=10, sample_steps=10,
                 compute_dtype="float32", dropout=0.3)
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (EPOCH_HOLD_IMAGES, 16, 16, 1)).astype(np.float32)
    labels = np.zeros(EPOCH_HOLD_IMAGES, np.int32)
    dp = get_diffusion_params(10)
    runs = {}
    for run in ("graph", "loop", "loop again"):
        graph = run == "graph"
        state = create_train_state(make_unet(cfg, 0.1, seed=3), cfg, TorchDraws(11, "cuda"),
                                   use_ema=True)
        loader = DataLoader(images, labels, 8, shuffle=True, seed=7)
        fn = (make_teacher_epoch_fn if graph else make_teacher_train_step)(dp, 10, ema_rate=0.999)
        dataset = torch.from_numpy(images).cuda()
        losses = []
        for _ in range(EPOCH_HOLD_EPOCHS):
            state, l, _ = run_train_epoch(
                state, train_step=fn, loader=loader, config=cfg, device="cuda",
                progress_desc="", log_label="", log_every=0, use_scan=graph,
                epoch_fn=fn, dataset_dev=dataset, reduce_loss=False)
            losses.append(l)
        torch.cuda.synchronize()
        if graph and not isinstance(fn.captured[0].graph, torch.cuda.CUDAGraph):
            raise RuntimeError("13(a): the epoch lane captured no CUDA graph")
        runs[run] = (np.concatenate(losses), state)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    torch.backends.cudnn.deterministic = det
    steps = EPOCH_HOLD_EPOCHS * EPOCH_HOLD_IMAGES // 8
    want_losses, want = runs["loop"]
    spread = {}
    for run in ("graph", "loop again"):
        losses, state = runs[run]
        if state.step != steps:
            raise RuntimeError(f"13(a): {run} took {state.step} steps, not {steps}")
        if not torch.equal(state.draws.generator.get_state(), want.draws.generator.get_state()):
            raise RuntimeError(f"13(a): the {run} left the draw generator elsewhere than the loop")
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, err_msg=run)
        spread[run] = (float(np.max(np.abs(losses - want_losses) / np.abs(want_losses))),
                       *_hold_weights(f"13(a) {run}", state.model, want.model, steps, cfg.lr))
    print(f"13(a) teacher epoch lane, graph replayed against the eager per-batch loop (f32, TF32 "
          f"off, cuDNN deterministic, sf 0.1, 16x16x1, batch 8, T=10, dropout 0.3, "
          f"{EPOCH_HOLD_EPOCHS} epochs of {EPOCH_HOLD_IMAGES // 8} batches, 2 warm-up steps then "
          f"replays): " + "; ".join(
              f"{run}: {steps} step losses within rel {l:.3e} (rtol 1e-5), weights within rel norm "
              f"{r:.3e} (5e-3) and abs {a:.3e} (2.2 x {steps} x lr)"
              for run, (l, r, a) in spread.items())
          + f"; draw generator states equal [{card}]")


def _idle_share(run, n):
    """The device's idle share over ``n`` calls of ``run`` under the
    profiler (device activity only), and its busy ms a call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return None, None, 0
    busy, window = _busy_and_window(kernels)
    return 1 - busy / window, busy / 1e3 / n, len(kernels) // n


def _time_lane(lane, cfg, loader, dataset, dp):
    """13(b): one epoch of ``TRAIN_BATCHES`` through one lane from a fresh
    seeded teacher, then ten more synchronized steps timed one by one and
    four profiled."""
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training.loop import run_train_epoch
    from distillation_trajectories_torch.training.state import (
        TorchDraws,
        create_train_state,
        make_teacher_epoch_fn,
        make_teacher_train_step,
    )

    state = create_train_state(make_unet(cfg, 1.0, seed=0), cfg, TorchDraws(0, "cuda"))
    fn = (make_teacher_epoch_fn if lane == "graph" else make_teacher_train_step)(dp, cfg.timesteps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses, n = run_train_epoch(
        state, train_step=fn, loader=loader, config=cfg, device="cuda", progress_desc="",
        log_label="", log_every=0, use_scan=lane == "graph", epoch_fn=fn, dataset_dev=dataset,
        reduce_loss=False)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    if n != TRAIN_BATCHES or not np.isfinite(losses).all():
        raise RuntimeError(f"13(b) {lane}: {n} steps, losses {losses}")
    if lane == "graph":
        captured = fn.captured[0]
        captured.i.zero_()  # replays below read the epoch's first rows again
        step, capture_s = captured.graph.replay, captured.capture_s
    else:
        images = dataset[:cfg.batch_size]
        step, capture_s = (lambda: fn(state, images)), None
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    idle, busy_ms, kernels = _idle_share(step, 4)
    return dict(epoch_s=epoch_s, med=statistics.median(times), capture_s=capture_s, idle=idle,
                busy_ms=busy_ms, kernels=kernels, peak=torch.cuda.max_memory_allocated(),
                reserved=torch.cuda.memory_reserved(), loss=(float(losses[0]), float(losses[-1])))


def _time_epoch_lanes(card):
    """13(b): the teacher at full width (sf 1.0, the synthetic CIFAR-shaped
    set, batch 128, T=100, bf16, dropout 0.3), ``TRAIN_BATCHES`` batches,
    per-batch loop and graph-replayed epoch lane in turns."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.data.datasets import DataLoader, load_dataset
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.training.loop import upload_dataset

    cfg = Config(dataset="CIFAR10", timesteps=TRAIN_T, sample_steps=TRAIN_T,
                 limit_batches_per_epoch=TRAIN_BATCHES)
    images, labels = load_dataset(cfg)
    loader = DataLoader(images, labels, cfg.batch_size, shuffle=True, seed=0)
    t0 = time.perf_counter()
    dataset = upload_dataset(loader, "cuda")
    upload_s = time.perf_counter() - t0
    print(f"13(b) dataset upload: {dataset.numel() * 4} bytes ({tuple(dataset.shape)} float32) "
          f"in {upload_s:.4f} s = {dataset.numel() * 4 / upload_s / 1e9:.3f} GB/s [{card}]")
    dp = get_diffusion_params(cfg.timesteps, cfg)
    runs = {"loop": [], "graph": []}
    for lane in EPOCH_TURNS:
        runs[lane].append(_time_lane(lane, cfg, loader, dataset, dp))
    for lane, recs in runs.items():
        for i, r in enumerate(recs):
            idle = "not measured" if r["idle"] is None else f"{r['idle']:.3f}"
            print(f"13(b) teacher {lane} turn {i + 1} (sf 1.0, batch {cfg.batch_size}, T={TRAIN_T}, "
                  f"bf16, dropout {cfg.dropout}): epoch of {TRAIN_BATCHES} batches {r['epoch_s']:.3f} s "
                  f"({cfg.batch_size * TRAIN_BATCHES / r['epoch_s']:.1f} images/s"
                  + (f", capture {r['capture_s']:.3f} s and 2 warm-up steps included" if
                     r["capture_s"] is not None else "")
                  + f"); median synchronized step {r['med'] * 1e3:.3f} ms "
                  f"({cfg.batch_size / r['med']:.1f} images/s); profiled 4 steps: device busy "
                  f"{r['busy_ms']:.3f} ms a step, {r['kernels']} kernels a step, idle share {idle}; "
                  f"peak allocated {r['peak']} bytes = {r['peak'] / 2**30:.3f} GiB, reserved "
                  f"{r['reserved'] / 2**30:.3f} GiB (the graph's pool included); loss "
                  f"{r['loss'][0]:.5f} -> {r['loss'][1]:.5f} [{card}]")
    loop = statistics.median(r["med"] for r in runs["loop"])
    graph = statistics.median(r["med"] for r in runs["graph"])
    print(f"13(b) median step, loop {loop * 1e3:.3f} ms against graph {graph * 1e3:.3f} ms: "
          f"graph / loop {graph / loop:.3f} [{card}]")


def _group_run(workdir, vmap_students):
    """13(c): ``train_students`` on ``GROUP_SIZES`` from phase 5's teacher,
    ``GROUP_BATCHES`` batches, float32 with TF32 off; the groups it formed,
    each student's epoch losses and seconds, the trained models, and the
    epoch functions it made (in the order it made them)."""
    import shutil

    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.training import students as port_students

    tag = "group" if vmap_students else "sequential"
    cfg = Config(base_dir=os.path.join(workdir, f"epoch_lanes_{tag}"), dataset="CIFAR10",
                 epochs=1, timesteps=TRAIN_T, sample_steps=TRAIN_T,
                 limit_batches_per_epoch=GROUP_BATCHES, num_samples_to_generate=0,
                 compute_dtype="float32", vmap_students=vmap_students).create_directories()
    shutil.copy(os.path.join(workdir, "output", "models", "teacher", "model_epoch_1.msgpack"),
                cfg.teacher_models_dir)
    groups, run_group, fns = [], port_students._distill_group, []

    def record(teacher, config, size_factors, *args, **kwargs):
        groups.append(list(size_factors))
        return run_group(teacher, config, size_factors, *args, **kwargs)

    def kept(factory):
        def make(*args, **kwargs):
            fns.append(factory(*args, **kwargs))
            return fns[-1]
        return make

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(port_students, "_distill_group", record), \
            mock.patch.object(port_students, "make_distill_epoch_fn",
                              kept(port_students.make_distill_epoch_fn)), \
            mock.patch.object(port_students, "make_multi_distill_epoch_fn",
                              kept(port_students.make_multi_distill_epoch_fn)):
        models = port_students.train_students(cfg, custom_size_factors=list(GROUP_SIZES), seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recs = {sf: _jsonl_records(os.path.join(cfg.results_dir, f"distill_metrics_size_{sf}.jsonl"))
            for sf in GROUP_SIZES}
    return dict(groups=groups, wall=wall, models=models, fns=fns,
                losses={sf: [r["avg_loss"] for r in v] for sf, v in recs.items()},
                seconds={sf: [r["seconds"] for r in v] for sf, v in recs.items()})


def _hold_student_group(card, workdir):
    """13(c): the student group against ``vmap_students=False``.  Each
    member runs the sequential step's kernels on its row of the stacked
    weights, but the upsample's backward adds with atomics in no fixed
    order (on the CPU the two agree bit for bit): epoch losses at the JAX
    contract's rtol 1e-5, weights as :func:`_hold_weights` holds them, with
    a relative norm limit of 2e-2 (the tiny students' small tensors move
    further apart in relative norm than the teacher's); the BatchNorm
    statistics, whose means carry the drifting biases, are not held."""
    saved = _tf32_off()
    group, seq = _group_run(workdir, True), _group_run(workdir, False)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    if group["groups"] != [[0.01, 0.05]] or seq["groups"]:
        raise RuntimeError(f"13(c): groups {group['groups']} and {seq['groups']}")
    worst_loss, worst_rel, worst_abs = 0.0, 0.0, 0.0
    for sf in GROUP_SIZES:
        np.testing.assert_allclose(group["losses"][sf], seq["losses"][sf], rtol=1e-5)
        worst_loss = max(worst_loss, abs(group["losses"][sf][0] - seq["losses"][sf][0])
                         / abs(seq["losses"][sf][0]))
        rel, d = _hold_weights(f"13(c) sf {sf}", group["models"][sf], seq["models"][sf],
                               GROUP_BATCHES, 1e-4, rel_limit=2e-2)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, d)
    print(f"13(c) train_students {list(GROUP_SIZES)} from phase 5's teacher, {GROUP_BATCHES} "
          f"batches of 128, T={TRAIN_T}, f32 with TF32 off: group {group['groups']} as one step, "
          f"0.1 alone; per-member epoch losses {group['losses']} against vmap_students=False "
          f"{seq['losses']} (rtol 1e-5, worst rel {worst_loss:.3e}); weights within rel norm "
          f"{worst_rel:.3e} (2e-2) and abs {worst_abs:.3e} (2.2 x {GROUP_BATCHES} x lr); "
          f"BatchNorm statistics not held [{card}]")
    print(f"13(c) epoch seconds (capture and warm-up included): group (0.01, 0.05) "
          f"{group['seconds'][0.01][0]:.3f} s against sequential 0.01 "
          f"{seq['seconds'][0.01][0]:.3f} s + 0.05 {seq['seconds'][0.05][0]:.3f} s = "
          f"{seq['seconds'][0.01][0] + seq['seconds'][0.05][0]:.3f} s; 0.1 alone "
          f"{group['seconds'][0.1][0]:.3f} s and {seq['seconds'][0.1][0]:.3f} s; train_students "
          f"wall {group['wall']:.3f} s against {seq['wall']:.3f} s [{card}]")
    # Steady state, after the holds (a replay trains on): each graph
    # replayed 5 times from its epoch's first row, synchronized.
    (g01, g1), (s01, s05, s1) = ([_replay_ms(fn) for fn in run["fns"]] for run in (group, seq))
    print(f"13(c) steady replay (median of 5): group (0.01, 0.05) {g01:.3f} ms against "
          f"sequential 0.01 {s01:.3f} ms + 0.05 {s05:.3f} ms = {s01 + s05:.3f} ms; 0.1 "
          f"{g1:.3f} and {s1:.3f} ms [{card}]")


def _replay_ms(epoch_fn, n=5):
    captured = epoch_fn.captured[0]
    captured.i.zero_()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        captured.graph.replay()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_epoch_lanes(card, workdir):
    """Phase 13: the trainers' default lanes on the card."""
    for label, run in (("(a) hold", lambda: _hold_epoch_lane(card)),
                       ("(b) timed turns", lambda: _time_epoch_lanes(card)),
                       ("(c) student group", lambda: _hold_student_group(card, workdir))):
        t0 = time.perf_counter()
        run()
        print(f"phase epoch lanes {label}: {time.perf_counter() - t0:.1f} s [{card}]")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check needs "
              "a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distillation_trajectories_torch  # noqa: F401  (fails outside the repo)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    record = phase_kernel(card)
    print(f"phase kernel: {time.perf_counter() - t0:.1f} s (Triton build included)")
    t0 = time.perf_counter()
    phase_sampler(card)
    print(f"phase sampler: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = phase_main_path(card)
    print(f"phase main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_check()
    with tempfile.TemporaryDirectory() as workdir:
        phase_train_main(card, workdir)
        print(f"phase training: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cli_launches = phase_analysis(card, workdir)
        print(f"phase analysis: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        clis_launches = phase_clis(card, workdir)
        print(f"phase CLIs: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        edit_launches = phase_edit(card, workdir)
        print(f"phase editing/progressive: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        lane_launches = phase_lanes(card, workdir)
        print(f"phase lanes: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        multi_launches = phase_lanes_multi(card, workdir)
        print(f"phase multi-device lanes: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        last_launches = phase_last_entry_points(card, workdir)
        print(f"phase last entry points: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        bench_launches = phase_benches(card, workdir)
        print(f"phase benches: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        phase_epoch_lanes(card, workdir)
        print(f"phase epoch lanes: {time.perf_counter() - t0:.1f} s [{card}]")
    total = (launches + cli_launches + clis_launches + edit_launches + lane_launches
             + multi_launches + last_launches + bench_launches)
    print(f"cfg_engine_update launches: {launches} (main path, phase 4) + {cli_launches} "
          f"(CFG-sweep CLI, phase 6) + {clis_launches} (analysis CLIs, phase 7) + "
          f"{edit_launches} (editing demo, phase 8) + {lane_launches} (the window dispatch's "
          f"sequential chain, phase 9) + {multi_launches} "
          f"(sharded sweep and spatial chains, both ranks, and their references, phase 10) + "
          f"{last_launches} (sampler profiler's warm-up and traced chains, phase 11) + "
          f"{bench_launches} (the five benches, phase 12) = {total}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "cfg_engine_update",
        "route": "triton",
        "source": "distillation_trajectories_torch/ops/cfg_update_triton.py",
        "replaces": "distillation_trajectories_tpu/ops/cfg_update.py:30",
        "launches": total,
        **record,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
