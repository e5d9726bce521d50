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
3. the sampler with the kernel tail against the plain tail on the card
   (float32, TF32 off, sf 0.1, T=10), and a small sweep on the card
   against the same sweep on the CPU;
4. the main path: ``sweep_compare_trajectories`` with the sf-1.0 teacher
   and students {0.1, 0.5} (seeded random weights), 32x32x3, 256 samples,
   T=50, guidance scales (1.0, 3.0), bf16 compute — with the kernel's
   launch count checked, metrics checked finite, and traj/s, pairs/s and
   peak memory printed;
5. training: one teacher step and one distillation step on the card
   against the CPU (float32, TF32 off, sf 0.1, 16x16x1, batch 8, T=10,
   dropout 0, shared weights and draws); then ``train_teacher`` at full
   width (sf 1.0, the synthetic CIFAR-shaped set, batch 128, T=100, bf16,
   dropout 0.3, one epoch of 30 batches, a checkpoint and a 16-sample grid
   written to a temporary directory) and ``train_students`` for
   sf {0.1, 0.5} from that checkpoint — with step times, images/s,
   checkpoint and grid times, peak memory and a profiler breakdown of
   teacher steps (forward, backward, optimizer) printed, and a failure
   when a loss is not finite or does not fall, the checkpoint read back
   does not reproduce the trained model, or anything ran on the CPU;
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
   and stamped ``seeded-random``, with sampling, feature and Fréchet
   seconds, images/s, peak memory and the device time of one batch-32
   trunk forward against its FLOP bound.  Nothing here imports matplotlib;
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
   back, then the students' chains at 256 x 32x32x3 (the plain steps_25
   student, the guided steps_50 student at w=3 in one forward a step; 73
   launches) beside phase 4's teacher CFG chain;
9. the sampler's opt-in lanes, migration and the orchestrator, on phase 5's
   checkpoints: (a) ``int8_matmul`` (``torch._int_mm``, zero-padded) on the
   card against the exact product, ``_qconv`` card vs CPU bit for bit and
   the int8 forward card vs CPU (float32, TF32 off); then the arms of
   ``scripts/bench_quant.py`` (float, fold, int8, int8_static,
   int8_static_mixed) as T=50 CFG chains of 256 x 32x32x3 from the sf-1.0
   teacher in bf16, with traj/s, peak memory and the endpoint's relative L2
   against float (49 launches a chain), and each Block conv's int8 time
   beside the bf16 cuDNN conv of the same layer; (b) sliding-window
   ParaDiGMS at B=1, T=50, W=8 through ``generate_trajectory`` at tol 0 and
   1e-3 against the sequential chain (sweeps, latency, the gap); (c) the
   teacher exported to a reference ``.pt`` and imported back through the
   CLI, read back equal; (d) ``run_full_sweep --skip-training`` as a
   subprocess, each stage's seconds and ``ok`` from ``SWEEP_torch_chip.json``.

The kernel record counts the launches of phases 4, 6(b), 7(b), 8 and 9.  The last
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


def phase_sampler():
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import sampling
    from distillation_trajectories_torch.diffusion.schedules import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update_reference
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
    kernel_traj = run()
    with mock.patch.object(sampling, "cfg_engine_update", cfg_engine_update_reference):
        plain_traj = run()
    compare("sampler kernel tail vs plain tail [8, 11, 32, 32, 3]",
            kernel_traj, plain_traj, 2e-5, 1e-5)

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


_KERNEL_KINDS = (  # first match wins
    ("cfg_engine_update (Triton)", ("cfg_engine_update",)),
    ("upsample", ("upsample",)),
    ("max pool", ("max_pool",)),
    ("batch norm", ("batch_norm",)),
    ("concat", ("CatArray", "cat_")),
    ("random normal", ("normal", "philox")),
    ("copy / cast", ("copy",)),
    ("convolution", ("conv", "xmma", "implicit_gemm", "cudnn")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Functor")),
)


def _busy_and_window(kernels):
    """Device busy time (the union of the kernels' intervals) and the span
    from the first kernel's start to the last one's end, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return busy, spans[-1][1] - spans[0][0]


def profile_breakdown(run, chain_s, card, label="one teacher CFG chain"):
    """Device time of one ``run()`` by kernel kind (torch.profiler, CUPTI),
    the device's idle share between its first and last kernel with the
    profiler on, and the idle share that busy time implies for the
    unprofiled call of ``chain_s`` seconds.  Device activity only: the
    host operator events (about 150,000 for a T=100 CFG chain) would make
    the profiled run and the reading of its events several times slower."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: torch.profiler recorded no device events: breakdown not measured")
        return
    busy, window = _busy_and_window(kernels)
    by_kind, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        kind = next((k for k, keys in _KERNEL_KINDS if any(s in e.name for s in keys)),
                    "other")
        n, t = by_kind.get(kind, (0, 0.0))
        by_kind[kind] = (n + 1, t + us)
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
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
    out = sweep_compare_trajectories(
        teacher, students, cfg, guidance_scales=MAIN_GS, num_samples=SAMPLES,
        base_seed=42, verbose=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cfg_engine_update.launches
    peak = torch.cuda.max_memory_allocated()
    chains = len(MAIN_GS) * (1 + len(STUDENTS))
    print(f"main path kernel launches: {launches} (expected {MAIN_T - 1} x "
          f"{chains} chains = {(MAIN_T - 1) * chains})")
    if launches != (MAIN_T - 1) * chains:
        raise RuntimeError("the main path did not launch the kernel once per step")

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
    return launches, SAMPLES / chain_s


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
    kind_of = lambda name: next((k for k, keys in _TRAIN_KINDS if any(s in name for s in keys)),
                                "other")
    by_kind, by_phase, by_name = {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        for table, key in ((by_kind, kind_of(e.name)), (by_name, e.name)):
            n, t = table.get(key, (0, 0.0))
            table[key] = (n + 1, t + us)
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

    cfg = Config(base_dir=workdir, dataset="CIFAR10", epochs=1, timesteps=TRAIN_T,
                 sample_steps=TRAIN_T, limit_batches_per_epoch=TRAIN_BATCHES,
                 num_samples_to_generate=16, samples_grid_size=4).create_directories()
    print(f"training: teacher sf 1.0 on {cfg.dataset} shapes {cfg.image_size}x{cfg.image_size}x"
          f"{cfg.channels} (synthetic stand-in, no dataset files), batch {cfg.batch_size}, "
          f"T={cfg.timesteps}, compute {cfg.compute_dtype}, dropout {cfg.dropout}, lr {cfg.lr}, "
          f"1 epoch of {TRAIN_BATCHES} batches; seeded random init")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = _TimedSteps(teacher.make_teacher_train_step)
    t0 = time.perf_counter()
    with mock.patch.object(teacher, "make_teacher_train_step", timed):
        state = teacher.train_teacher(cfg, seed=0)
    torch.cuda.synchronize()
    teacher_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model = state.model
    if any(t.device.type != "cuda" for t in model.state_dict().values()):
        raise RuntimeError("the trained teacher is not on the card")
    med, first, last = _step_summary(
        f"teacher train step (sf 1.0, {param_count(model)} params)", timed.runs[0],
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

    # A few more teacher steps under the profiler.
    step = teacher.make_teacher_train_step(get_diffusion_params(cfg.timesteps, cfg),
                                           cfg.timesteps)
    images = torch.rand((cfg.batch_size, 32, 32, 3), device="cuda", generator=gen) * 2 - 1
    for _ in range(3):
        step(state, images)
    torch.cuda.synchronize()
    profile_train_steps(lambda: step(state, images), 4, med, card)

    # Students from the teacher's checkpoint.
    distill = _TimedSteps(students.make_distill_train_step)
    t0 = time.perf_counter()
    with mock.patch.object(students, "make_distill_train_step", distill):
        trained_students = students.train_students(cfg, custom_size_factors=list(STUDENTS), seed=0)
    torch.cuda.synchronize()
    students_s = time.perf_counter() - t0
    for sf, record in zip(STUDENTS, distill.runs):
        student = trained_students[sf]
        if next(student.parameters()).device.type != "cuda":
            raise RuntimeError(f"student {sf} is not on the card")
        _step_summary(f"distill step sf {sf} ({param_count(student)} params)", record,
                      cfg.batch_size, card)
        for name in (os.path.join(cfg.student_dir(sf), "model_epoch_1.msgpack"),
                     os.path.join(cfg.results_dir, f"student_samples_size_{sf}_epoch_1.png")):
            if not os.path.getsize(name) > 0:
                raise RuntimeError(f"missing {name}")
    print(f"train_students {list(STUDENTS)}: {students_s:.3f} s in all [{card}]")


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


def _conv_flops(model, x):
    """2 x multiply-adds of every convolution of one forward of ``x``."""
    total = [0]

    def hook(module, inputs, output):
        k = module.weight[0].numel()  # in_channels / groups x kernel area
        total[0] += 2 * output.numel() * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    return total[0]


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
    flops = _conv_flops(inception.model, batch)
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


def _chain_rate(run, n):
    """Best of three host-timed calls of ``run`` (already warm), as traj/s."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return n / min(times), times


def phase_progressive(card, workdir, teacher_tps):
    """Phase 8(c): ``progressive_distill`` at full width from phase 5's
    teacher, two plain rounds and one guided round, then the students'
    chains at the main path's shape."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.diffusion.sampling import (
        draw_step_noise,
        generate_trajectory_scan,
        seeded_normal,
    )
    from distillation_trajectories_torch.models import load_unet_variables, make_unet
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.scripts._common import load_teacher_from_arg
    from distillation_trajectories_torch.training import make_eval_model_fn, progressive
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

    seeds = list(range(42, 42 + SAMPLES))
    noises = seeded_normal([(s, 0) for s in seeds], MAIN_SHAPE[1:], "cuda")
    chains = (
        (f"plain steps_{plain_steps} student", make_eval_model_fn(plain), plain_steps),
        (f"guided steps_{guided_steps} student at w={PROG_W} (make_guided_eval_fn, 1 forward "
         f"a step)", progressive.make_guided_eval_fn(guided, PROG_W), guided_steps),
    )
    step_noise = {t: draw_step_noise(seeds, t, MAIN_SHAPE[1:], "cuda") for _, _, t in chains}
    runs = [lambda fn=fn, t=t: generate_trajectory_scan(
        fn, noises, t, get_diffusion_params(t, cfg)["alphas"], seed=0, step_noise=step_noise[t])
        for _, fn, t in chains]
    torch.cuda.synchronize()
    cfg_engine_update.launches = 0
    outs = [run() for run in runs]
    torch.cuda.synchronize()
    launches = cfg_engine_update.launches
    expected = sum(t - 1 for _, _, t in chains)
    print(f"progressive students' chains kernel launches: {launches} (expected {expected}) [{card}]")
    if launches != expected:
        raise RuntimeError("the students' chains did not launch the kernel once per step")
    for (label, _, t), out in zip(chains, outs):
        if tuple(out.shape) != (t + 1, *MAIN_SHAPE) or not torch.isfinite(out).all():
            raise RuntimeError(f"{label}: chain not finite or misshapen")
    for (label, _, t), run in zip(chains, runs):
        tps, times = _chain_rate(run, SAMPLES)
        print(f"{label}, T={t}, {SAMPLES} x 32x32x3: {tps:.2f} traj/s (best of "
              f"{[round(x, 4) for x in times]} s, {min(times) / (t - 1) * 1e3:.3f} ms a step) "
              f"against phase 4's two-forward teacher CFG chain at T={MAIN_T}: "
              f"{teacher_tps:.2f} traj/s ({SAMPLES / teacher_tps / (MAIN_T - 1) * 1e3:.3f} ms a "
              f"step), x{tps / teacher_tps:.2f} [{card}]")
        profile_breakdown(run, min(times), card, label=f"one {label} chain, T={t}")
    return launches


def phase_edit(card, workdir, teacher_tps):
    t0 = time.perf_counter()
    phase_edit_check()
    print(f"phase editing/progressive (a) card vs CPU: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    launches = phase_edit_demo(card, workdir)
    print(f"phase editing/progressive (b) editing demo: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    launches += phase_progressive(card, workdir, teacher_tps)
    print(f"phase editing/progressive (c) progressive distillation: "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    if "matplotlib" in sys.modules:
        raise RuntimeError("the editing and progressive paths imported matplotlib")
    return launches


INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores (dense)
QUANT_ARMS = ("float", "fold", "int8", "int8_static", "int8_static_mixed")
LEVEL_HW = {"enc1": 32, "enc2": 16, "enc3": 8, "enc4": 4, "bottleneck": 2,
            "dec3": 4, "dec2": 8, "dec1": 16}  # each Block's spatial size at 32x32
# scripts/bench_quant.py's mixed set: int8 only where a Block works at 8x8 or more.
MIXED_BLOCKS = {name for name, hw in LEVEL_HW.items() if hw >= 8}
PARADIGMS_W = 8


def phase_int8_check(card, workdir):
    """9(a), first: the int8 pieces on the card against the CPU."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.models.quantized import (
        _qconv,
        int8_matmul,
        make_quantized_eval_fn,
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
    # Phase 5's teacher at 4 x 32x32x3: the dynamic per-tensor scales make
    # the forward jump at rounding ties (an ulp upstream flips a code, which
    # moves later scales), so the card is held to the CPU's own jump under a
    # 1e-7 relative change of the input, with a factor 2.
    models = {d: load_teacher_from_arg(Config(base_dir=workdir, device=d, compute_dtype="float32"))
              for d in ("cpu", "cuda")}
    x = torch.randn((4, 32, 32, 3), generator=gen)
    t = torch.tensor([3.0, 17.0, 41.0, 99.0])
    c = torch.tensor([[0.0], [1.0], [0.0], [1.0]])
    m = torch.ones((4, 1))
    fns = {d: make_quantized_eval_fn(models[d]) for d in models}
    outs = {d: fns[d](*(v.to(d) for v in (x, t, c, m))).cpu() for d in models}
    jump = rel(fns["cpu"](x * (1 + 1e-7), t, c, m), outs["cpu"])
    with torch.no_grad():
        float_out = models["cpu"].eval()(x, t, c, m)
    gap, drift = rel(outs["cuda"], outs["cpu"]), rel(outs["cpu"], float_out)
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    print(f"int8 forward card vs CPU (phase 5's sf-1.0 teacher, f32, TF32 off, 4 x 32x32x3): "
          f"relative L2 {gap:.3e}, max abs {err:.3e}; "
          f"the CPU's own jump under a 1e-7 input change {jump:.3e} (tolerance 2x that, at least "
          f"2e-4); int8 vs float on the CPU {drift:.3e} [{card}]")
    if not (torch.isfinite(outs["cuda"]).all() and gap <= 2 * max(jump, 1e-4) and drift < 0.15):
        raise RuntimeError("the int8 forward on the card disagrees with the CPU's")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _arm_fn(arm, teacher, scales):
    from distillation_trajectories_torch.models.quantized import make_quantized_eval_fn
    from distillation_trajectories_torch.training import make_eval_model_fn

    if arm == "float":
        return make_eval_model_fn(teacher)
    if arm == "fold":
        return make_quantized_eval_fn(teacher, nbits=None)
    if arm == "int8":
        return make_quantized_eval_fn(teacher)
    if arm == "int8_static":
        return make_quantized_eval_fn(teacher, act_scales=scales)
    return make_quantized_eval_fn(teacher, act_scales=scales, quant_blocks=MIXED_BLOCKS)


def phase_int8_arms(card, workdir):
    """9(a): the arms of scripts/bench_quant.py on phase 5's teacher at the
    main path's shape; returns the kernel's launches."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.diffusion.sampling import (
        CFG_COND_PAIRS,
        draw_step_noise,
        generate_trajectory_scan,
        seeded_normal,
    )
    from distillation_trajectories_torch.models.quantized import calibrate_activation_scales
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.scripts._common import load_teacher_from_arg

    cfg = Config(base_dir=workdir, timesteps=MAIN_T, sample_steps=MAIN_T)  # bf16, cuda
    teacher = load_teacher_from_arg(cfg)
    alphas = get_diffusion_params(MAIN_T, cfg)["alphas"]
    seeds = list(range(42, 42 + SAMPLES))
    noises = seeded_normal([(s, 0) for s in seeds], MAIN_SHAPE[1:], "cuda")
    step_noise = draw_step_noise(seeds, MAIN_T, MAIN_SHAPE[1:], "cuda")
    chain = lambda fn: generate_trajectory_scan(fn, noises, MAIN_T, alphas, seed=0,
                                                guidance_scale=3.0, step_noise=step_noise)
    print(f"int8 lane: phase 5's teacher sf 1.0, {SAMPLES} x 32x32x3, T={MAIN_T}, gs 3.0, compute "
          f"{cfg.compute_dtype}; arms {list(QUANT_ARMS)}; mixed blocks {sorted(MIXED_BLOCKS)}")
    results, f_chain, scales, launches = {}, None, None, 0
    for arm in QUANT_ARMS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if arm.startswith("int8_static") and scales is None:
            # Calibration states along the float chain (activations grow
            # toward the noisy end) with the sampler's two (cond, mask) rows.
            cb = min(32, SAMPLES)
            idxs = sorted({0, MAIN_T // 4, MAIN_T // 2, (3 * MAIN_T) // 4, MAIN_T - 1})
            rows = [(f_chain[i][:cb], float(MAIN_T - 1 - i), c, mk)
                    for i in idxs for c, mk in np.unique(CFG_COND_PAIRS, axis=0)]
            scales = calibrate_activation_scales(
                teacher, torch.stack([r[0] for r in rows]),
                torch.tensor([[r[1]] * cb for r in rows], device="cuda"),
                torch.tensor([[[r[2]]] * cb for r in rows], device="cuda"),
                torch.tensor([[[r[3]]] * cb for r in rows], device="cuda"))
            print(f"  calibrated {sum(len(v) for v in scales.values())} static scales on "
                  f"{len(rows)} batches of {cb} in {time.perf_counter() - t0:.3f} s")
        fn = _arm_fn(arm, teacher, scales)
        before = cfg_engine_update.launches
        first = chain(fn)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        tps, times = _chain_rate(lambda: chain(fn), SAMPLES)
        made = cfg_engine_update.launches - before
        peak = torch.cuda.max_memory_allocated()
        if made != 4 * (MAIN_T - 1) or not torch.isfinite(first).all():
            raise RuntimeError(f"{arm}: {made} launches for 4 chains, or a chain not finite")
        launches += made
        if arm == "float":
            f_chain = first
        end, f_end = first[-1], f_chain[-1]
        rel = float((end - f_end).norm() / f_end.norm())
        results[arm] = dict(tps=tps, rel=rel, peak=peak)
        print(f"  arm {arm}: {tps:.2f} traj/s (best of {[round(x, 4) for x in times]} s; first "
              f"call {first_s:.3f} s with setup), x{tps / results['float']['tps']:.3f} float; "
              f"endpoint relative L2 vs float {rel:.5f}; peak device memory {peak} bytes = "
              f"{peak / 2**30:.3f} GiB [{card}]")
    best = max((a for a in results if a.startswith("int8")), key=lambda a: results[a]["tps"])
    print(f"int8 lane best arm: {best} at {results[best]['tps']:.2f} traj/s = "
          f"x{results[best]['tps'] / results['float']['tps']:.3f} the bf16 float chain, endpoint "
          f"relative L2 {results[best]['rel']:.5f} [{card}]")
    _int8_layer_times(teacher, card)
    return launches


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

    qvars = quantize_unet_variables(teacher)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sums = [0.0, 0.0, 0.0]
    print(f"int8 conv per layer at batch {SAMPLES} (device ms; product bound at 1979 TOP/s int8 and "
          f"3.35 TB/s):")
    with torch.no_grad():
        for name, hw in LEVEL_HW.items():
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


def phase_paradigms(card, workdir):
    """9(b): sliding-window ParaDiGMS through generate_trajectory against
    the sequential chain; returns the kernel's launches (the sequential
    chains'; the window path launches none)."""
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

    noise = seeded_normal([(7, 0)], MAIN_SHAPE[1:], "cuda")
    launches = 0
    for dtype in ("float32", "bfloat16"):
        saved = _tf32_off() if dtype == "float32" else None
        cfg = Config(base_dir=workdir, timesteps=MAIN_T, sample_steps=MAIN_T, compute_dtype=dtype)
        teacher = load_teacher_from_arg(cfg)
        runs = {"sequential": (cfg, 0)}
        for tol in (0.0, 1e-3):
            runs[f"window tol={tol:g}"] = (dataclasses.replace(
                cfg, parallel_sampling="window", paradigms_window=PARADIGMS_W,
                paradigms_tol=tol), tol)
        outs = {}
        with mock.patch.object(parallel_sampling, "sliding_window_trajectory", recorded):
            for label, (rcfg, _) in runs.items():
                run = lambda: generate_trajectory(teacher, noise, MAIN_T, seed=7,
                                                  guidance_scale=3.0, config=rcfg)
                before = cfg_engine_update.launches
                sweeps.clear()
                outs[label] = run()
                _, times = _chain_rate(run, 1)
                made = cfg_engine_update.launches - before
                expected = 4 * (MAIN_T - 1) if label == "sequential" else 0
                if made != expected or not torch.isfinite(outs[label]).all():
                    raise RuntimeError(f"{label}: {made} launches (expected {expected}) or not finite")
                launches += made
                gap = float((outs[label] - outs["sequential"]).abs().max())
                print(f"ParaDiGMS {dtype} {label} (B=1, T={MAIN_T}, W={PARADIGMS_W}, gs 3.0): "
                      f"{'sweeps ' + str(sweeps[-1]) + ', ' if sweeps else ''}best of "
                      f"{[round(x * 1e3, 2) for x in times]} ms, {made} kernel launches in 4 "
                      f"calls, max abs gap to the sequential chain {gap:.3e} [{card}]")
        if saved is not None:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return launches


def phase_migration(card, workdir):
    """9(c): phase 5's teacher to a reference .pt and back through the CLIs."""
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


def phase_orchestrator(card, workdir):
    """9(d): the full-sweep orchestrator with --skip-training on phase 5's
    checkpoints, as a subprocess (each stage a subprocess of its own)."""
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "distillation_trajectories_torch.scripts.run_full_sweep",
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
    print(f"run_full_sweep --skip-training (sizes {CLI_SIZES}, cuda): exit {proc.returncode}, "
          f"{wall:.3f} s; SWEEP_torch_chip.json ok={payload['ok']}, device "
          f"{payload['preflight_probe'].get('name')}, stages " + ", ".join(
              f"{k} {v['seconds']} s ok={v['ok']}" for k, v in stages.items()) + f" [{card}]")
    if proc.returncode != 0 or not payload["ok"] or set(stages) != {"cfg_sweep", "trio", "fid"}:
        print(stdout[-3000:], stderr[-3000:])
        raise RuntimeError("the orchestrator's stages did not all pass")


def phase_lanes(card, workdir):
    t0 = time.perf_counter()
    phase_int8_check(card, workdir)
    launches = phase_int8_arms(card, workdir)
    print(f"phase lanes (a) int8: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    launches += phase_paradigms(card, workdir)
    print(f"phase lanes (b) ParaDiGMS: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    phase_migration(card, workdir)
    print(f"phase lanes (c) migration: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    phase_orchestrator(card, workdir)
    print(f"phase lanes (d) orchestrator: {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


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

    t0 = time.perf_counter()
    record = phase_kernel(card)
    print(f"phase kernel: {time.perf_counter() - t0:.1f} s (Triton build included)")
    t0 = time.perf_counter()
    phase_sampler()
    print(f"phase sampler: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, teacher_tps = phase_main_path(card)
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
        edit_launches = phase_edit(card, workdir, teacher_tps)
        print(f"phase editing/progressive: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        lane_launches = phase_lanes(card, workdir)
        print(f"phase lanes: {time.perf_counter() - t0:.1f} s [{card}]")
    total = launches + cli_launches + clis_launches + edit_launches + lane_launches
    print(f"cfg_engine_update launches: {launches} (main path, phase 4) + {cli_launches} "
          f"(CFG-sweep CLI, phase 6) + {clis_launches} (analysis CLIs, phase 7) + "
          f"{edit_launches} (editing demo and progressive students, phase 8) + "
          f"{lane_launches} (int8 arms' and sequential chains, phase 9) = {total}")

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
