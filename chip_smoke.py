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
   does not reproduce the trained model, or anything ran on the CPU.

The last lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU or when any
phase fails.
"""

import itertools
import json
import os
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


def compare(name, got, want, rtol, atol):
    diff = (got.float() - want.float()).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.float().abs().clamp_min(1e-30)).max())
    print(f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(rtol={rtol:g}, atol={atol:g})")
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


def profile_breakdown(run, chain_s, card):
    """Device time of one ``run()`` by kernel kind (torch.profiler, CUPTI),
    the device's idle share between its first and last kernel with the
    profiler on, and the idle share that busy time implies for the
    unprofiled call of ``chain_s`` seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    print(f"profile (one teacher CFG chain, profiler on): {len(kernels)} kernels, "
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
        StepDraws,
        TorchDraws,
        create_train_state,
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
        runs = {}
        for device in ("cpu", "cuda"):
            model = make_unet(cfg, size_factor=0.1, device=device, seed=0)
            moved = StepDraws(draws.t.to(device), tuple(n.to(device) for n in draws.noises))
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
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


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
    launches = phase_main_path(card)
    print(f"phase main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_check()
    with tempfile.TemporaryDirectory() as workdir:
        phase_train_main(card, workdir)
    print(f"phase training: {time.perf_counter() - t0:.1f} s")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "cfg_engine_update",
        "route": "triton",
        "source": "distillation_trajectories_torch/ops/cfg_update_triton.py",
        "replaces": "distillation_trajectories_tpu/ops/cfg_update.py:30",
        "launches": launches,
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
