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
   ``(1, 7, 5, 1)`` shape, through its row entry (the four scalars a
   ``[4]`` float32 row in device memory, as the chains call it; the float
   entry checked equal), with errors, device times and the memory bound;
   then the DiT block's fused adaLN kernels (``ln_modulate``,
   ``gate_add_ln_modulate``) against their plain compositions at DiT-XL/2's
   8,192 token rows of 1,152 (32 samples of 256 tokens, bf16 ``y`` and
   ``h``, the modulations strided chunks of a ``[32, 6D]`` output) and at
   the students' widths 768 and 384, each alone with its device time, the
   plain composition's as the block ran it under autocast (``library_ms``)
   and its byte bound; then the DiT path: one DiT-XL/2 chain of the DiT
   cell's 32 samples of 32x32x4 latents (bf16, CFG, T=10) through the
   sweep's chain maker, called three times (eager, captured, replayed),
   with each forward's adaLN launches checked (one ``ln_modulate`` and
   two ``gate_add_ln_modulate`` a block) and every eager forward's
   ``dit.forward`` span reading "fused";
3. the sampler with the kernel tail (the kernel launched once a step, the
   plain version never called) against the plain tail on the card
   (float32, TF32 off, sf 0.1, T=10), and a small sweep on the card
   against the same sweep on the CPU;
4. the main path: ``sweep_compare_trajectories`` with the sf-1.0 teacher
   and students {0.1, 0.5} (seeded random weights), 32x32x3, 256 samples,
   T=50, guidance scales (1.0, 3.0), bf16 compute — with the kernel's
   launch count checked, the plain version checked unused, metrics checked
   finite, and peak memory printed (each chain runs once in this one call,
   so the engine runs it through its maker with ``eager=True``).  The
   benchmark's ``cifar10-32.sweep`` cell times this traffic; 14(a) holds
   the teacher's captured chain;
5. training: one teacher step and one distillation step on the card
   against the CPU (float32, TF32 off, sf 0.1, 16x16x1, batch 8, T=10,
   dropout 0, shared weights and draws); then ``train_teacher`` at full
   width (sf 1.0, the synthetic CIFAR-shaped set, batch 128, T=100, bf16,
   dropout 0.3, one epoch of 30 batches, a checkpoint and a 16-sample grid
   written to a temporary directory) and ``train_students`` for
   sf {0.1, 0.5} from that checkpoint, both through the trainers' default
   epoch lane (a captured CUDA graph replayed a batch) — with each epoch's
   seconds a step (capture included), images/s, checkpoint and grid
   times, peak memory, and the losses of a few per-batch teacher steps
   printed, the PNG writer that
   wrote the grids named (the raw grid where matplotlib does not import),
   and a failure when a loss is not finite or does not fall, no graph was
   captured, the checkpoint read back does not reproduce the trained
   model, or anything ran on the CPU (the ``cifar10-32.train`` cell times
   the teacher's epoch lane);
6. analysis, on phase 5's checkpoints (teacher, students {0.1, 0.5}):
   (a) the InceptionV3 trunk (299x299, batch 2), its preprocessing,
   AlexNet-LPIPS (64x64, batch 8), the paired trajectory function (T=10)
   and the trajectory manager (4 pairs written, read back and scored) on
   the card against the CPU, in float32 with TF32 off; (b) the CFG-sweep
   CLI's ``run`` half with the full sweep's two jobs (``heatmaps``: 10
   guidance scales, 10 samples, T=100; ``trio``: T=50), the kernel's launch
   count checked and every transformed metric checked in [0, 1], with
   wall seconds, traj/s and peak memory (the ``cifar10-32.cfg-cli-b10``
   cell times this traffic);
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
   and npz files written) (the ``cifar10-32.pairs-b1`` cell times their
   batch-1 T=100 paired call).  Nothing here imports matplotlib either;
8. editing and progressive distillation: (a) the editing chain (engine
   mode, inpainting ``post_step``) and the plain, guided and
   ``teacher_guided`` progressive steps on the card against the CPU, in
   float32 with TF32 off; (b) the editing demo CLI's ``run`` half at its
   defaults on phase 5's teacher (T=50, 32 direction samples, bf16), its
   270 launches checked against the count its arguments give, its images,
   trajectories and directions checked, each stage's wall seconds printed;
   (c) ``progressive_distill`` from phase 5's teacher (batch 128,
   teacher_steps 100, bf16, dropout 0.3): two plain rounds (100 → 50 → 25)
   and one guided round (w ~ U[1, 5], 100 → 50) of 10 batches, each on the
   captured epoch lane (2 eager warm-up steps, the capture, 8 replays; the
   per-batch step patched to raise, each round's graph checked released
   when the round ends), with each round's lane, epoch seconds a step (the
   capture included), capture seconds, images/s and peak memory, and every
   checkpoint read back (phase 12 times the students' chains, 13(d) the
   step in both lanes);
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
   replays, after an eager warm-up and the capture), its table's top 10
   rows and the device's idle share printed,
   the kernel's 147 traced launches checked; (b) the seven-stage smoke
   suite on ``cuda``, 7/7; (c) ``run_on_cpu train_teacher`` at tiny flags:
   the child reports that CUDA sees no card and writes a checkpoint, and
   this process's device memory does not move; (d) ``analyze_latest_sample``
   on phase 5's grid, its structure score equal to numpy's on the pixels
   decoded with ``zlib``; (e) ``show_real_samples.run`` on the synthetic
   stand-in;
12. the bench entry points, each through its module's ``run`` at its
   defaults (full width: sf 1.0, 32x32x3, bf16; ``--iters 2`` for
   ``bench_r2``, ``bench_quant``, ``bench_progressive`` and
   ``bench_fast``), every arm timed on
   its captured chain (the replays of a CUDA graph, its first call eager
   and its second the capture) and its eager body on the same seeds, both
   printed, the kernel's launches
   checked against the count each bench's arguments give and its JSON
   record printed with the card's name and power limit: (a) ``bench`` (the
   main path's traj/s over 5 timed replays of the captured chain, the eager
   chain's seconds beside them, the metric suite's pairs/s, the
   CPU baseline, the update tail it ran, ``use_pallas`` true, in its record
   and its ledger line in the workdir); (b) ``bench_r2`` ``pallas``
   (the kernel against the plain tail in turns, batch 256, T=50, bf16,
   each arm's seconds printed and the chains' deviation held under
   ``PALLAS_CHAIN_ATOL``), ``ablate`` (batch 256) and
   ``paradigms`` (B=1, windows {4, 8, 16} x tol {1e-3, 3e-3, 1e-2}; the
   window sampler eager, against the eager sequential chain);
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
   loss at rtol 1e-5, the weights held as ``_hold_weights`` says (the
   ``cifar10-32.train`` and ``mnist-16.train`` cells time the teacher's
   epoch lane); (c) ``train_students`` {0.01, 0.05, 0.1}
   from phase 5's teacher, 10 batches, float32 with TF32 off: {0.01, 0.05}
   as one group step and 0.1 alone, held against ``vmap_students=False``
   (losses rtol 1e-5), with the group's epoch seconds against the two
   sequential ones; (d) progressive distillation's captured round: a hold
   (float32, TF32 off, cuDNN deterministic, sf 0.1, 16x16x1, batch 8,
   T=10 → 5, two epochs of 8 batches, plain, guided and
   ``teacher_guided``) of the graph-replayed round against the eager
   per-batch loop, run twice (generator end states equal, each weight
   within Adam's bound, the loss and weight distances printed beside the
   loop's own), and every replay of the last epoch against the eager step
   from the same state (loss at rtol 1e-5, generator equal, weights after
   the step within ``_hold_weights``); then phase 5's teacher at full width
   (batch 128, T=100 → 50, bf16, dropout 0.3), plain and guided, 30
   batches a turn, loop, graph, graph, loop: median synchronized step,
   images/s, the device's idle share and kernels a step over 4 profiled
   steps, capture seconds and peak memory, after the dataset upload's
   bytes and seconds;
14. the samplers' captured lane (each maker captures its chain into a
   CUDA graph on the second call for a key and replays it): (a) the main
   path's chain through ``make_sweep_trajectory_fn`` (sf-1.0 teacher,
   batch 256, 32x32x3, T=50, bf16): one graph serves gs 2.0, 3.0 and 7.5,
   each replay equal to the eager body bit for bit with 49 launches
   counted and finite, a replay after the weights change in place equal to the eager
   chain with them, 49 launches of the kernel in a traced replay's device
   events and no host-to-device copy, the plain version never called, and
   the int8 lane's chain (batch 8, T=10) replayed equal to its eager body,
   and each bench's chain maker at full width (batch 256, T=50, bf16):
   ``bench_r2``'s ``pallas`` kernel arm (gs 7.5) and ``bench_fast``'s
   teacher arm (gs 3.0), the same chain on one graph, ``bench_quant``'s
   ``int8_static_mixed`` arm (gs 3.0) and ``bench_progressive``'s guided
   student at w 2.0 and 5.0 on one graph (its ``w`` a tensor set in
   place), each replay equal to the eager body bit for bit with 49
   launches counted and the plain version never called.  The eager body
   is the maker's call with ``eager=True``.  The benchmark's cells time
   these chains (``cifar10-32.sweep``, ``.cfg-cli-b10``, ``.pairs-b1``:
   each model's CFG and CFG-off chains replayed, on one static set).

The CFG-update record counts the launches of phase 2's DiT chain and of
phases 4, 6(b), 7(b), 8(b), 9(d), 10 (the ranks' included), 11, 12 and
14; each adaLN record those of phase 2's DiT chain.  The last
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
        cfg_engine_update_row,
    )

    alphas = get_diffusion_params(MAIN_T)["alphas"]
    scalars = (*_engine_scalars(alphas[25], alphas[24]), 3.0)
    # The chains' form: the scalars as a [4] float32 row in device memory.
    row = torch.tensor(np.array(scalars, dtype=np.float32), device="cuda")
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
        got = cfg_engine_update_row(*sets[0], row)
        torch.cuda.synchronize()
        want = cfg_engine_update_reference(*sets[0], *scalars)
        max_abs = compare(f"kernel vs plain {label} {shape}", got, want, tol, tol)
        if not torch.equal(cfg_engine_update(*sets[0], *scalars), got):
            raise RuntimeError("the float entry and the row entry disagree")
        if label == "f32-odd":
            continue
        ring = itertools.cycle(sets)
        kernel_ms = device_time_ms(
            lambda: cfg_engine_update_row(*next(ring), row), 100)
        plain_ms = device_time_ms(
            lambda: cfg_engine_update_reference(*next(ring), *scalars), 100)
        numel = int(np.prod(shape))
        bytes_moved = 5 * numel * torch.finfo(dtype).bits // 8 + 16  # and the scalar row
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = 8 * numel / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"cfg_engine_update (row entry) {label} {shape}: kernel_ms={kernel_ms:.5f} "
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


ADALN_SAMPLES, ADALN_TOKENS = 32, 256  # the DiT cell's batch; 16x16 patches of 32x32 latents


def _adaln_operands(width, gen):
    """The float32 residual rows, a bf16 branch output and the bf16
    adaLN chunks ``(gate, shift, scale)`` of two ``[B, 6D]`` outputs."""
    b, n = ADALN_SAMPLES, ADALN_TOKENS
    x = torch.randn((b, n, width), device="cuda", generator=gen) * 3 + 0.5
    y = torch.randn((b, n, width), device="cuda", generator=gen).bfloat16()
    mods = torch.randn((b, 6 * width), device="cuda", generator=gen).bfloat16().chunk(6, dim=1)
    return x, y, mods[2], mods[3], mods[4]


def phase_adaln(card):
    """The fused adaLN kernels at the DiT cell's shapes, each alone: device
    time against the byte bound, the plain composition as ``library_ms``
    (bf16 ``h`` the autocast cast of its float32 result, ``gate·y`` in bf16
    as autocast leaves it); returns the DiT-XL/2 width's records.  The gated
    kernel writes ``x'`` over ``x``: the timed calls drift each set's ``x``
    by ``gate·y`` a call, the same bytes."""
    from distillation_trajectories_torch.ops.adaln import (
        gate_add_ln_modulate,
        gate_add_ln_modulate_reference,
        ln_modulate,
        ln_modulate_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for width in (1152, 768, 384):
        # Four operand sets (226 MB at width 1152) cycled, so each call finds
        # its rows outside the 50 MB L2, as the forward does.
        sets = [_adaln_operands(width, gen) for _ in range(4)]
        ring = itertools.cycle(sets)
        rows = ADALN_SAMPLES * ADALN_TOKENS
        mod_bytes = ADALN_SAMPLES * width * 2
        kernels = (
            ("ln_modulate", lambda x, y, g, sh, sc: ln_modulate(x, sh, sc),
             lambda x, y, g, sh, sc: ln_modulate_reference(x, sh, sc).bfloat16(),
             rows * width * (4 + 2) + 2 * mod_bytes),
            ("gate_add_ln_modulate", gate_add_ln_modulate,
             lambda x, y, g, sh, sc: tuple(
                 a.bfloat16() if i else a
                 for i, a in enumerate(gate_add_ln_modulate_reference(x, y, g, sh, sc))),
             rows * width * (4 + 2 + 4 + 2) + 3 * mod_bytes),
        )
        for name, kernel, plain, bytes_moved in kernels:
            with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                got = kernel(sets[0][0].clone(), *sets[0][1:])  # x' is written over x
                torch.cuda.synchronize()
                x, y, gate, shift, scale = sets[0]
                want = (ln_modulate_reference(x, shift, scale) if name == "ln_modulate"
                        else gate_add_ln_modulate_reference(x, y, gate, shift, scale))
                got_h, want_h = (got, want) if name == "ln_modulate" else (got[1], want[1])
                if name != "ln_modulate" and not torch.equal(got[0], want[0]):
                    raise RuntimeError(f"{name} x' differs from the plain composition's")
                max_abs = compare(f"{name} h (bf16) vs the plain composition D={width}",
                                  got_h.float(), want_h, 2**-7, 1e-5)
                kernel_ms = device_time_ms(lambda: kernel(*next(ring)), 200)
                plain_ms = device_time_ms(lambda: plain(*next(ring)), 50)
            bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
            print(f"{name} D={width} [{rows}, {width}]: kernel_ms={kernel_ms:.5f} "
                  f"library_ms={plain_ms:.5f} (the plain composition) bound_ms={bound_ms:.5f} "
                  f"(bytes {bytes_moved} at 3.35 TB/s) share_of_bound={bound_ms / kernel_ms:.3f} "
                  f"[{card}]")
            if width == 1152:
                records.append(dict(name=name, max_abs_err=max_abs, ms=kernel_ms,
                                    bound_ms=bound_ms, bound_by="bytes", library_ms=plain_ms))
    return records


DIT_T = 10


def phase_dit(card):
    """Phase 2's DiT path: a DiT-XL/2 teacher's chain at the DiT cell's
    batch and latent shape through ``make_sweep_trajectory_fn``, the
    sweep's maker, run eagerly, captured and replayed.  Returns the
    launches ``(cfg_engine_update, ln_modulate, gate_add_ln_modulate)``
    the three calls counted, each checked against the forwards' count."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.diffusion.sampling import CFG_COND_PAIRS
    from distillation_trajectories_torch.models.dit import make_dit
    from distillation_trajectories_torch.ops.adaln import gate_add_ln_modulate, ln_modulate
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.trajectories.engine import make_sweep_trajectory_fn
    from distillation_trajectories_torch.utils.profiling import recording

    cfg = Config(device="cuda", image_size=32, channels=4, timesteps=DIT_T,
                 compute_dtype="bfloat16", architecture="dit")
    model = make_dit(cfg, "DiT-XL/2", seed=0).eval()
    depth = len(model.blocks)
    gen = torch.Generator(device="cuda").manual_seed(1)
    noises = torch.randn((ADALN_SAMPLES, 32, 32, 4), device="cuda", generator=gen)
    labels = torch.randint(0, 1000, (ADALN_SAMPLES,), device="cuda", generator=gen)
    seeds = list(range(ADALN_SAMPLES))
    sweep = make_sweep_trajectory_fn(model, DIT_T, cfg)
    counted = (cfg_engine_update, ln_modulate, gate_add_ln_modulate)
    for k in counted:
        k.launches = 0
    forwards = 2 * (DIT_T - 1)  # CFG: two forwards a step
    want = (DIT_T - 1, forwards, 2 * depth * forwards)
    with recording() as rec:
        for call in ("eager", "captured", "replayed"):
            before = tuple(k.launches for k in counted)
            t0 = time.perf_counter()
            trajs = sweep(noises, seeds, CFG_COND_PAIRS, 4.0, labels=labels)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            made = tuple(k.launches - b for k, b in zip(counted, before))
            print(f"DiT-XL/2 chain ({call}, {ADALN_SAMPLES} samples, T={DIT_T}, CFG): "
                  f"{wall:.3f} s, launches cfg_engine_update/ln_modulate/gate_add_ln_modulate "
                  f"{made} (expected {want}: {forwards} forwards of {depth} blocks) [{card}]")
            if made != want:
                raise RuntimeError(f"the DiT chain's {call} call launched {made}, expected {want}")
    if not torch.isfinite(trajs).all():
        raise RuntimeError("the DiT chain's trajectories are not finite")
    paths = [sp.attrs["adaln"] for sp in rec.spans if sp.name == "dit.forward"]
    if len(paths) < forwards or set(paths) != {"fused"}:
        raise RuntimeError(f"the DiT chain's eager forwards ran {sorted(set(paths))}, "
                           f"{len(paths)} of them")
    print(f"DiT-XL/2 chain: {len(paths)} eager forwards, every dit.forward span adaln=fused")
    launches = tuple(k.launches for k in counted)
    del model, sweep, trajs
    torch.cuda.empty_cache()
    return launches


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
        cfg_engine_update_row_reference,
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
    with mock.patch.object(sampling, "cfg_engine_update_row", cfg_engine_update_row_reference):
        plain_traj = run()
    compare("sampler kernel tail vs plain tail [8, 11, 32, 32, 3]",
            kernel_traj, plain_traj, 2e-5, 1e-5, card)

    # The small sweep of tests/test_torch_engine.py, on the card against the
    # CPU (which the CPU tests hold to the JAX package), on shared draws.
    kw = dict(image_size=16, channels=1, timesteps=10, sample_steps=10,
              compute_dtype="float32")
    results = {}
    draws = _sweep_inputs(Config(device="cpu", **kw), 4, 42, 10, None, "cpu")
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


def _recorded_s(name, fn, *args, **kwargs):
    """``(fn(*args, **kwargs), seconds)``: the call's result and the
    seconds inside the program's spans named ``name`` (``graph.capture``,
    ``epoch.capture``) that the call recorded."""
    from distillation_trajectories_torch.utils.profiling import recording

    with recording() as rec:
        out = fn(*args, **kwargs)
    return out, sum(s.end_ns - s.start_ns for s in rec.spans if s.name == name) / 1e9


def profile_breakdown(run, call_s, card, label):
    """Device time of one ``run()`` by kernel kind (torch.profiler, CUPTI),
    the device's idle share between its first and last kernel with the
    profiler on, and the idle share that busy time implies for the
    unprofiled call of ``call_s`` seconds.  Device activity only."""
    from torch.profiler import ProfilerActivity, profile

    from distillation_trajectories_torch.utils.profiling import busy_and_window, tally

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: torch.profiler recorded no device events: breakdown not measured")
        return
    busy, window = busy_and_window((e.time_range.start, e.time_range.end) for e in kernels)
    by_kind, by_name = tally((e.name, e.time_range.elapsed_us()) for e in kernels)
    total = sum(t for _, t in by_kind.values())
    print(f"profile ({label}, profiler on): {len(kernels)} kernels, "
          f"device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window, "
          f"idle share {1 - busy / window:.3f}; against the unprofiled "
          f"{call_s * 1e3:.3f} ms call, idle share {1 - busy / 1e6 / call_s:.3f} [{card}]")
    for kind, (n, t) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        print(f"  {kind}: {t / 1e3:.3f} ms ({t / total:.1%}) in {n} launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  top kernel {t / 1e3:.3f} ms x{n}: {name[:110]}")


def _pool_bytes():
    """Bytes of device memory the sampler graphs' shared pool holds."""
    from distillation_trajectories_torch.utils import graphs

    pool = graphs._SAMPLER_POOL["handle"]
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def phase_main_path(card):
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.models import make_unet, param_count
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.trajectories import sweep_compare_trajectories

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
    with _PlainCalls() as plain_calls:
        out = sweep_compare_trajectories(
            teacher, students, cfg, guidance_scales=MAIN_GS, num_samples=SAMPLES,
            base_seed=42, verbose=False)
        torch.cuda.synchronize()
    launches = cfg_engine_update.launches
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
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

    print(f"peak device memory (the sweep of {len(MAIN_GS) * len(STUDENTS) * SAMPLES} pairs, "
          f"{chains} chains): {peak} bytes = {peak / 2**30:.3f} GiB allocated, {peak_reserved} "
          f"bytes reserved [{card}]")
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
            (state, losses), capture_s = _recorded_s("epoch.capture", epoch_fn, state, dataset,
                                                     idx)
            torch.cuda.synchronize()
            if not isinstance(epoch_fn.captured[0].graph, torch.cuda.CUDAGraph):
                raise RuntimeError("the epoch lane captured no CUDA graph")
            record.append((time.perf_counter() - t0, losses.cpu().tolist(), capture_s))
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

    # A few more teacher steps of the per-batch lane on the same state.
    step = teacher.make_teacher_train_step(get_diffusion_params(cfg.timesteps, cfg),
                                           cfg.timesteps)
    images = torch.rand((cfg.batch_size, 32, 32, 3), device="cuda", generator=gen) * 2 - 1
    losses = [float(step(state, images)[1]) for _ in range(7)]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"teacher per-batch step: a loss is not finite: {losses}")
    print(f"teacher per-batch step (sf 1.0, the same state): {len(losses)} steps, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} [{card}]")

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
    peak_reserved = torch.cuda.max_memory_reserved()
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
          f"{peak / 2**30:.3f} GiB allocated, {peak_reserved} bytes reserved (the captured "
          f"chains' one shared pool included) [{card}]")

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


def phase_clis(card, workdir):
    t0 = time.perf_counter()
    phase_cli_check(card, workdir)
    print(f"phase CLIs (a) card vs CPU: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    launches = phase_cli_runs(card, workdir)
    print(f"phase CLIs (b) five run halves: {time.perf_counter() - t0:.1f} s [{card}]")
    if "matplotlib" in sys.modules:
        raise RuntimeError("the analysis CLIs imported matplotlib")
    return launches


PROG_BATCHES = 10  # batches per progressive round (one epoch)
PROG_GUIDANCE = (1.0, 5.0)


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


class _RoundEpochs(_TimedEpochs):
    """``_TimedEpochs`` that also keeps, for each epoch function it makes
    (one per progressive round), the model that round trains, the peak
    device memory of its epochs, its graph's replays and the capture
    list the round releases when it ends."""

    def __init__(self, factory):
        super().__init__(factory)
        self.models, self.peaks, self.replays, self.captures = [], [], [], []

    def __call__(self, *args, **kwargs):
        timed = super().__call__(*args, **kwargs)
        i = len(self.models)
        self.models.append(None)
        self.peaks.append(0)
        self.replays.append(0)
        self.captures.append(timed.captured)
        torch.cuda.reset_peak_memory_stats()

        def epoch(state, dataset, idx):
            warm = timed.captured[0].warm if timed.captured else 0
            out = timed(state, dataset, idx)
            self.replays[i] += len(idx) - (timed.captured[0].warm - warm)
            self.models[i] = state.model
            self.peaks[i] = torch.cuda.max_memory_allocated()
            return out

        epoch.captured = timed.captured
        return epoch


def _no_per_batch_step(*args, **kwargs):
    raise RuntimeError("a progressive round took the per-batch loop on the card")


def phase_progressive(card, workdir):
    """Phase 8(c): ``progressive_distill`` at full width from phase 5's
    teacher, two plain rounds and one guided round, each on the captured
    epoch lane (the per-batch step patched to raise), every checkpoint read
    back (phase 12(d) and (e) time the students' chains, 13(d) the lanes
    in turns)."""
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
    timed = _RoundEpochs(progressive.make_progressive_epoch_fn)
    with mock.patch.object(progressive, "make_progressive_epoch_fn", timed), \
            mock.patch.object(progressive, "make_progressive_distill_step", _no_per_batch_step):
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
    if any(timed.captures):
        raise RuntimeError("a progressive round's graph outlived its round")
    rounds = (("plain", cfg.teacher_steps // 2, "2 teacher forwards"),
              ("plain", cfg.teacher_steps // 4, "2 teacher forwards"),
              ("guided", cfg.teacher_steps // 2, "4 teacher forwards (CFG pair x 2 updates)"))
    for (kind, n, forwards), record, model, peak, replays in zip(
            rounds, timed.runs, timed.models, timed.peaks, timed.replays):
        if replays != PROG_BATCHES - 2:
            raise RuntimeError(f"progressive {kind} -> {n}: {replays} replays, not "
                               f"{PROG_BATCHES - 2} after the 2 warm-up steps")
        _epoch_summary(f"progressive round {kind} -> {n} steps ({forwards} + student forward "
                       f"and backward)", record, cfg.batch_size, card)
        print(f"  lane: captured (2 eager warm-up steps, the capture {record[0][2]:.3f} s, "
              f"{replays} replays); peak device memory of the round's epoch: {peak} bytes = "
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
          f"{guided_s:.3f} s (datasets, steps, captures and async checkpoints included) [{card}]")


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

    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.training import students as port_students
    from distillation_trajectories_torch.utils.profiling import busy_and_window

    cfg = Config(base_dir=os.path.join(workdir, f"lanes_{tag}"), dataset="CIFAR10", epochs=1,
                 timesteps=TRAIN_T, sample_steps=TRAIN_T, limit_batches_per_epoch=10,
                 num_samples_to_generate=0, compute_dtype=compute_dtype).create_directories()
    shutil.copy(os.path.join(workdir, "output", "models", "teacher", "model_epoch_1.msgpack"),
                cfg.teacher_models_dir)
    walls = []

    def run():
        t0 = time.perf_counter()
        port_students.train_students(cfg, custom_size_factors=list(STUDENTS), seed=0,
                                     sweep_parallel=sweep_parallel)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    events = _device_events(run)  # the raw events: no event tree to build
    busy, window = (busy_and_window((start, end) for _, start, end in events) if events
                    else (float("nan"),) * 2)
    wall = walls[0]
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
          f"{profile_sampler.GUIDANCE}, bf16; two warm-ups, eager and the capture, and three "
          f"traced replays, CUDA activity): {capture_s:.3f} s, trace "
          f"{os.path.getsize(path)} bytes [{card}]")
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
    two warm-ups (eager, then the capture) and three traced replays (the
    smoke suite samples through ``p_sample_loop``, and the dispatched child
    runs on the CPU)."""
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
    print(f"last entry points kernel launches: {launches} (expected 5 x {MAIN_T - 1} = "
          f"{5 * (MAIN_T - 1)})")
    if launches != 5 * (MAIN_T - 1):
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


def _tps(batch, seconds):
    """traj/s of calls of ``batch`` trajectories: batch x calls over their
    summed seconds (the benches' method)."""
    return batch * len(seconds) / sum(seconds)


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
        # Two warm-up chains (eager, then the capture), the timed replays
        # and the eager chains on the same seeds.
        rec, launches = _bench_run(
            "bench", bench, [], lambda a: (2 + 2 * a.iters) * (a.timesteps - 1), card)
    with open(ledger) as f:
        lines = f.read().splitlines()
    if rec["preflight"]["status"] != "ok" or rec["card"] != card or len(lines) != 1:
        raise RuntimeError(f"bench: preflight {rec['preflight']}, card {rec['card']!r}, "
                           f"{len(lines)} ledger lines")
    if rec["use_pallas"] is not True or json.loads(lines[0])["use_pallas"] is not True:
        raise RuntimeError("bench did not record its update tail (use_pallas true)")
    _finite("bench", rec["value"], rec["pairs_per_s"], rec["vs_baseline"], *rec["seconds"],
            *rec["eager_seconds"])
    if "eager_seconds" not in json.loads(lines[0]):
        raise RuntimeError("bench's ledger line lacks the eager chain's seconds")
    print(f"bench: {rec['value']} traj/s (captured chain; calls {rec['seconds']} s; the eager "
          f"chain {rec['eager_seconds']} s), {rec['pairs_per_s']} "
          f"pairs/s, x{rec['vs_baseline']} {rec['baseline_source']}; update tail "
          f"use_pallas={rec['use_pallas']} (record and ledger line) [{card}]")
    return launches


# The kernel's bf16 chain against the plain tail's (batch 256, T=50, gs 7.5):
# both compute the same float32 update and differ in rounding alone (phase 3
# holds them within 2e-5 / 1e-5 on a float32 chain); a rounding difference in
# the carry reaches the later bf16 forwards, so the chains spread further here.
# The limit is ten times the 9.465e-4 this comparison read on an H100
# (700 W) before it was held.
PALLAS_CHAIN_ATOL = 1e-2
# Timed calls an arm, in each lane, for the four benches of 12(b)-(e)
# (their defaults are 5 and 3): every arm is timed captured and eager.
BENCH_ITERS = 2


def phase_bench_r2(card, workdir):
    """12(b): ``bench_r2`` pallas, ablate (batch 256) and paradigms (B=1,
    the full 3x3 grid of windows and tolerances)."""
    from distillation_trajectories_torch.scripts import bench_r2

    flags = ["--exp", "pallas,ablate,paradigms", "--iters", str(BENCH_ITERS), "--base_dir",
             workdir]
    # Each arm: two warm-ups (eager, then the capture) and the timed calls,
    # in both lanes; pallas's kernel arm and the sequential chain one call
    # more (the deviation, the window's reference); the plain tail and the
    # window sampler launch no kernel.
    out, launches = _bench_run(
        "bench_r2", bench_r2, flags,
        lambda a: (2 * (5 + 2 * a.iters) + 4 * (2 + a.iters)) * (a.timesteps - 1), card)
    pallas, ablate, par = out["pallas"], out["ablate"], out["paradigms"]
    _finite("bench_r2", pallas["max_abs_deviation"], pallas["speedup"], ablate["mfu_vs_bf16_peak"],
            *(r["max_abs_dev_vs_exact"] for r in par["rows"]))
    if len(par["rows"]) != 9 or not 0 < ablate["mfu_vs_bf16_peak"] < 1:
        raise RuntimeError(f"bench_r2: {len(par['rows'])} window rows, "
                           f"MFU {ablate['mfu_vs_bf16_peak']}")
    eager = {k: statistics.median(v) for k, v in pallas["eager_seconds"].items()}
    print(f"bench_r2 pallas (batch 256, gs 7.5, T=50, bf16), the plain tail: "
          f"{pallas['jnp_seconds']} s a captured chain = {pallas['traj_per_s_jnp']} traj/s "
          f"(calls {[round(x, 4) for x in pallas['jnp_call_seconds']]}); eager {eager['jnp']:.4f} "
          f"s [{card}]")
    print(f"bench_r2 pallas (batch 256, gs 7.5, T=50, bf16), the Triton kernel: "
          f"{pallas['pallas_seconds']} s a captured chain = {pallas['traj_per_s_pallas']} traj/s "
          f"(calls {[round(x, 4) for x in pallas['pallas_call_seconds']]}); x{pallas['speedup']} "
          f"the plain tail, max abs deviation {pallas['max_abs_deviation']:.3e} (limit "
          f"{PALLAS_CHAIN_ATOL:g}); eager {eager['pallas']:.4f} s, "
          f"x{eager['jnp'] / eager['pallas']:.4f} the eager plain tail [{card}]")
    if not pallas["max_abs_deviation"] <= PALLAS_CHAIN_ATOL:
        raise RuntimeError("bench_r2 pallas: the kernel's chain left the plain tail's by "
                           f"{pallas['max_abs_deviation']:.3e}")
    print(f"bench_r2 ablate (batch 256, gs 3.0, captured): {ablate['ms_per_step_full']} ms a "
          f"step, two forwards {ablate['two_fwd_share']}, upsample "
          f"{ablate['upsample_cost_share']}, tail {ablate['update_tail_share']} of the chain; "
          f"{ablate['per_step_flops']} conv FLOPs a step, MFU {ablate['mfu_vs_bf16_peak']} of 989 "
          f"TFLOP/s; eager medians (s) " + ", ".join(
              f"{k} {statistics.median(v):.4f}" for k, v in ablate["eager_seconds"].items())
          + f" [{card}]")
    print(f"bench_r2 paradigms (B=1, gs 7.5): sequential {par['sequential_seconds']} s captured, "
          f"{par['sequential_eager_seconds']} s eager (the windows' x against it); " + "; ".join(
        f"W={r['window']} tol={r['tol']:g}: {r['sweeps_at_seed3']} sweeps, {r['seconds']} s, "
        f"x{r['speedup_vs_scan']}, gap {r['max_abs_dev_vs_exact']:.2e}" for r in par["rows"])
        + f" [{card}]")
    return launches


def phase_bench_quant(card, workdir):
    """12(c): ``bench_quant --use_checkpoint`` on phase 5's teacher."""
    from distillation_trajectories_torch.scripts import bench_quant

    # Each arm: two warm-ups and the timed calls in both lanes; the
    # calibration chain once.
    rec, launches = _bench_run(
        "bench_quant", bench_quant,
        ["--use_checkpoint", "--iters", str(BENCH_ITERS), "--base_dir", workdir],
        lambda a: (len(a.arm_list) * (2 + 2 * a.iters) + 1) * (a.timesteps - 1), card)
    arms = rec["arms"]
    if rec["weights"] != "teacher-checkpoint" or set(arms) != set(bench_quant.ALL_ARMS):
        raise RuntimeError(f"bench_quant: weights {rec['weights']!r}, arms {sorted(arms)}")
    n = arms["int8"]["census"]["convs"]
    if not (arms["int8"]["census"]["int8_convs"] == n - 1
            and 0 < arms["int8_static_mixed"]["census"]["int8_convs"] < n - 1):
        raise RuntimeError(f"bench_quant: int8 census {[arms[a].get('census') for a in arms]}")
    _finite("bench_quant", *(a["traj_per_s"] for a in arms.values()),
            *(a["endpoint_rel_l2"] for k, a in arms.items() if k != "float"))
    print("bench_quant arms (phase 5's teacher, 256 x 32x32x3, T=50, gs 3.0, captured): "
          + "; ".join(f"{k} {a['traj_per_s']} traj/s" + (
              f" x{a['speedup_vs_float']}, endpoint rel L2 {a['endpoint_rel_l2']:.5f}"
              if k != "float" else "") + f" (eager {_tps(SAMPLES, a['eager_seconds']):.2f})"
              for k, a in arms.items()) + f"; best {rec['int8_mode']} [{card}]")
    return launches


def _progressive_launches(a):
    """Each chain: two warm-ups and the timed calls in both lanes; then the
    quality chains, the w-sweep's and FID's."""
    t, s = a.timesteps - 1, (a.timesteps >> a.rounds) - 1
    sweep = len(a.w_sweep.split(",")) if a.guidance_range and a.w_sweep else 0
    return (2 + 2 * a.iters) * (t + s) + (1 + sweep + (a.fid_samples > 0)) * (t + s)


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
                            flags + ["--measure_only", "--iters", str(BENCH_ITERS),
                                     "--base_dir", workdir],
                            _progressive_launches, card)
        launches += n
        tp, q = rec["throughput"], rec["quality"]
        _finite(label, *(v["traj_per_s"] for v in tp.values()), q["endpoint_mse"],
                *(v["endpoint_mse"] for v in q.get("w_sweep", {}).values()))
        t, s = str(rec["teacher_steps"]), str(rec["final_steps"])
        eager = {k: SAMPLES / statistics.median(tp[k]["eager_seconds"]) for k in (t, s)}
        print(f"{label}: teacher T={t} {tp[t]['traj_per_s']} traj/s, student T={s} "
              f"{tp[s]['traj_per_s']} traj/s (x{tp[s]['traj_per_s'] / tp[t]['traj_per_s']:.2f}), "
              f"captured; eager {eager[t]:.1f} and {eager[s]:.1f} traj/s "
              f"(x{eager[s] / eager[t]:.2f}); endpoint MSE {q['endpoint_mse']:.4g} [{card}]")
    return launches


def _fast_launches(a):
    """The teacher and each arm: two warm-ups, the timed calls in both lanes
    and the quality chain; the calibration chain; the w-sweep's and FID's."""
    t, s = a.teacher_steps - 1, a.student_steps - 1
    arms = a.arms.split(",")
    sweep = len(a.w_sweep.split(",")) if a.w_sweep else 0
    return ((3 + 2 * a.iters) * t + any(x.startswith("int8_static") for x in arms) * s
            + len(arms) * (3 + 2 * a.iters) * s + (sweep + (a.fid_samples > 0)) * (t + s))


def phase_bench_fast(card, workdir):
    """12(e): ``bench_fast`` on phase 5's teacher (T=100) and phase 8(c)'s
    guided steps_50 student, FID on 64 samples."""
    from distillation_trajectories_torch.scripts import bench_fast

    rec, launches = _bench_run(
        "bench_fast", bench_fast,
        ["--teacher_steps", str(TRAIN_T), "--student_steps", str(TRAIN_T // 2),
         "--fid_samples", "64", "--iters", str(BENCH_ITERS), "--base_dir", workdir],
        _fast_launches, card)
    arms = rec["arms"]
    if len(arms) != 5 or rec["fid_features"] != "seeded-random":
        raise RuntimeError(f"bench_fast: arms {sorted(arms)}, features {rec['fid_features']}")
    _finite("bench_fast", *(a["traj_per_s"] for a in arms.values()), rec["fid_teacher_vs_best"],
            *(a["endpoint_mse_vs_teacher"] for k, a in arms.items() if k.startswith("student")),
            *(v["endpoint_mse"] for v in rec["w_sweep_best_arm"].values()))
    print("bench_fast (phase 5's teacher T=100 CFG vs the guided student T=50, captured): "
          + "; ".join(f"{k} {a['traj_per_s']} traj/s" + (
              f" x{a['speedup_vs_teacher']}, endpoint MSE {a['endpoint_mse_vs_teacher']:.4g}"
              if k.startswith("student") else "") + f" (eager {_tps(SAMPLES, a['eager_seconds']):.2f})"
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
EPOCH_TURNS = ("loop", "graph", "graph", "loop")  # 13(d)'s timed turns
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
    follow the rounding alone), held to the second only.  ``rel_limit=None``
    holds the second alone and only reports the first (13(d)'s whole
    rounds, where two eager runs land further apart than 5e-3).  Returns
    the worst relative norm difference and the worst single difference."""
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
                if rel_limit is not None and rel > rel_limit:
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


def _device_events(run):
    """``(name, start µs, end µs)`` of the device's activity during
    ``run()`` under the profiler (device activity only), read from the raw
    Kineto results: building the profiler's event tree takes minutes for
    the 10^5 events of a few eager T=100 chains."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]


def _idle_share(run, n):
    """The device's idle share over ``n`` calls of ``run`` under the
    profiler (device activity only), and its busy ms a call."""
    from distillation_trajectories_torch.utils.profiling import busy_and_window

    events = _device_events(lambda: [run() for _ in range(n)])
    if not events:
        return None, None, 0
    busy, window = busy_and_window((start, end) for _, start, end in events)
    return 1 - busy / window, busy / 1e3 / n, len(events) // n


def _time_lane(lane, cfg, loader, dataset, build):
    """One epoch of ``TRAIN_BATCHES`` through one lane from a fresh state
    (``build(lane) -> (state, epoch function or per-batch step)``), then
    ten more synchronized steps timed one by one and four profiled."""
    from distillation_trajectories_torch.training.loop import run_train_epoch

    state, fn = build(lane)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (state, losses, n), capture_s = _recorded_s(
        "epoch.capture", run_train_epoch, state, train_step=fn, loader=loader, config=cfg,
        device="cuda", progress_desc="", log_label="", log_every=0, use_scan=lane == "graph",
        epoch_fn=fn, dataset_dev=dataset, reduce_loss=False)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    if n != TRAIN_BATCHES or not np.isfinite(losses).all():
        raise RuntimeError(f"{lane}: {n} steps, losses {losses}")
    if lane == "graph":
        captured = fn.captured[0]
        captured.i.zero_()  # replays below read the epoch's first rows again
        step = captured.graph.replay
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


def _lane_turns(label, cfg, loader, dataset, build, card):
    """``TRAIN_BATCHES`` batches a turn, per-batch loop and graph-replayed
    epoch lane in turns (``EPOCH_TURNS``), each turn printed; returns the
    loop's and the graph's median steps (s)."""
    runs = {"loop": [], "graph": []}
    for lane in EPOCH_TURNS:
        runs[lane].append(_time_lane(lane, cfg, loader, dataset, build))
    for lane, recs in runs.items():
        for i, r in enumerate(recs):
            idle = "not measured" if r["idle"] is None else f"{r['idle']:.3f}"
            print(f"{label} {lane} turn {i + 1}: epoch of {TRAIN_BATCHES} batches "
                  f"{r['epoch_s']:.3f} s ({cfg.batch_size * TRAIN_BATCHES / r['epoch_s']:.1f} "
                  f"images/s"
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
    print(f"{label} median step, loop {loop * 1e3:.3f} ms against graph {graph * 1e3:.3f} ms: "
          f"graph / loop {graph / loop:.3f} [{card}]")
    return loop, graph


def _full_width_set(cfg, card, label):
    """The synthetic CIFAR-shaped set's loader (seed 0) and its upload."""
    from distillation_trajectories_torch.data.datasets import DataLoader, load_dataset
    from distillation_trajectories_torch.training.loop import upload_dataset

    images, labels = load_dataset(cfg)
    loader = DataLoader(images, labels, cfg.batch_size, shuffle=True, seed=0)
    t0 = time.perf_counter()
    dataset = upload_dataset(loader, "cuda")
    upload_s = time.perf_counter() - t0
    print(f"{label} dataset upload: {dataset.numel() * 4} bytes ({tuple(dataset.shape)} float32) "
          f"in {upload_s:.4f} s = {dataset.numel() * 4 / upload_s / 1e9:.3f} GB/s [{card}]")
    return loader, dataset


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


PROG_FORMS = {"plain": (None, False), "guided": (PROG_GUIDANCE, False),
              "teacher_guided": (PROG_GUIDANCE, True)}  # 13(d) hold


PROG_PROBES = EPOCH_HOLD_IMAGES // 8  # 13(d): every row of the last epoch, replayed and eager


def _train_tensors(state):
    """Every tensor a train step updates in place: the weights, the
    BatchNorm buffers and the Adam state."""
    params = list(state.model.parameters())
    return [*params, *state.model.buffers(),
            *(t for p in params for t in state.optimizer.state[p].values())]


def _replays_against_eager(label, state, captured, eager_step, dataset, lr):
    """``PROG_PROBES`` steps, each replayed from the graph's state and then
    taken by the eager per-batch step from that same state restored in
    place (weights, buffers, Adam state, the draw generator), on the rows
    of the last epoch.  The loss comes from the forward, which runs no
    atomics, so it is held at rtol 1e-5; the generator must end where the
    replay left it; the weights after the step as :func:`_hold_weights`
    holds one step.  Returns the worst relative loss gap and weight gaps."""
    import copy

    gen, worst = state.draws.generator, [0.0, 0.0, 0.0]
    for k in range(PROG_PROBES):
        tensors = _train_tensors(state)
        before, gen_before = [t.clone() for t in tensors], gen.get_state()
        captured.i.fill_(k)
        captured.graph.replay()
        graph_loss = float(captured.losses[k])
        graph_model, gen_after = copy.deepcopy(state.model), gen.get_state()
        with torch.no_grad():
            for t, b in zip(tensors, before):
                t.copy_(b)
        gen.set_state(gen_before)
        _, loss = eager_step(state, dataset.index_select(0, captured.idx[k]))
        loss = float(loss)
        if abs(graph_loss - loss) > 1e-5 * abs(loss):
            raise RuntimeError(f"{label}: replay {k} loss {graph_loss} against {loss} eager "
                               "from the same state")
        if not torch.equal(gen.get_state(), gen_after):
            raise RuntimeError(f"{label}: replay {k} advanced the generator otherwise than "
                               "the eager step")
        rel, d = _hold_weights(f"{label} replay {k}", graph_model, state.model, 1, lr)
        worst = [max(worst[0], abs(graph_loss - loss) / abs(loss)), max(worst[1], rel),
                 max(worst[2], d)]
    return worst


def _hold_progressive_lane(card):
    """13(d) hold: a progressive round's graph-replayed epoch lane against
    the eager per-batch loop from one seed, for the plain, guided and
    ``teacher_guided`` forms: float32, TF32 off, cuDNN deterministic,
    sf 0.1, 16x16x1, batch 8, teacher T=10 -> S=5, dropout 0.3, two epochs
    of 8 batches; the loop runs twice, as in 13(a).  Whole rounds: the
    draw generators end in the same state and each weight within Adam's
    bound (:func:`_hold_weights` without its norm limit); the losses and
    the weights' relative norm distances are printed against the loop's
    beside the loop's own distance to itself.  The upsample's backward adds
    with atomics in no fixed order, and a progressive round carries that
    rounding further than the teacher's: two eager loops of one round can
    land further apart than 5e-3 in a tensor's relative norm, and a
    replayed round's losses further than 1e-5 from the loop's, while each
    replay equals the eager step from the same state.  So the loss is held
    step by step: ``PROG_PROBES`` replays,
    each against an eager step from the same state
    (:func:`_replays_against_eager`), the loss at rtol 1e-5 and the
    weights after the step as :func:`_hold_weights` holds one step."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.data.datasets import DataLoader
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training import progressive
    from distillation_trajectories_torch.training.loop import run_train_epoch
    from distillation_trajectories_torch.training.state import TorchDraws, create_train_state

    cfg = Config(image_size=16, channels=1, batch_size=8, timesteps=10, sample_steps=10,
                 compute_dtype="float32", dropout=0.3)
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (EPOCH_HOLD_IMAGES, 16, 16, 1)).astype(np.float32)
    labels = np.zeros(EPOCH_HOLD_IMAGES, np.int32)
    dataset = torch.from_numpy(images).cuda()
    dpt, dps = get_diffusion_params(10), get_diffusion_params(5)
    steps = EPOCH_HOLD_EPOCHS * EPOCH_HOLD_IMAGES // 8
    saved, det = _tf32_off(), torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    held = []
    try:
        for form, (guidance_range, teacher_guided) in PROG_FORMS.items():
            teacher = make_unet(cfg, 0.1, seed=9)
            args = (teacher, dpt["alphas"], dps["alphas"], 10, dpt)
            kw = dict(guidance_range=guidance_range, teacher_guided=teacher_guided)
            runs = {}
            for run in ("graph", "loop", "loop again"):
                graph = run == "graph"
                fn = (progressive.make_progressive_epoch_fn if graph
                      else progressive.make_progressive_distill_step)(*args, **kw)
                state = create_train_state(make_unet(cfg, 0.1, seed=3), cfg,
                                           TorchDraws(11, "cuda"))
                loader = DataLoader(images, labels, 8, shuffle=True, seed=7)
                losses = []
                for _ in range(EPOCH_HOLD_EPOCHS):
                    state, l, _ = run_train_epoch(
                        state, train_step=fn, loader=loader, config=cfg, device="cuda",
                        progress_desc="", log_label="", log_every=0, use_scan=graph,
                        epoch_fn=fn, dataset_dev=dataset, reduce_loss=False)
                    losses.append(l)
                torch.cuda.synchronize()
                if graph and not isinstance(fn.captured[0].graph, torch.cuda.CUDAGraph):
                    raise RuntimeError(f"13(d) {form}: the progressive lane captured no CUDA graph")
                runs[run] = (np.concatenate(losses), state, fn)
            want_losses, want, _ = runs["loop"]
            spread = {}
            for run in ("graph", "loop again"):
                losses, state, _ = runs[run]
                if state.step != steps:
                    raise RuntimeError(f"13(d) {form}: {run} took {state.step} steps, not {steps}")
                if not torch.equal(state.draws.generator.get_state(),
                                   want.draws.generator.get_state()):
                    raise RuntimeError(f"13(d) {form}: the {run} left the draw generator "
                                       "elsewhere than the loop")
                if not np.isfinite(losses).all():
                    raise RuntimeError(f"13(d) {form}: {run} losses {losses}")
                spread[run] = (float(np.max(np.abs(losses - want_losses) / np.abs(want_losses))),
                               *_hold_weights(f"13(d) {form} {run}", state.model, want.model,
                                              steps, cfg.lr, rel_limit=None))
            _, g, fn = runs["graph"]
            probes = _replays_against_eager(
                f"13(d) {form}", g, fn.captured[0],
                progressive.make_progressive_distill_step(*args, **kw), dataset, cfg.lr)
            held.append((form, spread, probes))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        torch.backends.cudnn.deterministic = det
    print(f"13(d) progressive round, graph replayed against the eager per-batch loop (f32, TF32 "
          f"off, cuDNN deterministic, sf 0.1, 16x16x1, batch 8, T=10 -> 5, dropout 0.3, "
          f"{EPOCH_HOLD_EPOCHS} epochs of {EPOCH_HOLD_IMAGES // 8} batches, 2 warm-up steps then "
          f"replays; draw generator end states equal) [{card}]")
    for form, spread, (pl, pr, pa) in held:
        print(f"13(d) {form}: " + "; ".join(
            f"{run}: {steps} step losses within rel {l:.3e} of the loop's, weights within rel "
            f"norm {r:.3e} (reported) and abs {a:.3e} (2.2 x {steps} x lr)"
            for run, (l, r, a) in spread.items())
            + f"; {PROG_PROBES} replays against eager steps from the same state: losses within "
            f"rel {pl:.3e} (rtol 1e-5), weights after the step within rel norm {pr:.3e} and abs "
            f"{pa:.3e} (2.2 x lr), generator states equal [{card}]")


def _time_progressive_lanes(card, workdir):
    """13(d) timing: a progressive round from phase 5's teacher at full
    width (sf 1.0, the synthetic CIFAR-shaped set, batch 128, T=100 -> 50,
    bf16, dropout 0.3), plain and guided (w ~ U[1, 5], 4 teacher forwards),
    ``TRAIN_BATCHES`` batches a turn, per-batch loop and graph-replayed
    epoch lane in turns."""
    import copy

    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.scripts._common import load_teacher_from_arg
    from distillation_trajectories_torch.training import progressive
    from distillation_trajectories_torch.training.state import TorchDraws, create_train_state

    cfg = Config(base_dir=workdir, dataset="CIFAR10", timesteps=TRAIN_T, sample_steps=TRAIN_T,
                 limit_batches_per_epoch=TRAIN_BATCHES)
    teacher = load_teacher_from_arg(cfg)
    loader, dataset = _full_width_set(cfg, card, "13(d)")
    n = cfg.teacher_steps
    dpt, dps = get_diffusion_params(n, cfg), get_diffusion_params(n // 2, cfg)
    ratios = []
    for form, guidance_range in (("plain", None), ("guided", PROG_GUIDANCE)):

        def build(lane):
            make = (progressive.make_progressive_epoch_fn if lane == "graph"
                    else progressive.make_progressive_distill_step)
            fn = make(teacher, dpt["alphas"], dps["alphas"], n, dpt,
                      guidance_range=guidance_range)
            return create_train_state(copy.deepcopy(teacher), cfg, TorchDraws(0, "cuda")), fn

        loop, graph = _lane_turns(
            f"13(d) progressive {form} {n} -> {n // 2} (phase 5's teacher, sf 1.0, batch "
            f"{cfg.batch_size}, bf16, dropout {cfg.dropout}, "
            f"{2 if guidance_range is None else 4} teacher forwards)",
            cfg, loader, dataset, build, card)
        ratios.append(f"{form} {graph / loop:.3f}")
    print(f"13(d) progressive graph / loop median step: {', '.join(ratios)} [{card}]")


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
                       ("(c) student group", lambda: _hold_student_group(card, workdir)),
                       ("(d) progressive hold", lambda: _hold_progressive_lane(card)),
                       ("(d) progressive timed turns",
                        lambda: _time_progressive_lanes(card, workdir))):
        t0 = time.perf_counter()
        run()
        print(f"phase epoch lanes {label}: {time.perf_counter() - t0:.1f} s [{card}]")


GRAPH_GS = (2.0, 3.0, 7.5)  # 14(a): one graph serves each


def _hold_sampler_graph(card):
    """14(a): the main path's chain through its maker (sf-1.0 teacher,
    batch 256, 32x32x3, T=50, bf16): the replay against the eager body at
    three guidance scales on one graph and after an in-place weight
    change, the launches by the counter and by device events, no host copy
    in a replay, the plain version never called."""
    from distillation_trajectories_torch import Config
    from distillation_trajectories_torch.diffusion.sampling import CFG_COND_PAIRS
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.trajectories import make_sweep_trajectory_fn
    from distillation_trajectories_torch.trajectories.engine import _sweep_inputs
    from distillation_trajectories_torch.utils import graphs

    cfg = Config(timesteps=MAIN_T, sample_steps=MAIN_T)  # 32x32x3, bf16, cuda
    teacher = make_unet(cfg, size_factor=1.0, seed=0)
    draws = _sweep_inputs(cfg, SAMPLES, 42, MAIN_T, None, "cuda")
    seeds = np.arange(42, 42 + SAMPLES)
    chain = make_sweep_trajectory_fn(teacher, MAIN_T, cfg)
    call = lambda fn, gs, eager=False: fn(  # noqa: E731
        draws.noises, seeds, CFG_COND_PAIRS, gs, step_noise=draws.step_noise, eager=eager)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # earlier phases' cached blocks out of the peaks below
    torch.cuda.reset_peak_memory_stats()
    print(f"14(a) at the start: {torch.cuda.memory_allocated()} bytes allocated, "
          f"{torch.cuda.memory_reserved()} reserved, {graphs._SAMPLER_POOL['graphs']} sampler "
          f"graphs alive [{card}]")
    with _PlainCalls() as plain_calls:
        call(chain, 3.0)  # eager, on a side stream: the warm-up
        torch.cuda.synchronize()
        reserved = [torch.cuda.max_memory_reserved()]
        _, capture_s = _recorded_s("graph.capture", call, chain, 3.0)  # the capture, a replay
        torch.cuda.synchronize()
        reserved.append(torch.cuda.max_memory_reserved())
        for gs in GRAPH_GS:
            before = cfg_engine_update.launches
            got = call(chain, gs)
            made = cfg_engine_update.launches - before
            want = call(chain, gs, eager=True)
            torch.cuda.synchronize()
            gap = float((got.float() - want.float()).abs().max())
            print(f"14(a) replay vs eager at gs {gs}: max abs gap {gap:.3e} (limit 0: the same "
                  f"kernels in the same order), {made} launches counted [{card}]")
            if not torch.equal(got, want) or made != MAIN_T - 1:
                raise RuntimeError(f"the replay at gs {gs} is not the eager chain, or it "
                                   f"counted {made} launches")
            if tuple(got.shape) != (SAMPLES, MAIN_T + 1, 32, 32, 3) or \
                    not torch.isfinite(got).all():
                raise RuntimeError(f"the teacher chain at gs {gs} is not finite or has the wrong "
                                   "shape")
        saved = {k: v.clone() for k, v in teacher.state_dict().items()}
        unchanged = call(chain, 3.0)
        with torch.no_grad():
            for p in teacher.parameters():
                p.mul_(1.01)
        got = call(chain, 3.0)
        want = call(chain, 3.0, eager=True)
        torch.cuda.synchronize()
        gap = float((got.float() - want.float()).abs().max())
        moved = float((got.float() - unchanged.float()).abs().max())
        teacher.load_state_dict(saved)
        print(f"14(a) after the weights x1.01 in place: replay vs eager max abs gap {gap:.3e}, "
              f"{moved:.3e} from the replay before the change [{card}]")
        if not torch.equal(got, want) or moved == 0.0:
            raise RuntimeError("a replay after an in-place weight change is not the eager chain")
    if len(chain.graphs.graphs) != 1 or plain_calls.count:
        raise RuntimeError(f"{len(chain.graphs.graphs)} graphs for one key, the plain version "
                           f"called {plain_calls.count} times")
    (graph,) = chain.graphs.graphs.values()
    events = _device_events(lambda: call(chain, 3.0))
    updates = sum("cfg_engine_update_kernel" in name for name, _, _ in events)
    htod = sorted({name for name, _, _ in events if "HtoD" in name})
    print(f"14(a) one graph for gs {list(GRAPH_GS)} (capture {capture_s:.3f} s, "
          f"{graph.launches[0]} launches a replay by the counter); a traced replay: "
          f"{len(events)} device events, {updates} of cfg_engine_update_kernel, host-to-device "
          f"copies {htod or 'none'}; the plain version called {plain_calls.count} times; peak "
          f"reserved {reserved[0]} bytes after the eager chain, {reserved[1]} after the "
          f"capture, the sampler pool {_pool_bytes()} bytes [{card}]")
    if updates != MAIN_T - 1 or htod:
        raise RuntimeError("a replay did not launch the kernel once a step, or copied from "
                           "the host")
    # The int8 lane's chain captures too (torch._int_mm inside the graph).
    qcfg = Config(timesteps=10, sample_steps=10, sampler_quant="int8")
    qchain = make_sweep_trajectory_fn(teacher, 10, qcfg)
    qdraws = _sweep_inputs(qcfg, 8, 7, 10, None, "cuda")
    qcall = lambda eager=False: qchain(  # noqa: E731
        qdraws.noises, np.arange(7, 15), CFG_COND_PAIRS, 3.0, step_noise=qdraws.step_noise,
        eager=eager)
    qcall()
    got, want = qcall(), qcall(eager=True)
    torch.cuda.synchronize()
    gap = float((got.float() - want.float()).abs().max())
    print(f"14(a) int8 lane (Config.sampler_quant='int8', batch 8, T=10, gs 3.0): "
          f"{len(qchain.graphs.graphs)} graph, replay vs eager max abs gap {gap:.3e} [{card}]")
    if len(qchain.graphs.graphs) != 1 or not torch.equal(got, want):
        raise RuntimeError("the int8 lane's replay is not its eager chain")
    _hold_bench_makers(card)


def _bench_maker_runs():
    """The four benches' chains as each bench builds them, at full width
    (a random sf-1.0 U-Net, batch 256, 32x32x3, T=50, bf16): ``{label:
    (maker, [(value, {"graph": call, "eager": call}), ...])}``, the graph
    call through the maker and the eager call through it with ``eager=True``."""
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.models.quantized import calibrate_activation_scales
    from distillation_trajectories_torch.scripts import bench_quant, bench_r2
    from distillation_trajectories_torch.scripts._common import (
        BenchDraws,
        chain_fn,
        mixed_blocks,
    )
    from distillation_trajectories_torch.training.progressive import make_guided_eval_fn

    draws = BenchDraws("cuda")
    args = bench_r2.parse_args(["--timesteps", str(MAIN_T)])
    cfg, model, model_fn, _, noise = bench_r2._flagship(args, draws, SAMPLES)

    def one(run, gs):
        return [(gs, {"graph": lambda: run(noise, 5, gs),
                      "eager": lambda: run(noise, 5, gs, eager=True)})]

    # bench_r2's kernel arm and bench_fast's teacher arm build the same
    # chain (the sf-1.0 forward, CFG): one maker serves both scales.
    kernel = chain_fn(cfg, draws, MAIN_T, model_fn)
    runs = {"bench_r2 pallas kernel arm (gs 7.5) and bench_fast teacher arm (gs 3.0)": (
        kernel.maker, one(kernel, 7.5) + one(kernel, 3.0))}
    # bench_quant's mixed arm, its static scales from 5 states of a float
    # chain of 32 samples (the bench calibrates on 5 states of a float chain).
    states = kernel(noise[:32], 99, 3.0, eager=True)
    idxs = [0, MAIN_T // 4, MAIN_T // 2, 3 * MAIN_T // 4, MAIN_T - 1]
    ones = torch.ones((len(idxs), 32, 1), device="cuda")
    scales = calibrate_activation_scales(
        model, states[idxs], torch.tensor([[float(MAIN_T - 1 - i)] * 32 for i in idxs],
                                          device="cuda"), ones, ones)
    quant = chain_fn(cfg, draws, MAIN_T, bench_quant._arm_fn(
        "int8_static_mixed", model, scales, mixed_blocks(cfg.image_size)))
    runs["bench_quant int8_static_mixed arm (gs 3.0)"] = (quant.maker, one(quant, 3.0))

    w = torch.zeros((), device="cuda")
    student = chain_fn(cfg, draws, MAIN_T,
                       make_guided_eval_fn(make_unet(cfg, size_factor=1.0, seed=1), w))

    def guided(wv, eager=False):
        w.fill_(wv)
        return student(noise, 5, eager=eager)

    runs["bench_progressive guided student (w 2.0, 5.0)"] = (student.maker, [
        (wv, {"graph": lambda wv=wv: guided(wv),
              "eager": lambda wv=wv: guided(wv, eager=True)}) for wv in (2.0, 5.0)])
    return runs


def _hold_bench_makers(card):
    """14(a): each bench's chain maker at full width: its first call eager,
    its second the capture, then at each value a replay equal to the eager
    body bit for bit with T-1 launches counted, one graph for all values,
    the plain version never called."""
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update

    for label, (maker, calls) in _bench_maker_runs().items():
        t0 = time.perf_counter()
        with _PlainCalls() as plain_calls:
            calls[0][1]["graph"]()  # the eager warm-up
            _, capture_s = _recorded_s("graph.capture", calls[0][1]["graph"])
            gaps = []
            for value, lanes in calls:
                before = cfg_engine_update.launches
                got = lanes["graph"]()
                made = cfg_engine_update.launches - before
                want = lanes["eager"]()
                torch.cuda.synchronize()
                gaps.append(float((got.float() - want.float()).abs().max()))
                if not torch.equal(got, want) or made != MAIN_T - 1:
                    raise RuntimeError(f"14(a) {label}: the replay at {value} is not the eager "
                                       f"chain (max abs gap {gaps[-1]:.3e}), or it counted {made} "
                                       f"launches")
        graphs = list(maker.graphs.graphs.values())
        print(f"14(a) {label}: {len(graphs)} graph (capture {capture_s:.3f} s, "
              f"{graphs[0].launches[0]} launches a replay), replay vs eager max abs gap "
              f"{max(gaps):.3e} at {[v for v, _ in calls]}, the plain version called "
              f"{plain_calls.count} times; {time.perf_counter() - t0:.1f} s [{card}]")
        if len(graphs) != 1 or plain_calls.count:
            raise RuntimeError(f"14(a) {label}: {len(graphs)} graphs, the plain version called "
                               f"{plain_calls.count} times")


def phase_sampler_graphs(card):
    """Phase 14: the samplers' captured lane on the card; returns its
    launches of the kernel."""
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update

    cfg_engine_update.launches = 0
    _hold_sampler_graph(card)
    return cfg_engine_update.launches


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
    adaln_records = phase_adaln(card)
    dit_launches, *adaln_launches = phase_dit(card)
    for r, n in zip(adaln_records, adaln_launches):
        r["launches"] = n
    print(f"phase kernel: {time.perf_counter() - t0:.1f} s (Triton builds included)")
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
        t0 = time.perf_counter()
        graph_launches = phase_sampler_graphs(card)
        print(f"phase sampler graphs: {time.perf_counter() - t0:.1f} s [{card}]")
    total = (dit_launches + launches + cli_launches + clis_launches + edit_launches + lane_launches
             + multi_launches + last_launches + bench_launches + graph_launches)
    print(f"cfg_engine_update launches: {dit_launches} (DiT chain, phase 2) + {launches} "
          f"(main path, phase 4) + {cli_launches} "
          f"(CFG-sweep CLI, phase 6) + {clis_launches} (analysis CLIs, phase 7) + "
          f"{edit_launches} (editing demo, phase 8) + {lane_launches} (the window dispatch's "
          f"sequential chain, phase 9) + {multi_launches} "
          f"(sharded sweep and spatial chains, both ranks, and their references, phase 10) + "
          f"{last_launches} (sampler profiler's warm-up and traced chains, phase 11) + "
          f"{bench_launches} (the five benches, phase 12) + {graph_launches} (the captured "
          f"lane's holds, both lanes, phase 14) = {total}")
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
    }] + [{
        "route": "triton",
        "source": "distillation_trajectories_torch/ops/adaln_triton.py",
        "replaces": None,
        **r,
    } for r in adaln_records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
