"""On-card sampler experiments (the port's counterpart of the repository's
``scripts/bench_r2.py``): the Triton update kernel against the plain
PyTorch tail, sliding-window ParaDiGMS latency, and a step-time ablation.

    python -m distillation_trajectories_torch.scripts.bench_r2 --exp pallas      # kernel vs plain tail
    python -m distillation_trajectories_torch.scripts.bench_r2 --exp paradigms   # B=1: chain vs window
    python -m distillation_trajectories_torch.scripts.bench_r2 --exp ablate      # where a step goes

Every experiment runs the flagship sampler: the sf-1.0 U-Net of
``make_unet(seed=0)``, 32x32x3, T=50, bf16 compute.  A timing is the
median of ``--iters`` calls after one warm-up, each call with a fresh seed
and ended by ``torch.cuda.synchronize()``; every call's seconds are kept.
The arms an experiment compares on one workload (``pallas``'s two,
``ablate``'s four) take turns call by call.
Prints one JSON line per experiment and writes them all to
``<results_dir>/bench_r2_torch.json``.

* ``pallas`` (batch 256, guidance 7.5): the chain with the Triton kernel
  (the ``pallas`` arm) against the same chain with
  ``ops.cfg_update.cfg_engine_update_reference`` put in its place for the
  experiment alone (the ``jnp`` arm: the update tail in plain PyTorch, as
  JAX's arm runs it in XLA), after their outputs are compared on one seed
  (``max_abs_deviation``).  The keys are the JAX experiment's.
* ``paradigms`` (batch 1, guidance 7.5): the sequential chain against
  ``sliding_window_trajectory`` at each window x tolerance, with the
  window's sweeps and its largest gap to the sequential chain.
* ``ablate`` (batch 256, guidance 3.0): the full chain; two forwards a step
  with no tail; the same with a nearest-repeat upsample (a ``DenseLayout``
  whose ``up`` repeats, passed to the forward); the tail alone (the step's
  draw and the update kernel).  FLOPs are the convolutions' (``conv_flops``:
  upsampling and elementwise work are not counted), and MFU is read against
  the H100's 989 TFLOP/s dense bf16 peak at a 700 W power limit; the card's
  own limit is in the record.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from unittest import mock

from ._common import (
    BenchDraws,
    add_bench_flags,
    parse_float_list,
    preflight_probe,
    timed_calls,
    write_json,
)

H100_BF16_FLOPS = 989e12  # dense, 700 W (NVIDIA's data sheet, SXM part)


def _flagship(args, draws, batch):
    """``(config, model, model_fn, alphas, noise)`` of the flagship sampler."""
    from ..config import Config, resolve_device
    from ..diffusion import get_diffusion_params
    from ..models import make_unet
    from ..training import make_eval_model_fn

    dev = resolve_device(args.device)
    cfg = Config(base_dir=args.base_dir, timesteps=args.timesteps, sample_steps=args.timesteps,
                 image_size=args.image_size, compute_dtype=args.compute_dtype, device=str(dev))
    model = make_unet(cfg, size_factor=args.size_factor, seed=0)
    alphas = get_diffusion_params(args.timesteps, cfg)["alphas"]
    noise = draws.noise(1, (batch, args.image_size, args.image_size, cfg.channels)).to(dev)
    return cfg, model, make_eval_model_fn(model), alphas, noise


def _time(fn, seeds, device, iters):
    """``(median seconds, every call's seconds)`` of ``iters`` calls
    ``fn(next(seeds))`` after one warm-up call."""
    return _time_arms({"": fn}, seeds, device, iters)[""]


def _time_arms(fns, seeds, device, iters):
    """``{name: (median seconds, every call's seconds)}`` of ``iters`` calls
    of each arm after one warm-up call each.  The arms take turns, each
    round in the order the last one ended with (a, b, b, a, ...), so that
    a drift of the host's speed falls on every arm alike."""
    names = list(fns)
    for name in names:
        timed_calls(fns[name], [next(seeds)], device)
    seconds = {name: [] for name in names}
    for i in range(iters):
        for name in (names if i % 2 == 0 else names[::-1]):
            seconds[name] += timed_calls(fns[name], [next(seeds)], device)
    return {name: (statistics.median(v), v) for name, v in seconds.items()}


def _chain(model_fn, noise, args, alphas, draws, guidance):
    from ..diffusion import generate_trajectory_scan

    return lambda seed: generate_trajectory_scan(
        model_fn, noise, args.timesteps, alphas, seed, guidance_scale=guidance,
        step_noise=draws.step_noise(seed, args.timesteps, noise.shape))


def exp_pallas(args, draws):
    from ..diffusion import sampling
    from ..ops.cfg_update import cfg_engine_update_reference

    batch = args.batch or 256
    cfg, _, model_fn, alphas, noise = _flagship(args, draws, batch)
    kernel = _chain(model_fn, noise, args, alphas, draws, 7.5)

    def plain(seed):
        with mock.patch.object(sampling, "cfg_engine_update", cfg_engine_update_reference):
            return kernel(seed)

    arms = {"jnp": plain, "pallas": kernel}
    a = plain(3)  # parity on the card first
    b = kernel(3)
    max_dev = float((a - b).abs().max())
    seeds = iter(range(100, 200))
    timed = _time_arms(arms, seeds, cfg.device, args.iters)
    (t_base, s_base), (t_pall, s_pall) = timed["jnp"], timed["pallas"]
    result = {
        "exp": "pallas_cfg_update",
        "batch": batch, "timesteps": args.timesteps,
        "jnp_seconds": round(t_base, 4),
        "pallas_seconds": round(t_pall, 4),
        "speedup": round(t_base / t_pall, 4),
        "max_abs_deviation": max_dev,
        "traj_per_s_jnp": round(batch / t_base, 1),
        "traj_per_s_pallas": round(batch / t_pall, 1),
        "jnp_call_seconds": s_base,
        "pallas_call_seconds": s_pall,
    }
    print(json.dumps(result))
    return result


def exp_paradigms(args, draws):
    from ..diffusion.parallel_sampling import sliding_window_trajectory

    cfg, _, model_fn, alphas, noise = _flagship(args, draws, 1)
    seq = _chain(model_fn, noise, args, alphas, draws, 7.5)
    exact = seq(3)
    seeds = iter(range(100, 10_000))
    t_seq, s_seq = _time(seq, seeds, cfg.device, args.iters)
    rows = []
    for window in args.windows:
        for tol in args.tols:
            def win(seed, w=window, tl=tol):
                return sliding_window_trajectory(
                    model_fn, noise, args.timesteps, alphas, seed, guidance_scale=7.5,
                    window=w, tol=tl, step_noise=draws.step_noise(seed, args.timesteps, noise.shape))

            traj, sweeps = win(3)
            dev = float((traj - exact).abs().max())
            t_win, s_win = _time(win, seeds, cfg.device, args.iters)
            rows.append({
                "window": window, "tol": tol,
                "sweeps_at_seed3": int(sweeps),
                "seconds": round(t_win, 4),
                "speedup_vs_scan": round(t_seq / t_win, 3),
                "max_abs_dev_vs_exact": dev,
                "call_seconds": s_win,
            })
            print(json.dumps({"exp": "paradigms", **rows[-1]}))
    result = {
        "exp": "paradigms_summary",
        "batch": 1, "timesteps": args.timesteps,
        "sequential_seconds": round(t_seq, 4),
        "sequential_call_seconds": s_seq,
        "rows": rows,
    }
    print(json.dumps(result))
    return result


def _nearest_layout():
    import torch.nn.functional as F

    from ..models.unet import DenseLayout

    class NearestLayout(DenseLayout):
        """The forward with a nearest-repeat x2 upsample (each pixel
        repeated 2x2, one kernel) in place of the bilinear one."""

        def up(self, h):
            return F.interpolate(h, scale_factor=2, mode="nearest")

    return NearestLayout()


def exp_ablate(args, draws):
    """Step time by ablation: every variant is a loop of T-1 steps, the
    sampler's loop shape, and per-step costs come out of differences."""
    import torch

    from ..diffusion.sampling import engine_update
    from ..utils.profiling import conv_flops

    batch = args.batch or 256
    cfg, model, model_fn, alphas, noise = _flagship(args, draws, batch)
    n_steps = args.timesteps - 1
    dev = noise.device
    tvec = torch.full((batch,), 25.0, device=dev)
    ones = torch.ones((batch, 1), device=dev)
    zeros = torch.zeros((batch, 1), device=dev)
    seeds = iter(range(100, 400))

    flops_step = 2 * conv_flops(model, noise, tvec, ones, ones)

    def two_fwd(fn):
        """Two CFG forwards a step, no update tail, draw or storage."""
        def run(seed):
            x = noise
            for _ in range(n_steps):
                pu = fn(x, tvec, zeros, ones)
                pc = fn(x, tvec, ones, ones)
                x = x + 1e-6 * (pu + 2.0 * pc)  # consume both, keep the carry stable
            return x
        return run

    nearest = _nearest_layout()

    def nearest_fn(x, t, cond, cond_mask):
        with torch.no_grad():
            return model(x, t, cond, cond_mask, layout=nearest)

    def tail_only(seed):
        """The update tail alone: the step's draw and the kernel."""
        x = noise
        step_noise = draws.step_noise(seed, args.timesteps, noise.shape)
        for j, t in enumerate(range(args.timesteps - 1, 0, -1)):
            x = engine_update(x, x * 1e-3, step_noise[j], alphas[t], alphas[t - 1])
        return x

    timed = _time_arms({
        "full": _chain(model_fn, noise, args, alphas, draws, 3.0),  # the real sampler chain
        "two_fwd": two_fwd(model_fn),
        "nearest": two_fwd(nearest_fn),  # with a nearest-repeat upsample
        "tail": tail_only,
    }, seeds, dev, args.iters)
    t_full, t_two, t_two_nou, t_tail = (timed[k][0] for k in ("full", "two_fwd", "nearest", "tail"))
    total_flops = flops_step * n_steps
    result = {
        "exp": "ablate",
        "batch": batch,
        "timesteps": args.timesteps,
        "full_scan_seconds": round(t_full, 4),
        "per_step_flops": flops_step,
        "flops_counted": "convolutions of two forwards (conv_flops); upsampling and "
                         "elementwise work left out",
        "mfu_vs_bf16_peak": round(total_flops / t_full / H100_BF16_FLOPS, 4),
        "peak": "989 TFLOP/s dense bf16, H100 SXM at 700 W (the card's limit: preflight)",
        "two_fwd_scan_seconds": round(t_two, 4),
        "two_fwd_share": round(t_two / t_full, 3),
        "nearest_upsample_scan_seconds": round(t_two_nou, 4),
        "upsample_cost_share": round((t_two - t_two_nou) / t_full, 3),
        "update_tail_scan_seconds": round(t_tail, 4),
        "update_tail_share": round(t_tail / t_full, 4),
        "ms_per_step_full": round(1e3 * t_full / n_steps, 3),
        "ms_per_step_two_fwd": round(1e3 * t_two / n_steps, 3),
        "call_seconds": {name: v[1] for name, v in timed.items()},
    }
    print(json.dumps(result))
    return result


EXPERIMENTS = {"pallas": exp_pallas, "paradigms": exp_paradigms, "ablate": exp_ablate}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--exp", type=str, default="pallas,paradigms")
    parser.add_argument("--batch", type=int, default=None,
                        help="pallas and ablate (default 256; paradigms runs batch 1)")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--timesteps", type=int, default=50)
    parser.add_argument("--size_factor", type=float, default=1.0)
    parser.add_argument("--image_size", type=int, default=32)
    parser.add_argument("--windows", type=lambda s: [int(x) for x in s.split(",")],
                        default=[4, 8, 16])
    parser.add_argument("--tols", type=parse_float_list, default=[1e-3, 3e-3, 1e-2])
    parser.add_argument("--out", type=str, default=None,
                        help="default <results_dir>/bench_r2_torch.json")
    add_bench_flags(parser)
    return parser.parse_args(argv)


def run(args, draws=None) -> dict:
    """The experiments ``args.exp`` names, in order: ``{name: result}``
    with the preflight."""
    from ..config import resolve_device

    probe = preflight_probe(args.device)
    print(f"# preflight: {probe['status']} ({probe['detail']})", file=sys.stderr)
    draws = draws or BenchDraws(resolve_device(args.device))
    out = {"preflight": probe}
    for name in args.exp.split(","):
        out[name.strip()] = EXPERIMENTS[name.strip()](args, draws)
    return out


def main(argv=None):
    from ..config import Config

    args = parse_args(argv)
    out = run(args)
    cfg = Config(base_dir=args.base_dir) if args.base_dir else Config()
    path = write_json(args.out or os.path.join(cfg.results_dir, "bench_r2_torch.json"), out)
    print(f"[bench_r2] wrote {path}")
    return out


if __name__ == "__main__":
    main()
