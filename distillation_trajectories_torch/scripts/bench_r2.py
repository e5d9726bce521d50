"""On-card sampler experiments (the port's counterpart of the repository's
``scripts/bench_r2.py``): the Triton update kernel against the plain
PyTorch tail, sliding-window ParaDiGMS latency, and a step-time ablation.

    python -m distillation_trajectories_torch.scripts.bench_r2 --exp pallas      # kernel vs plain tail
    python -m distillation_trajectories_torch.scripts.bench_r2 --exp paradigms   # B=1: chain vs window
    python -m distillation_trajectories_torch.scripts.bench_r2 --exp ablate      # where a step goes

Every experiment runs the flagship sampler: the sf-1.0 U-Net of
``make_unet(seed=0)``, 32x32x3, T=50, bf16 compute.  Each arm is timed as
the JAX experiment times its jitted chain: on the card a CUDA graph
(``diffusion/sampling.py::make_chain_fn``, or ``utils/graphs.py::CapturedCall``
for the ablation's loops) whose first call runs eagerly and whose second
captures, both left out of the timing, then replays.  A timing is the
median of ``--iters`` calls after those two warm-ups, each call with a
fresh seed and ended by ``torch.cuda.synchronize()``; every call's seconds
are kept, and the same arms' eager bodies are timed the same way beside
them (``eager_seconds``).  The arms an experiment compares on one workload
(``pallas``'s two, ``ablate``'s four, each in both lanes) take turns call
by call.
Prints one JSON line per experiment and writes them all to
``<results_dir>/bench_r2_torch.json``.

* ``pallas`` (batch 256, guidance 7.5): the chain with the Triton kernel
  (the ``pallas`` arm) against the same chain with
  ``ops.cfg_update.cfg_engine_update_row_reference`` put in its place for the
  experiment alone (the ``jnp`` arm: the update tail in plain PyTorch, as
  JAX's arm runs it in XLA), their outputs compared on one seed
  (``max_abs_deviation``).  The keys are the JAX experiment's.
* ``paradigms`` (batch 1, guidance 7.5): the sequential chain, captured
  and eager, against ``sliding_window_trajectory`` at each window x
  tolerance, with the window's sweeps and its largest gap to the
  sequential chain.  The window sampler stays eager (it tests its
  convergence on the host between sweeps), so ``speedup_vs_scan`` divides
  the eager sequential chain's median by the window's; ``lanes`` names
  the lane of each number.
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
import functools
import json
import os
import statistics
import sys
from unittest import mock

from ._common import (
    BenchDraws,
    add_bench_flags,
    chain_fn,
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
    ``fn(next(seeds))`` after two warm-up calls."""
    return _time_arms({"": fn}, seeds, device, iters)[""]


def _time_arms(fns, seeds, device, iters):
    """``{name: (median seconds, every call's seconds)}`` of ``iters`` calls
    of each arm after two warm-up calls each (a captured arm's first call
    runs eagerly and its second captures).  The arms take turns, each
    round in the order the last one ended with (a, b, b, a, ...), so that
    a drift of the host's speed falls on every arm alike."""
    names = list(fns)
    for name in names:
        timed_calls(fns[name], [next(seeds), next(seeds)], device)
    seconds = {name: [] for name in names}
    for i in range(iters):
        for name in (names if i % 2 == 0 else names[::-1]):
            seconds[name] += timed_calls(fns[name], [next(seeds)], device)
    return {name: (statistics.median(v), v) for name, v in seconds.items()}


def _with_eager(arms):
    """``arms`` (each a call ``fn(seed, eager=False)``) and, under
    ``eager_<name>``, the same calls with ``eager=True``: their bodies run
    eagerly."""
    return {**arms, **{f"eager_{name}": functools.partial(fn, eager=True)
                       for name, fn in arms.items()}}


def _eager_seconds(timed):
    """The eager arms' every call's seconds, by arm."""
    return {name[len("eager_"):]: v[1] for name, v in timed.items() if name.startswith("eager_")}


def _chain(cfg, model_fn, noise, draws, guidance):
    """``run(seed, eager=False)``: the chain of ``model_fn`` from ``noise``
    at ``cfg.timesteps`` through its maker (``_common.chain_fn``: on the
    card captured on its second call and replayed, unless ``eager``), its
    step noise drawn inside the call; ``run.maker`` is the maker."""
    chain = chain_fn(cfg, draws, cfg.timesteps, model_fn)
    run = lambda seed, eager=False: chain(noise, seed, guidance, eager=eager)  # noqa: E731
    run.maker = chain.maker
    return run


def _under_plain_tail(run):
    """``run`` with ``cfg_engine_update_row_reference`` in the kernel's
    place (the update tail in plain PyTorch, as JAX's arm runs it in XLA),
    eager or not: the capture records the plain tail, so the replays run
    it."""
    from ..diffusion import sampling
    from ..ops.cfg_update import cfg_engine_update_row_reference

    def call(seed, eager=False):
        with mock.patch.object(sampling, "cfg_engine_update_row",
                               cfg_engine_update_row_reference):
            return run(seed, eager=eager)

    return call


def exp_pallas(args, draws):
    batch = args.batch or 256
    cfg, _, model_fn, _, noise = _flagship(args, draws, batch)
    arms = {"jnp": _under_plain_tail(_chain(cfg, model_fn, noise, draws, 7.5)),
            "pallas": _chain(cfg, model_fn, noise, draws, 7.5)}
    seeds = iter(range(100, 200))
    timed = _time_arms(_with_eager(arms), seeds, cfg.device, args.iters)
    max_dev = float((arms["jnp"](3) - arms["pallas"](3)).abs().max())  # the arms' replays
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
        "eager_seconds": _eager_seconds(timed),
    }
    print(json.dumps(result))
    return result


def exp_paradigms(args, draws):
    from ..diffusion.parallel_sampling import sliding_window_trajectory

    cfg, _, model_fn, alphas, noise = _flagship(args, draws, 1)
    seq = _chain(cfg, model_fn, noise, draws, 7.5)
    seeds = iter(range(100, 10_000))
    timed = _time_arms(_with_eager({"sequential": seq}), seeds, cfg.device, args.iters)
    (t_seq, s_seq), (t_eager, _) = timed["sequential"], timed["eager_sequential"]
    exact = seq(3)
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
                "speedup_vs_scan": round(t_eager / t_win, 3),
                "max_abs_dev_vs_exact": dev,
                "call_seconds": s_win,
            })
            print(json.dumps({"exp": "paradigms", **rows[-1]}))
    result = {
        "exp": "paradigms_summary",
        "batch": 1, "timesteps": args.timesteps,
        "sequential_seconds": round(t_seq, 4),
        "sequential_call_seconds": s_seq,
        "sequential_eager_seconds": round(t_eager, 4),
        "eager_seconds": _eager_seconds(timed),
        "lanes": {"sequential_seconds": "captured chain (replays)",
                  "sequential_eager_seconds": "eager chain",
                  "rows": "eager window sampler; speedup_vs_scan = sequential_eager_seconds / "
                          "seconds"},
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

    from ..diffusion.sampling import _engine_table
    from ..ops import COUNTED
    from ..ops.cfg_update import cfg_engine_update_row
    from ..utils.graphs import CapturedCall, host_to_device, sampler_lane_captures
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

    def loop(body, inputs):
        """``run(seed, eager=False)``: ``body(*inputs(seed))`` through a
        :class:`CapturedCall`, captured where the sampler lane captures
        (``body`` takes the static output as ``out=``)."""
        graphs = CapturedCall(sampler_lane_captures, counted=COUNTED)
        return lambda seed, eager=False: graphs(None, body, *inputs(seed), eager=eager)

    def two_fwd(fn):
        """Two CFG forwards a step, no update tail, draw or storage."""
        def body(x, out=None):
            for _ in range(n_steps):
                pu = fn(x, tvec, zeros, ones)
                pc = fn(x, tvec, ones, ones)
                x = x + 1e-6 * (pu + 2.0 * pc)  # consume both, keep the carry stable
            return x if out is None else out.copy_(x)
        return loop(body, lambda seed: (noise,))

    nearest = _nearest_layout()

    def nearest_fn(x, t, cond, cond_mask):
        with torch.no_grad():
            return model(x, t, cond, cond_mask, layout=nearest)

    def tail(x, step_noise, table, out=None):
        """The update tail alone, as the chain runs it: the kernel on the
        table's row a step."""
        for j in range(args.timesteps - 1):
            eps = x * 1e-3
            x = cfg_engine_update_row(x, eps, eps, step_noise[j], table[j])
        return x if out is None else out.copy_(x)

    def tail_inputs(seed):
        """The step's draw and the scalar table, made a chain as the
        chain makes them."""
        return (noise, draws.step_noise(seed, args.timesteps, noise.shape),
                host_to_device(_engine_table(args.timesteps, alphas), dev))

    timed = _time_arms(_with_eager({
        "full": _chain(cfg, model_fn, noise, draws, 3.0),  # the real sampler chain
        "two_fwd": two_fwd(model_fn),
        "nearest": two_fwd(nearest_fn),  # with a nearest-repeat upsample
        "tail": loop(tail, tail_inputs),
    }), seeds, dev, args.iters)
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
        "call_seconds": {name: v[1] for name, v in timed.items() if not name.startswith("eager_")},
        "eager_seconds": _eager_seconds(timed),
        "eager_full_scan_seconds": round(timed["eager_full"][0], 4),
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
