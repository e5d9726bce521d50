"""Capture and summarize an op-level profile of the flagship sampler (the
port's counterpart of the repository's ``scripts/profile_sampler.py``).

    python -m distillation_trajectories_torch.scripts.profile_sampler [--logdir /tmp/dtt_profile]

``capture`` runs the sf-1.0 teacher's two-forward CFG chain (batch 256,
32x32x3, T=50, guidance 3.0, bf16), the makers' compiled chain, twice as a
warm-up (on the card the first runs eagerly, the second captures the CUDA
graph), then three chains (seeds 1-3, on the card three replays) under
``torch.profiler``: device activity on the card, CPU operators on the CPU
(``--device cpu``).  Every chain's update tail is the Triton kernel
``cfg_engine_update_kernel`` on the card (T-1 launches a chain).  The trace is written as ``sampler_trace.json`` under ``--logdir``.
``summarize`` reads the newest trace there and prints one row per name
(launches, total ms, share of the busy time), longest first, with the busy
time and the idle share of the traced window.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

TRACE_NAME = "sampler_trace.json"
GUIDANCE = 3.0
# Kineto drops device records whose converted timestamps fall outside the
# traced window; an idle margin at each end keeps the chains' first and last
# kernels inside it.
EDGE_S = 0.05


def capture(logdir, batch=256, device="cuda", size_factor=1.0, image_size=32, timesteps=50,
            compute_dtype="bfloat16", noise=None, step_noise=None):
    """Trace three chains of the flagship sampler into ``logdir``; returns
    ``(trace path, the last chain's [T+1, batch, H, W, C] trajectory)``.

    The defaults are the JAX script's.  The tests pass smaller sizes, float32
    and the draws: ``noise`` (``[batch, H, W, C]``; by default drawn from a
    ``torch.Generator`` seeded 1 on ``device``) and ``step_noise``, a map
    from each seed (0 for the warm-up, 1-3) to its ``[T-1, batch, H, W, C]``
    step noise (by default each chain draws its own from its seed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..config import Config, resolve_device
    from ..diffusion import get_diffusion_params
    from ..diffusion.sampling import CFG_COND_PAIRS, draw_step_noise, make_batch_chain_fn
    from ..models import make_unet
    from ..training import make_eval_model_fn
    from ..utils.graphs import sampler_lane_captures

    dev = resolve_device(device)
    config = Config(timesteps=timesteps, sample_steps=timesteps, image_size=image_size,
                    compute_dtype=compute_dtype, device=str(dev))
    model_fn = make_eval_model_fn(make_unet(config, size_factor=size_factor, seed=0))
    alphas = get_diffusion_params(timesteps, config)["alphas"]
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(1)
        noise = torch.randn((batch, image_size, image_size, config.channels),
                            generator=gen, device=dev)
    noise = noise.to(dev)

    chain = make_batch_chain_fn(model_fn, timesteps, alphas, captures=sampler_lane_captures)

    def run(seed):
        draw = (draw_step_noise([seed], timesteps, noise.shape, dev)[:, 0]
                if step_noise is None else step_noise[seed])
        return chain(noise, None, CFG_COND_PAIRS, GUIDANCE, step_noise=draw).transpose(0, 1)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    run(0)
    run(0)
    sync()
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        time.sleep(EDGE_S)
        for seed in (1, 2, 3):
            out = run(seed)
        sync()
        time.sleep(EDGE_S)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_NAME)
    prof.export_chrome_trace(path)
    return path, out


def summarize(logdir, top=25):
    """Print the newest trace under ``logdir``: its ``top`` rows and the
    busy time and idle share of its window; returns its
    :class:`..utils.profiling.TraceSummary`."""
    from ..utils.profiling import trace_summary

    traces = glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
    if not traces:
        raise SystemExit(f"no trace under {logdir}")
    summary = trace_summary(max(traces, key=os.path.getmtime))
    what = ("device kernels (self time)" if summary.on_device
            else "CPU operators (inclusive time)")
    print(f"# {summary.path}: {what}")
    print(f"{'launches':>9} {'total ms':>11} {'share':>7}  name (share: of the busy time)")
    for name, n, us in summary.rows[:top]:
        print(f"{n:>9} {us / 1e3:>11.3f} {us / summary.busy_us:>7.1%}  {name}")
    print(f"{'device' if summary.on_device else 'CPU'} busy {summary.busy_us / 1e3:.3f} ms of a "
          f"{summary.window_us / 1e3:.3f} ms window, idle share {summary.idle_share:.3f}")
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--logdir", default="/tmp/dtt_profile")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--skip-capture", action="store_true")
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--device", default="cuda",
                        help="Device to sample on (cuda raises without a GPU)")
    args = parser.parse_args(argv)
    if not args.skip_capture:
        capture(args.logdir, batch=args.batch, device=args.device)
    summarize(args.logdir, top=args.top)


if __name__ == "__main__":
    main()
