"""On-card A/B/n bench of the sampler's int8 arms (the port's counterpart of
the repository's ``scripts/bench_quant.py``).

    python -m distillation_trajectories_torch.scripts.bench_quant
    python -m distillation_trajectories_torch.scripts.bench_quant --use_checkpoint
    python -m distillation_trajectories_torch.scripts.bench_quant --record_tag t01

Arms, each a T=50 CFG chain (guidance 3.0) of the sf-1.0 U-Net at 256 x
32x32x3 (``models/quantized.py``):

* ``float``             — the plain forward in bf16 (the main path's);
* ``fold``              — BatchNorm folded into the convs, still float;
* ``int8``              — dynamic per-tensor activation scales;
* ``int8_static``       — scales calibrated once on states of the float
  chain (5 chain points x the sampler's unique (cond, mask) rows, on the
  first 32 samples);
* ``int8_static_mixed`` — static scales, int8 only on the Blocks at 8x8 or
  more (``_common.mixed_blocks``).

Method: each arm's chain is timed as the JAX bench times its jitted one:
on the card a CUDA graph (``diffusion/sampling.py::make_chain_fn``), one
per arm.  Per arm two warm-up chains (seed 0; the first runs eagerly, the
second captures), then ``--iters`` timed chains with fresh seeds, each
ended by ``torch.cuda.synchronize()``; traj/s is batch x iters over their
summed seconds, every call's seconds kept (``seconds``).  The arm's eager
body on the same seeds is timed after (``eager_seconds``).  Fidelity: each
arm's first warm-up endpoint against the float arm's, from the same noise
and seed, as relative L2.  The calibration chain runs once, eagerly.  The census counts the convolutions
of one forward (``conv2d`` and ``torch._int_mm`` calls) and how many of
them are int8 products.  The record goes to
``<results_dir>/bench_quant_torch.json`` (and ``BENCH_QUANT_torch_{tag}.json``
at the repository root with ``--record_tag``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ._common import (
    BenchDraws,
    add_bench_flags,
    chain_fn,
    load_model,
    mixed_blocks,
    preflight_probe,
    project_root,
    synchronize,
    timed_calls,
    write_json,
)

ALL_ARMS = ("float", "fold", "int8", "int8_static", "int8_static_mixed")


def conv_census(fn, *inputs) -> dict:
    """``{"convs", "int8_convs"}`` of one call ``fn(*inputs)``: every
    ``conv2d`` and ``torch._int_mm`` call it makes, and the latter alone."""
    from torch.overrides import TorchFunctionMode

    class Census(TorchFunctionMode):
        convs = int8 = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name == "conv2d":
                self.convs += 1
            elif name == "_int_mm":
                self.int8 += 1
            return func(*args, **(kwargs or {}))

    with Census() as census:
        fn(*inputs)
    return {"convs": census.convs + census.int8, "int8_convs": census.int8}


def _arm_fn(arm, model, scales, blocks):
    from ..models.quantized import make_quantized_eval_fn
    from ..training import make_eval_model_fn

    if arm == "float":
        return make_eval_model_fn(model)
    if arm == "fold":
        return make_quantized_eval_fn(model, nbits=None)
    if arm == "int8":
        return make_quantized_eval_fn(model)
    if arm == "int8_static":
        return make_quantized_eval_fn(model, act_scales=scales)
    return make_quantized_eval_fn(model, act_scales=scales, quant_blocks=blocks)


def _model(args, config):
    """``(model, weights)``: the latest teacher checkpoint with
    ``--use_checkpoint`` (a failed load is printed and recorded, and random
    init stands in), else ``make_unet(seed=0)``."""
    from ..models import make_unet

    if args.use_checkpoint:
        try:
            return load_model(config, config.teacher_models_dir, args.size_factor), \
                "teacher-checkpoint"
        except (OSError, ValueError, KeyError, RuntimeError) as e:
            print(f"# checkpoint load failed ({e}); using random init", file=sys.stderr)
            weights = f"random-init (checkpoint load failed: {str(e)[:200]})"
    else:
        weights = "random-init"
    return make_unet(config, size_factor=args.size_factor, seed=0), weights


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--timesteps", type=int, default=50)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--guidance", type=float, default=3.0)
    ap.add_argument("--size_factor", type=float, default=1.0)
    ap.add_argument("--image_size", type=int, default=32)
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--arms", type=str, default=",".join(ALL_ARMS))
    ap.add_argument("--no_census", action="store_true",
                    help="skip the count of int8 convolutions")
    ap.add_argument("--use_checkpoint", action="store_true",
                    help="load the latest teacher checkpoint instead of random-init weights")
    ap.add_argument("--record_tag", type=str, default=None,
                    help="also write BENCH_QUANT_torch_{tag}.json at the repo root")
    ap.add_argument("--out", type=str, default=None,
                    help="default <results_dir>/bench_quant_torch.json")
    add_bench_flags(ap)
    args = ap.parse_args(argv)
    arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    unknown = set(arms) - set(ALL_ARMS)
    if unknown:
        ap.error(f"unknown arms {sorted(unknown)}; choose from {ALL_ARMS}")
    if "float" not in arms:
        arms.insert(0, "float")  # every comparison needs the baseline
    args.arm_list = arms
    return args


def run(args, draws=None, endpoints=None) -> dict:
    """The arms ``args.arm_list`` names, float first: the record.  Where a
    dict ``endpoints`` is given, each arm's endpoint (the warm-up chain's,
    seed 0) goes into it under the arm's name."""
    import torch

    from ..config import Config, resolve_device
    from ..diffusion.sampling import CFG_COND_PAIRS, NOCFG_COND_PAIRS
    from ..models.quantized import calibrate_activation_scales

    probe = preflight_probe(args.device)
    print(f"# preflight: {probe}", file=sys.stderr)
    dev = resolve_device(args.device)
    draws = draws or BenchDraws(dev)
    t_steps = args.timesteps
    config = Config(base_dir=args.base_dir, timesteps=t_steps, sample_steps=t_steps,
                    image_size=args.image_size, channels=args.channels,
                    compute_dtype=args.compute_dtype, device=str(dev))
    model, weights = _model(args, config)
    blocks = mixed_blocks(config.image_size)
    shape = (args.batch, config.image_size, config.image_size, config.channels)
    noise = draws.noise(1, shape).to(dev)

    def bench(fn, label):
        run = chain_fn(config, draws, t_steps, fn)
        t0 = time.perf_counter()
        end = run(noise, 0, args.guidance)[-1].clone()  # the eager warm-up, the arm's endpoint
        run(noise, 0, args.guidance)  # the capture
        synchronize(dev)
        setup_s = time.perf_counter() - t0
        seeds = range(1, args.iters + 1)
        seconds = timed_calls(lambda seed: run(noise, seed, args.guidance), seeds, dev)
        eager_seconds = timed_calls(lambda seed: run(noise, seed, args.guidance, eager=True),
                                    seeds, dev)
        tps = args.batch * args.iters / sum(seconds)
        print(f"# {label}: {tps:.1f} traj/s (first two calls {setup_s:.1f}s; eager "
              f"{args.batch * args.iters / sum(eager_seconds):.1f} traj/s)", file=sys.stderr)
        return tps, setup_s, end, seconds, eager_seconds

    results = {}
    float_fn = _arm_fn("float", model, None, blocks)
    float_tps, float_setup, f_end, f_seconds, f_eager = bench(float_fn, "float")
    kept = {} if endpoints is None else endpoints
    kept["float"] = f_end
    results["float"] = {"traj_per_s": round(float_tps, 2), "setup_s": round(float_setup, 1),
                        "seconds": f_seconds, "eager_seconds": f_eager}

    scales = None
    if any(a.startswith("int8_static") for a in args.arm_list):
        # Calibration states: 5 points along a float chain (activations grow
        # toward the noisy end) x the (cond, cond_mask) rows the sampler
        # feeds the model, on the first cb samples.
        f_chain = chain_fn(config, draws, t_steps, float_fn)(noise, 99, args.guidance, eager=True)
        pairs = CFG_COND_PAIRS if args.guidance > 1.0 else NOCFG_COND_PAIRS
        cb = min(32, args.batch)
        idxs = sorted({0, t_steps // 4, t_steps // 2, (3 * t_steps) // 4, t_steps - 1})
        rows = [(idx, float(c), float(m)) for idx in idxs for c, m in np.unique(pairs, axis=0)]
        t0 = time.perf_counter()
        scales = calibrate_activation_scales(
            model, torch.stack([f_chain[i][:cb] for i, _, _ in rows]),
            torch.tensor([[float(t_steps - 1 - i)] * cb for i, _, _ in rows], device=dev),
            torch.tensor([[[c]] * cb for _, c, _ in rows], device=dev),
            torch.tensor([[[m]] * cb for _, _, m in rows], device=dev))
        del f_chain
        print(f"# calibrated {sum(len(v) for v in scales.values())} static scales in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    for arm in args.arm_list:
        if arm == "float":
            continue
        fn = _arm_fn(arm, model, scales, blocks)
        entry = {}
        if not args.no_census and arm != "fold":
            c = torch.ones((2, 1), device=dev)
            entry["census"] = conv_census(fn, noise[:2], torch.full((2,), 25.0, device=dev), c, c)
        tps, setup_s, end, seconds, eager_seconds = bench(fn, arm)
        kept[arm] = end
        rel = float((end - f_end).norm() / (f_end.norm() + 1e-12))
        entry.update({
            "traj_per_s": round(tps, 2),
            "speedup_vs_float": round(tps / float_tps, 3),
            "endpoint_rel_l2": rel,
            "setup_s": round(setup_s, 1),
            "seconds": seconds,
            "eager_seconds": eager_seconds,
        })
        results[arm] = entry

    int8_arms = {a: r for a, r in results.items() if a.startswith("int8")}
    best = max(int8_arms, key=lambda a: int8_arms[a]["traj_per_s"], default=None)
    return {
        "metric": "int8 sampler A/B (%d-step CFG, sf=%g, %dx%d, B=%d)" % (
            t_steps, args.size_factor, config.image_size, config.image_size, args.batch),
        "float_traj_per_s": round(float_tps, 2),
        "int8_traj_per_s": int8_arms[best]["traj_per_s"] if best else None,
        "int8_mode": best,
        "speedup": int8_arms[best]["speedup_vs_float"] if best else None,
        "endpoint_rel_l2": int8_arms[best]["endpoint_rel_l2"] if best else None,
        "arms": results,
        "mixed_blocks": sorted(blocks),
        "weights": weights,
        "timesteps": t_steps,
        "guidance": args.guidance,
        "iters": args.iters,
        "preflight": probe,
        "card": probe["detail"] if probe["status"] == "ok" else None,
        "device": str(dev),
        "compute_dtype": args.compute_dtype,
        "ts_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }


def main(argv=None) -> dict:
    from ..config import Config

    args = parse_args(argv)
    record = run(args)
    cfg = Config(base_dir=args.base_dir)
    write_json(args.out or os.path.join(cfg.results_dir, "bench_quant_torch.json"), record)
    if args.record_tag:
        write_json(os.path.join(project_root, f"BENCH_QUANT_torch_{args.record_tag}.json"),
                   record)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
