"""The composed fast lane, measured on the card: the w-conditioned progressive
student x the int8 forward (the port's counterpart of the repository's
``scripts/bench_fast.py``).

    python -m distillation_trajectories_torch.scripts.bench_fast
    python -m distillation_trajectories_torch.scripts.bench_fast --teacher_steps 100 \\
        --student_steps 50 --fid_samples 64 --base_dir /data/run1

Baseline: the teacher's two-forward CFG chain at ``--teacher_steps`` and
``--guidance``.  Arms: the guided student (``progressive_cfg/steps_{S}``)
at ``--student_steps``, one forward a step, in ``bf16`` (the model's
compute dtype) / ``int8`` / ``int8_static`` / ``int8_static_mixed``
(``make_guided_eval_fn(quant="int8")``; the static scales calibrated on
5 states of a student chain at every w of ``--w_sweep`` and
``--guidance``).  Method: each chain is timed as the JAX bench times its
jitted one: on the card a CUDA graph (``diffusion/sampling.py::make_chain_fn``,
one maker an arm).  Per arm two warm-up chains (the first runs eagerly,
the second captures), then ``--iters`` timed chains with fresh seeds, each
ended by ``torch.cuda.synchronize()`` (every call's seconds kept), then
the eager body on the same seeds (``eager_seconds``).  The w-sweep's
student is one maker whose ``w`` is a tensor set in place before each
chain.  Quality, so that no speed-up is quoted
without its fidelity: each arm's ``endpoint_mse_vs_teacher`` from the same
noise and seed as a teacher chain; for the fastest arm, the endpoint MSE
against the teacher's CFG chain at each w of ``--w_sweep``, and FID
against the teacher with the teacher's self floor (``--fid_samples``,
stamped ``seeded-random`` without pretrained Inception weights).  The
record goes to ``<results_dir>/bench_fast_torch.json`` (and
``BENCH_FAST_torch_{tag}.json`` at the repository root with
``--record_tag``).
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
    parse_float_list,
    preflight_probe,
    project_root,
    synchronize,
    timed_calls,
    write_json,
)
from .bench_progressive import add_shape_flags, bench_config, fid_columns

ARMS = ("bf16", "int8", "int8_static", "int8_static_mixed")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--teacher_steps", type=int, default=50)
    ap.add_argument("--student_steps", type=int, default=12)
    ap.add_argument("--guidance", type=float, default=3.0)
    ap.add_argument("--w_sweep", type=str, default="1.0,2.0,3.0,5.0,7.5")
    ap.add_argument("--fid_samples", type=int, default=128)
    ap.add_argument("--arms", type=str, default=",".join(ARMS),
                    help="student arms (the teacher baseline always runs)")
    ap.add_argument("--record_tag", type=str, default=None)
    ap.add_argument("--out", type=str, default=None,
                    help="default <results_dir>/bench_fast_torch.json")
    ap.add_argument("--size_factor", type=float, default=1.0)
    add_shape_flags(ap)
    add_bench_flags(ap)
    return ap.parse_args(argv)


def run(args, draws=None) -> dict:
    """The teacher baseline, the student arms, the fastest arm's w-sweep
    and FID: the record."""
    import torch

    from ..models.quantized import calibrate_activation_scales
    from ..training.progressive import make_guided_eval_fn
    from ..training.state import make_eval_model_fn

    probe = preflight_probe(args.device)
    print(f"# preflight: {probe}", file=sys.stderr)
    config = bench_config(args)
    draws = draws or BenchDraws(config.device)
    config.teacher_steps = args.teacher_steps
    teacher = load_model(config, config.teacher_models_dir, args.size_factor)
    ckpt_dir = os.path.join(config.models_dir, "progressive_cfg", f"steps_{args.student_steps}")
    student = load_model(config, ckpt_dir, args.size_factor)
    print(f"# student: {ckpt_dir}", file=sys.stderr)

    w = args.guidance
    hw, dev = config.image_size, config.device
    blocks = mixed_blocks(hw)
    noise = draws.noise(1, (args.batch, hw, hw, config.channels))
    t_run = chain_fn(config, draws, args.teacher_steps, make_eval_model_fn(teacher))

    def bench(run, label, guidance_scale=None):
        t0 = time.perf_counter()
        for _ in range(2):  # the eager warm-up, then the capture
            run(noise, 0, guidance_scale)
        synchronize(dev)
        setup_s = time.perf_counter() - t0
        seeds = range(1, args.iters + 1)
        seconds = timed_calls(lambda seed: run(noise, seed, guidance_scale), seeds, dev)
        eager_seconds = timed_calls(lambda seed: run(noise, seed, guidance_scale, eager=True),
                                    seeds, dev)
        tps = args.batch * args.iters / sum(seconds)
        print(f"# {label}: {tps:.1f} traj/s (first two calls {setup_s:.1f}s; eager "
              f"{args.batch * args.iters / sum(eager_seconds):.1f} traj/s)", file=sys.stderr)
        return tps, setup_s, seconds, eager_seconds

    t_tps, t_setup, t_seconds, t_eager = bench(t_run, f"teacher CFG T{args.teacher_steps}", w)
    t_ref_end = t_run(noise, 99, w)[-1].float()  # the quality reference's seed

    scales = None

    def guided_fn(arm, wv):
        kw = {"bf16": {}, "int8": {"quant": "int8"},
              "int8_static": {"quant": "int8", "act_scales": scales},
              "int8_static_mixed": {"quant": "int8", "act_scales": scales,
                                    "quant_blocks": blocks}}[arm]
        return make_guided_eval_fn(student, wv, **kw)

    results = {"teacher_cfg_bf16": {"steps": args.teacher_steps, "traj_per_s": round(t_tps, 2),
                                    "setup_s": round(t_setup, 1), "seconds": t_seconds,
                                    "eager_seconds": t_eager}}
    runs = {}
    cal_ws = sorted({w, *(parse_float_list(args.w_sweep) if args.w_sweep else [])})
    arms = [a for a in ARMS if a in args.arms.split(",")]
    for arm in arms:
        if arm.startswith("int8_static") and scales is None:
            # Calibration states from a bf16 student chain, at every w the
            # record later evaluates: the static scales must cover the
            # highest-w activations, not only those at --guidance.
            cb = min(32, args.batch)
            cal_run = runs.get("bf16") or chain_fn(config, draws, args.student_steps,
                                                   guided_fn("bf16", w))
            chain = cal_run(noise, 0)[:, :cb]
            ss = args.student_steps
            idxs = sorted({0, ss // 4, ss // 2, (3 * ss) // 4, ss - 1})
            rows = [(i, wv) for i in idxs for wv in cal_ws]
            scales = calibrate_activation_scales(
                student, torch.stack([chain[i] for i, _ in rows]),
                torch.tensor([[float(ss - 1 - i)] * cb for i, _ in rows], device=dev),
                torch.tensor([[[wv]] * cb for _, wv in rows], device=dev),
                torch.ones((len(rows), cb, 1), device=dev))
            del chain
            print(f"# calibrated static scales on {len(idxs)} chain states x {len(cal_ws)} w "
                  f"values", file=sys.stderr)
        run = runs[arm] = chain_fn(config, draws, args.student_steps, guided_fn(arm, w))
        tps, setup_s, seconds, eager_seconds = bench(run, f"student {arm} T{args.student_steps}")
        end = run(noise, 99)[-1].float()
        results[f"student_{arm}"] = {
            "steps": args.student_steps,
            "traj_per_s": round(tps, 2),
            "speedup_vs_teacher": round(tps / t_tps, 3),
            "endpoint_mse_vs_teacher": float(((end - t_ref_end) ** 2).mean()),
            "setup_s": round(setup_s, 1),
            "seconds": seconds,
            "eager_seconds": eager_seconds,
        }

    student_arms = {k: v for k, v in results.items() if k.startswith("student_")}
    best = max(student_arms, key=lambda k: student_arms[k]["traj_per_s"])
    best_name = best.replace("student_", "")
    record = {
        "metric": (f"composed fast lane: w-cond progressive student T{args.student_steps} x quant "
                   f"vs CFG teacher T{args.teacher_steps} (sf={args.size_factor:g}, {hw}x{hw}, "
                   f"B={args.batch}, w={w})"),
        "teacher_traj_per_s": round(t_tps, 2),
        "best_arm": best,
        "best_traj_per_s": student_arms[best]["traj_per_s"],
        "best_speedup": student_arms[best]["speedup_vs_teacher"],
        "arms": results,
        "preflight": probe,
        "card": probe["detail"] if probe["status"] == "ok" else None,
        "device": dev,
        "compute_dtype": args.compute_dtype,
        "ts_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }

    if args.w_sweep:
        # The best arm's student through one maker, its w a tensor set in
        # place before each chain; the teacher as the JAX sweep calls it,
        # at a Python w (CFG above 1.0).
        sweep, wv_t = {}, torch.zeros((), device=dev)
        s_sweep = chain_fn(config, draws, args.student_steps, guided_fn(best_name, wv_t))
        q_noise = draws.noise(7, (min(32, args.batch), hw, hw, config.channels))
        for wv in parse_float_list(args.w_sweep):
            wv_t.fill_(wv)
            te = t_run(q_noise, 11, wv)[-1].float().cpu().numpy()
            se = s_sweep(q_noise, 11)[-1].float().cpu().numpy()
            sweep[str(wv)] = {"endpoint_mse": float(np.mean((te - se) ** 2)),
                              "teacher_std": float(te.std()), "student_std": float(se.std())}
            print(f"# w={wv}: endpoint MSE {sweep[str(wv)]['endpoint_mse']:.2e}", file=sys.stderr)
        record["w_sweep_best_arm"] = sweep

    if args.fid_samples > 0:
        fid_shape = (args.fid_samples, hw, hw, config.channels)
        t_set = t_run(draws.noise(101, fid_shape), 21, w)[-1]
        s_set = runs[best_name](draws.noise(202, fid_shape), 22)[-1]
        fid = fid_columns(config, t_set, s_set)
        record["fid_features"] = fid["fid_features"]
        record["fid_teacher_vs_best"] = fid["fid_teacher_vs_student"]
        if "fid_teacher_self_floor" in fid:
            record["fid_teacher_self_floor"] = fid["fid_teacher_self_floor"]
        print(f"# FID(teacher, {best}) = {record['fid_teacher_vs_best']:.3g} (floor "
              f"{record.get('fid_teacher_self_floor', float('nan')):.3g})", file=sys.stderr)
    return record


def main(argv=None) -> dict:
    args = parse_args(argv)
    record = run(args)
    config = bench_config(args)
    write_json(args.out or os.path.join(config.results_dir, "bench_fast_torch.json"), record)
    if args.record_tag:
        p = write_json(os.path.join(project_root, f"BENCH_FAST_torch_{args.record_tag}.json"),
                       record)
        print(f"# wrote {p}", file=sys.stderr)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
