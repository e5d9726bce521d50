"""On-card measurement of progressive step-halving distillation (the port's
counterpart of the repository's ``scripts/bench_progressive.py``).

    python -m distillation_trajectories_torch.scripts.bench_progressive [--rounds 2] [--epochs 3]
    python -m distillation_trajectories_torch.scripts.bench_progressive --measure_only \\
        --timesteps 100 --guidance_range 1,5 --rounds 1 --w_sweep 1.0,3.0,5.0

Trains ``--rounds`` halvings from the checkpointed teacher with
``training/progressive.py::progressive_distill`` (or, with
``--measure_only``, loads the last round's student from
``progressive[_cfg]/steps_{T/2^rounds}``), then measures:

* traj/s at the teacher's T and the student's: the median of ``--iters``
  timed chains after two warm-ups, each with fresh noise and seed and
  ended by ``torch.cuda.synchronize()`` (every call's seconds kept).  Each
  chain is timed as the JAX bench times its jitted one: on the card a CUDA
  graph (``diffusion/sampling.py::make_chain_fn``, one maker a model and
  T, kept across the calls) whose first call runs eagerly and whose second
  captures; the eager body on the same noise and seeds is timed after
  (``eager_seconds``).  With ``--guidance_range`` the teacher runs its
  two-forward CFG chain at ``--guidance`` and the w-conditioned student
  one guided forward a step;
* quality from the same noise: the endpoint MSE of teacher and student
  chains with their means and spreads, per w of ``--w_sweep`` in guided
  mode (one teacher graph and one student graph serve every w, the
  student's w a tensor changed in place: JAX traces w into its two
  chains, so its teacher runs CFG at every w, 1.0 included), and the two
  sample grids (``utils/viz.py::save_image_grid``) under
  ``<results_dir>/progressive_torch/``;
* with ``--fid_samples N``: FID between N teacher and N student samples
  (fresh noise each) and the teacher's self floor, stamped with the
  Inception features used (``seeded-random`` without pretrained weights).

The record goes to ``<results_dir>/bench_progressive_torch[_cfg].json``
(and ``BENCH_PROG_torch_{tag}.json`` at the repository root with
``--record_tag``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

from ._common import (
    BenchDraws,
    add_bench_flags,
    chain_fn,
    load_model,
    parse_float_list,
    preflight_probe,
    project_root,
    timed_calls,
    write_json,
)


def add_shape_flags(parser) -> None:
    """``--dataset``, ``--image_size`` and ``--channels``: each overrides
    its Config default alone (small shapes for tests)."""
    parser.add_argument("--dataset", type=str, default=None, choices=["MNIST", "CIFAR10"])
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--channels", type=int, default=None)


def bench_config(args):
    """The Config of a bench over checkpoints: ``--base_dir`` and the
    shape flags where given, the Config defaults elsewhere."""
    from ..config import Config, resolve_device

    kw = dict(compute_dtype=args.compute_dtype, device=str(resolve_device(args.device)))
    for name in ("base_dir", "dataset", "image_size", "channels"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    return Config(**kw)


def measure_traj_per_s(run, config, draws, batch, iters=3, guidance_scale=None):
    """``(traj/s, median seconds, every timed call's seconds, the eager
    body's)`` of ``iters`` chains of ``run`` (a :func:`chain_fn`) after two
    warm-ups (the first runs eagerly, the second captures), each from
    fresh noise (drawn outside the timing) and a fresh seed; then the
    eager body on the same noise and seeds."""
    shape = (batch, config.image_size, config.image_size, config.channels)
    calls = [(draws.noise(1000 + i, shape), 1234 + i) for i in range(iters + 2)]

    def timed(todo, eager=False):
        return [timed_calls(lambda seed: run(noise, seed, guidance_scale, eager=eager), [seed],
                            config.device)[0] for noise, seed in todo]

    timed(calls[:2])  # the warm-ups
    seconds = timed(calls[2:])
    eager_seconds = timed(calls[2:], eager=True)
    dt = statistics.median(seconds)
    return batch / dt, dt, seconds, eager_seconds


def fid_columns(config, teacher_set, student_set):
    """``{fid_features, fid_teacher_vs_student, fid_teacher_self_floor}``
    of two sample sets (the floor from the teacher set's halves, where each
    has two samples)."""
    from ..metrics.fid import InceptionModel, calculate_fid

    inception = InceptionModel(device=config.device)
    t_feat = inception.get_features(teacher_set)
    s_feat = inception.get_features(student_set)
    out = {"fid_features": "pretrained-torchvision" if inception.pretrained else "seeded-random",
           "fid_teacher_vs_student": float(calculate_fid(t_feat, s_feat))}
    half = len(t_feat) // 2
    if half >= 2:
        out["fid_teacher_self_floor"] = float(calculate_fid(t_feat[:half], t_feat[half:]))
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--timesteps", type=int, default=50)
    parser.add_argument("--limit_batches", type=int, default=None)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--quality_samples", type=int, default=8)
    parser.add_argument("--guidance_range", type=str, default=None,
                        help="lo,hi: guided distillation; the w-conditioned student is "
                        "benched against the teacher's two-forward CFG chain at --guidance")
    parser.add_argument("--guidance", type=float, default=3.0)
    parser.add_argument("--measure_only", action="store_true",
                        help="Skip training: load the last round's student from "
                        "progressive[_cfg]/steps_{T/2^rounds}")
    parser.add_argument("--fid_samples", type=int, default=0)
    parser.add_argument("--record_tag", type=str, default=None,
                        help="also write BENCH_PROG_torch_{tag}.json at the repo root")
    parser.add_argument("--w_sweep", type=str, default=None,
                        help="comma list of guidance scales: in --guidance_range mode, the "
                        "endpoint MSE of teacher CFG and student chains at each")
    parser.add_argument("--size_factor", type=float, default=1.0)
    add_shape_flags(parser)
    add_bench_flags(parser)
    return parser.parse_args(argv)


def run(args, draws=None) -> dict:
    """Train (or load) the students, then measure: the record."""
    import torch

    from ..training.progressive import make_guided_eval_fn, progressive_distill
    from ..training.state import make_eval_model_fn
    from ..utils.viz import save_image_grid

    probe = preflight_probe(args.device)
    config = bench_config(args)
    draws = draws or BenchDraws(config.device)
    config.teacher_steps = args.timesteps
    if args.limit_batches:
        config.limit_batches_per_epoch = args.limit_batches
    config.create_directories()
    out_dir = os.path.join(config.results_dir, "progressive_torch")
    os.makedirs(out_dir, exist_ok=True)

    teacher = load_model(config, config.teacher_models_dir, args.size_factor)
    grange = parse_float_list(args.guidance_range) if args.guidance_range else None
    if args.measure_only:
        fast_steps = args.timesteps >> args.rounds
        family = "progressive_cfg" if grange else "progressive"
        ckpt_dir = os.path.join(config.models_dir, family, f"steps_{fast_steps}")
        student = load_model(config, ckpt_dir, args.size_factor)
        train_s = 0.0
        print(f"[progressive] measure-only: loaded {ckpt_dir}")
    else:
        t0 = time.perf_counter()
        student, fast_steps = progressive_distill(
            config, teacher, rounds=args.rounds, seed=0, epochs_per_round=args.epochs,
            guidance_range=tuple(grange) if grange else None)
        train_s = time.perf_counter() - t0
        student.eval()

    w = args.guidance
    teacher_fn = make_eval_model_fn(teacher)
    student_fn = make_guided_eval_fn(student, w) if grange else make_eval_model_fn(student)
    teacher_g = w if grange else None
    result = {
        "preflight": {"status": probe["status"], "detail": probe["detail"]},
        "card": probe["detail"] if probe["status"] == "ok" else None,
        "device": config.device,
        "teacher_steps": args.timesteps,
        "final_steps": fast_steps,
        "rounds": args.rounds,
        "epochs_per_round": args.epochs,
        "train_seconds": round(train_s, 1),
        "guidance_range": args.guidance_range,
        "guidance": w if grange else None,
        "throughput": {},
        "quality": {},
    }
    t_run = chain_fn(config, draws, args.timesteps, teacher_fn)
    s_run = chain_fn(config, draws, fast_steps, student_fn)
    for label, steps, run, g in ((f"teacher/T{args.timesteps}", args.timesteps, t_run, teacher_g),
                                 (f"student/T{fast_steps}", fast_steps, s_run, None)):
        tps, dt, seconds, eager_seconds = measure_traj_per_s(
            run, config, draws, args.batch, iters=args.iters, guidance_scale=g)
        result["throughput"][str(steps)] = {"traj_per_s": round(tps, 1),
                                            "batch_seconds": round(dt, 4),
                                            "call_seconds": seconds,
                                            "eager_seconds": eager_seconds}
        print(f"[progressive] {label}: {tps:.1f} traj/s (eager "
              f"{args.batch / statistics.median(eager_seconds):.1f})")

    # Quality: the same starting noise through the teacher's T-step chain
    # and the student's.
    shape = (args.quality_samples, config.image_size, config.image_size, config.channels)
    noise = draws.noise(7, shape)
    t_final = t_run(noise, 11, teacher_g)[-1].float().cpu().numpy()
    s_final = s_run(noise, 11)[-1].float().cpu().numpy()
    result["quality"] = {
        "endpoint_mse": float(((t_final - s_final) ** 2).mean()),
        "teacher_mean": float(t_final.mean()), "teacher_std": float(t_final.std()),
        "student_mean": float(s_final.mean()), "student_std": float(s_final.std()),
    }
    if grange and args.w_sweep:
        # JAX jits each chain once with w traced: the teacher's CFG chain
        # (CFG at every w) and the student's, its w a tensor set in place.
        sweep, wv_t = {}, torch.zeros((), device=config.device)
        s_sweep = chain_fn(config, draws, fast_steps, make_guided_eval_fn(student, wv_t))
        for wv in parse_float_list(args.w_sweep):
            wv_t.fill_(wv)
            te = t_run(noise, 11, wv, use_cfg=True)[-1].float().cpu().numpy()
            se = s_sweep(noise, 11)[-1].float().cpu().numpy()
            sweep[str(wv)] = {"endpoint_mse": float(((te - se) ** 2).mean()),
                              "teacher_std": float(te.std()), "student_std": float(se.std())}
            print(f"[progressive] w={wv}: endpoint MSE {sweep[str(wv)]['endpoint_mse']:.2e}")
        result["quality"]["w_sweep"] = sweep

    sfx = "_cfg" if grange else ""
    save_image_grid(t_final, os.path.join(out_dir, f"teacher_T{args.timesteps}{sfx}.png"), nrow=4)
    save_image_grid(s_final, os.path.join(out_dir, f"student_T{fast_steps}{sfx}.png"), nrow=4)

    if args.fid_samples > 0:
        fid_shape = (args.fid_samples, config.image_size, config.image_size, config.channels)
        t_set = t_run(draws.noise(101, fid_shape), 21, teacher_g)[-1]
        s_set = s_run(draws.noise(202, fid_shape), 22)[-1]
        result["quality"].update(fid_columns(config, t_set, s_set))
        q = result["quality"]
        print(f"[progressive] FID(teacher, student) = {q['fid_teacher_vs_student']:.3g} "
              f"(self floor {q.get('fid_teacher_self_floor', float('nan')):.3g}, "
              f"n={args.fid_samples}, {q['fid_features']} features)")
    return result


def main(argv=None) -> dict:
    args = parse_args(argv)
    result = run(args)
    sfx = "_cfg" if args.guidance_range else ""
    config = bench_config(args)
    path = write_json(os.path.join(config.results_dir, f"bench_progressive_torch{sfx}.json"),
                      result)
    print(f"[progressive] wrote {path}")
    if args.record_tag:
        rec = dict(result, round=args.record_tag, recorded_unix=round(time.time(), 1))
        print(f"[progressive] wrote "
              f"{write_json(os.path.join(project_root, f'BENCH_PROG_torch_{args.record_tag}.json'), rec)}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
