"""Progressive step-halving distillation CLI (the flags of
``scripts/train_progressive.py``, plus ``--device``).

    python -m distillation_trajectories_torch.scripts.train_progressive --rounds 2

Reads the teacher from the usual checkpoint directory (``model_epoch_N``)
and writes each round's student to ``output/models/progressive/steps_{n}/``
(``progressive_cfg/`` with ``--guidance_range``).  ``--timesteps`` sets the
teacher's step count to start halving from (``teacher_steps``), as in JAX.
"""

from __future__ import annotations

import argparse

from ._common import load_teacher_from_arg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Progressive step-halving distillation",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--teacher_model", type=str, default=None,
                        help="Teacher checkpoint name (model_epoch_N); latest when omitted")
    parser.add_argument("--rounds", type=int, default=2, help="Number of step-halvings")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Epochs per round (Config.epochs when omitted)")
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--timesteps", type=int, default=None,
                        help="Teacher sampling steps to start halving from "
                        "(Config.teacher_steps when omitted)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--limit_batches", type=int, default=None)
    parser.add_argument("--base_dir", type=str, default=None)
    parser.add_argument("--guidance_range", type=str, default=None,
                        help="lo,hi: also distill classifier-free guidance into the "
                        "student (w ~ U[lo,hi] per sample); checkpoints go to "
                        "progressive_cfg/steps_{n}/")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to train on (default: the config's, cuda)")
    return parser.parse_args(argv)


def make_config(args):
    from ..config import Config, resolve_device

    config = Config(base_dir=args.base_dir) if args.base_dir else Config()
    if args.device is not None:
        config.device = args.device
    if args.dataset:
        config.dataset = args.dataset
    if args.image_size:
        config.image_size = args.image_size
    if args.batch_size:
        config.batch_size = args.batch_size
    if args.timesteps:
        config.teacher_steps = args.timesteps
    if args.limit_batches:
        config.limit_batches_per_epoch = args.limit_batches
    resolve_device(config.device)
    return config.create_directories()


def main(argv=None, draws=None):
    from ..training import progressive_distill

    args = parse_args(argv)
    config = make_config(args)
    guidance_range = (tuple(float(x) for x in args.guidance_range.split(","))
                      if args.guidance_range else None)
    teacher = load_teacher_from_arg(config, args.teacher_model)
    model, steps = progressive_distill(
        config, teacher, rounds=args.rounds, seed=args.seed, epochs_per_round=args.epochs,
        guidance_range=guidance_range, draws=draws,
    )
    print(f"[progressive] done: fastest model samples in {steps} steps "
          f"(teacher: {config.teacher_steps})"
          + (f", guidance-conditioned on w in [{args.guidance_range}]"
             if args.guidance_range else ""))
    return model, steps


if __name__ == "__main__":
    main()
