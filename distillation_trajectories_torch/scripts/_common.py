"""Flags shared by the port's training CLIs."""

from __future__ import annotations

import argparse


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Override the output root directory")
    parser.add_argument("--limit_batches", type=int, default=None,
                        help="Cap batches per epoch (smoke runs)")
    parser.add_argument("--num_samples", type=int, default=None,
                        help="Samples in the sample grid (0 skips grid generation)")
    parser.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                        help="Device mesh (not ported: raises)")
    parser.add_argument("--checkpoint_sharded", action="store_true",
                        help="Orbax sharded checkpoints (not ported: raises)")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to train on (default: the config's, cuda)")


def make_config(args):
    """A Config from parsed flags; raises on the lanes the port lacks."""
    from ..config import Config

    if args.mesh:
        raise NotImplementedError(f"--mesh {args.mesh}: the port trains on one device")
    if args.checkpoint_sharded:
        raise NotImplementedError("--checkpoint_sharded: the orbax lane is not ported")
    config = Config(base_dir=args.base_dir) if args.base_dir else Config()
    if args.device is not None:
        config.device = args.device
    for flag, field in (("noise_schedule", "noise_schedule"), ("dropout", "dropout"),
                        ("sample_mode", "sample_mode"), ("epochs", "epochs"),
                        ("dataset", "dataset"), ("image_size", "image_size"),
                        ("batch_size", "batch_size"), ("limit_batches", "limit_batches_per_epoch"),
                        ("num_samples", "num_samples_to_generate")):
        value = getattr(args, flag, None)
        if value is not None:
            setattr(config, field, value)
    if getattr(args, "full_res_head", False):
        config.full_res_head = True
    if getattr(args, "timesteps", None) is not None:
        config.timesteps = config.sample_steps = args.timesteps
        config.teacher_steps = config.student_steps = args.timesteps
    return config.create_directories()


def add_model_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--dataset", type=str, default=None, choices=["MNIST", "CIFAR10"])
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--timesteps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--noise_schedule", type=str, default=None, choices=["linear", "cosine"])
    parser.add_argument("--dropout", type=float, default=None)
    parser.add_argument("--full_res_head", action="store_true",
                        help="Use the enc1-skip full-resolution decoder head")
    parser.add_argument("--sample_mode", type=str, default=None,
                        choices=["reference", "ancestral"])
