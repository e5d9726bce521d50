"""Flags and checkpoint loaders shared by the port's CLIs."""

from __future__ import annotations

import argparse
import os


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


def add_analysis_flags(parser: argparse.ArgumentParser) -> None:
    """The port's flags of every analysis CLI, beside the JAX CLI's own."""
    parser.add_argument("--dataset", type=str, default=None, choices=["MNIST", "CIFAR10"])
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--num_channels", type=int, default=None)
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Override the output root directory "
                        "(checkpoints are read from <base_dir>/output/models)")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on (default: the config's, cuda)")


def analysis_config(args, timesteps=None):
    """The Config of an analysis CLI, its directories created, on the
    resolved device (raises when that is CUDA and no GPU exists).

    As in the JAX CLIs, ``timesteps`` sets ``config.timesteps`` alone:
    ``teacher_steps`` and ``student_steps`` keep the value the Config was
    built with (100 by default), and the trajectory manager's chains run
    on ``teacher_steps``."""
    from ..config import Config, resolve_device

    config = Config(base_dir=args.base_dir) if args.base_dir else Config()
    if args.device is not None:
        config.device = args.device
    if args.dataset:
        config.dataset = args.dataset
    if args.image_size:
        config.image_size = args.image_size
    if args.num_channels:
        config.channels = args.num_channels
    if timesteps:
        config.timesteps = timesteps
    resolve_device(config.device)
    return config.create_directories()


def resolve_output_dir(config, output_dir: str) -> str:
    """``output_dir``, a relative one taken against the config's
    ``base_dir`` (the checkout root unless ``--base_dir`` is given)."""
    if os.path.isabs(output_dir):
        return output_dir
    return os.path.join(config.base_dir, output_dir)


def load_teacher_from_arg(config, teacher_model_arg=None):
    """The sf-1.0 teacher on ``config.device``, in eval mode, from the
    checkpoint a ``--teacher_model`` name gives (``model_epoch_N``, with any
    extension), or the latest one."""
    import re

    from ..training.students import load_teacher

    epoch = None
    if teacher_model_arg:
        m = re.search(r"model_epoch_(\d+)", teacher_model_arg)
        if m:
            epoch = int(m.group(1))
    return load_teacher(config, epoch)


def load_student(config, size_factor, epoch=None):
    """The student of ``size_factor`` on ``config.device``, in eval mode,
    from its latest (or given-epoch) checkpoint; ``FileNotFoundError``
    when it has none."""
    from ..models import load_unet_variables, make_unet
    from ..training.checkpoints import load_checkpoint, variables_from_checkpoint

    payload = load_checkpoint(config.student_dir(size_factor), epoch)
    model = make_unet(config, size_factor=size_factor)
    return load_unet_variables(model, variables_from_checkpoint(payload)).eval()


def parse_float_list(s):
    return [float(x) for x in s.split(",") if x.strip()]


def plots_available() -> bool:
    """Whether matplotlib imports.  Where it does not (the GPU machine has
    none), a CLI's ``main`` says so and skips its plots; what ``run``
    computed and wrote stands."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("[plots] matplotlib cannot be imported: plots skipped")
        return False
    return True
