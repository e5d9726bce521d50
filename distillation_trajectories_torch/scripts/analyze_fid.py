"""FID analysis CLI: FID between teacher and student samples per size
factor (the flags of ``scripts/analysis/analyze_fid.py``, plus
``--device``).

    python -m distillation_trajectories_torch.scripts.analyze_fid --size_factors 0.1,0.5,1.0

:func:`run` samples, featurizes and scores every size and writes
``fid_summary.txt`` and ``fid_summary.json`` — both stamped with the
feature provenance (``pretrained-torchvision`` or ``seeded-random``) —
with the per-size score files and sample grids; :func:`plot_fid_vs_size`
draws ``fid_vs_size.png`` and needs matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

from ._common import load_student, load_teacher_from_arg, parse_float_list, plots_available


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="FID analysis across student size factors",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--teacher_model", type=str, default=None)
    parser.add_argument("--size_factors", type=str, default="0.1,0.5,1.0")
    parser.add_argument("--num_samples", type=int, default=50)
    parser.add_argument("--timesteps", type=int, default=None)
    parser.add_argument("--dataset", choices=["MNIST", "CIFAR10"], default=None)
    parser.add_argument("--num_channels", type=int, default=None)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Override the output root directory")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on (default: the config's, cuda)")
    return parser.parse_args(argv)


def make_config(args):
    from ..config import Config

    overrides = {}
    if args.dataset:
        overrides["dataset"] = args.dataset
    if args.num_channels:
        overrides["channels"] = args.num_channels
    if args.image_size:
        overrides["image_size"] = args.image_size
    if args.base_dir:
        overrides["base_dir"] = args.base_dir
    if args.device:
        overrides["device"] = args.device
    config = Config(**overrides)
    if args.timesteps:
        config.timesteps = args.timesteps
        config.sample_steps = args.timesteps
    return config.create_directories()


def run(args, config=None, inception=None, timings: Optional[dict] = None) -> Dict[float, float]:
    """FID of every size factor that has a checkpoint, with the summary
    files; ``inception`` defaults to the InceptionV3 featurizer on the
    config's device."""
    from ..metrics.fid import InceptionModel, fid_across_sizes

    config = make_config(args) if config is None else config
    teacher = load_teacher_from_arg(config, args.teacher_model)
    if inception is None:
        inception = InceptionModel(device=config.device)
    students = {}
    for sf in parse_float_list(args.size_factors):
        try:
            students[sf] = load_student(config, sf)
        except FileNotFoundError:
            print(f"No student model for size {sf}; skipping")
    fid_by_size = fid_across_sizes(teacher, students, config, inception=inception,
                                   num_samples=args.num_samples, timings=timings)
    if fid_by_size:
        pretrained = bool(getattr(inception, "pretrained", False))
        sizes = sorted(fid_by_size)
        with open(os.path.join(config.fid_dir, "fid_summary.txt"), "w") as f:
            # The provenance is in the human-read file too: seeded-random
            # scores are self-consistent but not ImageNet-FID-comparable.
            f.write("features: " + ("pretrained-torchvision" if pretrained else
                                    "seeded-random (NOT ImageNet-FID-comparable; set "
                                    "INCEPTION_WEIGHTS to a torchvision state dict)") + "\n")
            for s in sizes:
                f.write(f"size_{s}: {fid_by_size[s]:.4f}\n")
        with open(os.path.join(config.fid_dir, "fid_summary.json"), "w") as f:
            json.dump({
                "features": "pretrained-torchvision" if pretrained else "seeded-random",
                "imagenet_fid_comparable": pretrained,
                "num_samples": args.num_samples,
                "fid_by_size": {str(s): fid_by_size[s] for s in sizes},
            }, f, indent=2)
            f.write("\n")
    return fid_by_size


def plot_fid_vs_size(fid_by_size: Dict[float, float], fid_dir: str) -> None:
    """``fid_vs_size.png`` (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sizes = sorted(fid_by_size)
    plt.figure(figsize=(10, 6))
    plt.plot(sizes, [fid_by_size[s] for s in sizes], "o-", linewidth=2)
    plt.xlabel("Model Size Factor")
    plt.ylabel("FID (teacher vs student samples)")
    plt.title("FID vs Student Size Factor")
    plt.grid(True, linestyle="--", alpha=0.7)
    plt.savefig(os.path.join(fid_dir, "fid_vs_size.png"), dpi=300, bbox_inches="tight")
    plt.close()


def main(argv=None):
    args = parse_args(argv)
    config = make_config(args)
    fid_by_size = run(args, config)
    if fid_by_size and plots_available():
        plot_fid_vs_size(fid_by_size, config.fid_dir)
    return fid_by_size


if __name__ == "__main__":
    main()
