"""Noise-prediction CLI: teacher-vs-student ε̂ accuracy per student size
(the flags of ``scripts/analysis/analyze_noise_prediction.py``, plus the
port's ``--base_dir``, ``--device``, ``--dataset``, ``--image_size`` and
``--num_channels``).

    python -m distillation_trajectories_torch.scripts.analyze_noise_prediction --size_factors 0.1,0.5

Two halves: :func:`run` computes every size's per-timestep metrics on the
device (10 timesteps, 10 real images, the same noise for every size) and
writes ``noise_metrics_size_{sf}.txt``; :func:`plot` draws the two PNGs
per size and needs matplotlib.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

from ._common import (
    add_analysis_flags,
    analysis_config,
    load_student,
    load_teacher_from_arg,
    parse_float_list,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Teacher-vs-student noise-prediction accuracy analysis",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--teacher_model", type=str, default=None)
    parser.add_argument("--size_factors", type=str, default="0.1,0.5,1.0")
    parser.add_argument("--timesteps", type=int, default=None)
    add_analysis_flags(parser)
    return parser.parse_args(argv)


def make_config(args):
    return analysis_config(args, args.timesteps)


def run(args, config=None, noise=None) -> Dict[float, Tuple[dict, dict]]:
    """``{size_factor: (results, samples)}`` of
    ``analysis.noise_prediction.noise_prediction_metrics`` for every size
    with a checkpoint, each size's text file written.  ``noise``
    (``[10, *images.shape]``) replaces the default draw of seed 0."""
    from ..analysis.noise_prediction import (
        noise_prediction_dir,
        noise_prediction_metrics,
        write_noise_metrics,
    )
    from ..config import resolve_device

    config = make_config(args) if config is None else config
    resolve_device(config.device)
    teacher = load_teacher_from_arg(config, args.teacher_model)
    out = {}
    for sf in parse_float_list(args.size_factors):
        try:
            student = load_student(config, sf)
        except FileNotFoundError:
            print(f"No student model for size {sf}; skipping")
            continue
        print(f"Analyzing noise prediction for size factor {sf}...")
        results, samples = noise_prediction_metrics(teacher, student, config, noise=noise)
        write_noise_metrics(results, noise_prediction_dir(config, sf), sf)
        out[sf] = (results, samples)
    return out


def plot(out: Dict[float, Tuple[dict, dict]], config) -> None:
    from ..analysis.noise_prediction import noise_prediction_dir, plot_noise_prediction

    for sf, (results, samples) in out.items():
        plot_noise_prediction(results, samples, noise_prediction_dir(config, sf), sf)


def main(argv=None, noise=None):
    args = parse_args(argv)
    config = make_config(args)
    out = run(args, config, noise)
    plot(out, config)
    return {sf: results for sf, (results, _) in out.items()}


if __name__ == "__main__":
    main()
