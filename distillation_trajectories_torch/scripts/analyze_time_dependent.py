"""Time-dependent distance CLI: per-timestep consecutive-step distances and
the trajectory metric suite across student sizes (the flags and file names
of ``scripts/analysis/analyze_time_dependent.py``, plus the port's
``--base_dir``, ``--device``, ``--dataset``, ``--image_size`` and
``--num_channels``).

    python -m distillation_trajectories_torch.scripts.analyze_time_dependent --size_factors 0.1,0.5

Per size, in order: the ``TrajectoryManager`` generates and saves
``num_samples`` pairs in one batch, loads them back, takes their
consecutive-step distances and scores them with the metric suite.  As in
the JAX CLI, ``--timesteps`` sets ``config.timesteps`` only, and the
manager's chains run on ``config.teacher_steps``.  Two halves: :func:`run`
(no plotting library; the npz files are written) and :func:`plot`, the
per-size distance PNGs and the four cross-size plots.
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
        description="Per-timestep distance analysis across model sizes",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--teacher_model", type=str, default=None)
    parser.add_argument("--size_factors", type=str, default="0.1,0.5,1.0")
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--timesteps", type=int, default=50)
    add_analysis_flags(parser)
    return parser.parse_args(argv)


def make_config(args):
    return analysis_config(args, args.timesteps)


def run(args, config=None, draws=None) -> Tuple[Dict[float, dict], Dict[float, dict]]:
    """``(time_distances, all_metrics)`` by size factor.  ``draws`` (a
    ``SweepDraws``: ``[S, H, W, C]`` noises, ``[T-1, S, H, W, C]`` step
    noise and optionally the ``[S, T+1, H·W·C]`` Wasserstein keys) replaces
    the manager's default draws; every size gets the same draws."""
    from ..config import resolve_device
    from ..metrics.time_dependent import time_dependent_distances
    from ..trajectories import TrajectoryManager

    config = make_config(args) if config is None else config
    resolve_device(config.device)
    teacher = load_teacher_from_arg(config, args.teacher_model)
    time_distances, all_metrics = {}, {}
    for sf in parse_float_list(args.size_factors):
        try:
            student = load_student(config, sf)
        except FileNotFoundError:
            print(f"No student model for size {sf}; skipping")
            continue
        manager = TrajectoryManager(teacher, student, config, size_factor=sf)
        if draws is None:
            manager.generate_and_save_trajectories(num_samples=args.num_samples)
        else:
            manager.generate_and_save_trajectories(num_samples=args.num_samples,
                                                   noises=draws.noises,
                                                   step_noise=draws.step_noise)
        pairs = manager.load_trajectories()
        time_distances[sf] = time_dependent_distances(
            [p[0] for p in pairs], [p[1] for p in pairs], size_factor=sf,
            device=config.device)
        all_metrics[sf] = manager.compute_trajectory_metrics_batch(
            uniforms=None if draws is None else draws.uniforms)
    return time_distances, all_metrics


def plot(time_distances: Dict[float, dict], all_metrics: Dict[float, dict], config) -> None:
    from ..analysis import (
        generate_3d_model_size_visualization,
        plot_time_dependent_combined,
        plot_time_dependent_grid,
        plot_trajectory_divergence_vs_timestep,
    )
    from ..metrics.time_dependent import plot_time_dependent_distances

    for sf, results in time_distances.items():
        plot_time_dependent_distances(results, config.time_dependent_dir, sf)
    plot_time_dependent_grid(time_distances, config)
    plot_time_dependent_combined(time_distances, config)
    plot_trajectory_divergence_vs_timestep(all_metrics, config)
    generate_3d_model_size_visualization(all_metrics, config)


def main(argv=None, draws=None):
    args = parse_args(argv)
    config = make_config(args)
    time_distances, all_metrics = run(args, config, draws)
    plot(time_distances, all_metrics, config)
    return time_distances, all_metrics


if __name__ == "__main__":
    main()
