"""Dimensionality-reduction CLI: PCA / t-SNE / UMAP embeddings and the 3-D
latent-space views of paired trajectories per student size (the flags and
file names of ``scripts/analysis/analyze_dimensionality.py``, plus the
port's ``--base_dir``, ``--device``, ``--dataset``, ``--image_size`` and
``--num_channels``).

    python -m distillation_trajectories_torch.scripts.analyze_dimensionality --size_factors 0.1,0.5

Per size, a ``TrajectoryManager`` generates one paired batch-1 trajectory
per sample (``generate_trajectory(seed=i)``).  As in the JAX CLI,
``--timesteps`` sets ``config.timesteps`` only, and the manager's chains
run on ``config.teacher_steps`` (100 unless the Config was built with
other timesteps).  Two halves: :func:`run` computes the embeddings and the
joint PCA-3 and imports no plotting library; :func:`plot` draws the PNGs
under ``analysis/dimensionality/size_{sf}/`` and
``analysis/latent_space/size_{sf}/``.
"""

from __future__ import annotations

import argparse
from typing import Dict

from ._common import (
    add_analysis_flags,
    analysis_config,
    load_student,
    load_teacher_from_arg,
    parse_float_list,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Dimensionality-reduction analysis of trajectory pairs",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--teacher_model", type=str, default=None)
    parser.add_argument("--size_factors", type=str, default="0.1,0.5,1.0")
    parser.add_argument("--num_samples", type=int, default=3)
    parser.add_argument("--timesteps", type=int, default=50)
    add_analysis_flags(parser)
    return parser.parse_args(argv)


def make_config(args):
    return analysis_config(args, args.timesteps)


def run(args, config=None, draws=None) -> Dict[float, dict]:
    """``{size_factor: {"pairs": [(teacher, student)], "embeddings": [...],
    "latent": {...}}}`` for every size with a checkpoint.  ``draws`` (a
    ``SweepDraws`` of ``[S, H, W, C]`` noises and ``[T-1, S, H, W, C]``
    step noise, T = ``config.teacher_steps``) replaces the manager's
    default draws of ``(i, t)``; every size gets the same draws."""
    from ..analysis.dimensionality import dimensionality_embeddings
    from ..analysis.latent_space import latent_space_pca
    from ..config import resolve_device
    from ..trajectories import TrajectoryManager

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
        manager = TrajectoryManager(teacher, student, config, size_factor=sf)
        if draws is None:
            pairs = [manager.generate_trajectory(seed=i) for i in range(args.num_samples)]
        else:
            pairs = [manager.generate_trajectory(seed=i, noise=draws.noises[i],
                                                 step_noise=draws.step_noise[:, i])
                     for i in range(args.num_samples)]
        print(f"Performing dimensionality reduction analysis for size factor {sf}...")
        out[sf] = {
            "pairs": pairs,
            "embeddings": dimensionality_embeddings([p[0] for p in pairs],
                                                    [p[1] for p in pairs]),
            "latent": latent_space_pca(pairs[0][0], pairs[0][1]),
        }
    return out


def plot(results: Dict[float, dict], config) -> None:
    """The JAX CLI's PNGs for every size of :func:`run`'s result."""
    import os

    from ..analysis.dimensionality import dimensionality_output_dir, plot_dimensionality
    from ..analysis.latent_space import latent_space_output_dir, plot_latent_space

    for sf, r in results.items():
        output_dir = dimensionality_output_dir(config, sf)
        os.makedirs(output_dir, exist_ok=True)
        plot_dimensionality(r["embeddings"], output_dir, sf)
        plot_latent_space(r["latent"], latent_space_output_dir(config, sf), sf)


def main(argv=None, draws=None):
    args = parse_args(argv)
    config = make_config(args)
    results = run(args, config, draws)
    plot(results, config)
    return results


if __name__ == "__main__":
    main()
