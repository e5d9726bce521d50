"""CFG-effectiveness CLI: cosine similarity and Euclidean distance between
paired teacher/student trajectories across sizes and guidance scales (the
flags, defaults, file names and poster colours of
``scripts/analysis/analyze_effectiveness.py``, plus the port's
``--base_dir``, ``--device``, ``--dataset``, ``--image_size`` and
``--num_channels``).

    python -m distillation_trajectories_torch.scripts.analyze_effectiveness --size_factors 0.1,0.5

Two halves: :func:`run` computes the real metrics (:func:`compute_real_metrics`;
the teacher chain of each scale is generated once and shared by every
size, and both metrics are reduced on the device) or, only when the
teacher checkpoint cannot be read, the reference's synthetic
demonstration data; :func:`create_consolidated_cfg_graph` draws the two
PNGs and needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ._common import (
    add_analysis_flags,
    analysis_config,
    load_student,
    load_teacher_from_arg,
    parse_float_list,
    resolve_output_dir,
)

# Poster colors, lightest to darkest.
POSTER_COLORS = [
    "#35b07c", "#41a086", "#47988b", "#4d9090", "#59809a", "#5f789f", "#6b68a9",
]
STANDARD_SIZE_FACTORS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]

Metrics = Dict[float, List[float]]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Consolidated CFG effectiveness graphs across model sizes",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--size_factors", type=str,
                        default="0.1,0.2,0.4,0.6,0.8,1.0")
    parser.add_argument("--guidance_scales", type=str,
                        default="1.0,2.0,3.0,5.0,7.0")
    parser.add_argument("--output_dir", type=str,
                        default="analysis/effectiveness")
    parser.add_argument("--teacher_model", type=str, default=None)
    parser.add_argument("--num_samples", type=int, default=3)
    parser.add_argument("--timesteps", type=int, default=50)
    add_analysis_flags(parser)
    return parser.parse_args(argv)


def make_config(args):
    return analysis_config(args, args.timesteps)


def _pair_metrics(t_trajs, s_trajs):
    """``[2]``: mean per-state cosine similarity and Euclidean distance of
    two ``[S, T+1, ...]`` chain batches, on their device."""
    import torch

    tf = t_trajs.reshape(t_trajs.shape[0], t_trajs.shape[1], -1).float()
    sf = s_trajs.reshape(s_trajs.shape[0], s_trajs.shape[1], -1).float()
    tn = tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True)
    sn = sf / torch.linalg.vector_norm(sf, dim=-1, keepdim=True)
    return torch.stack([torch.mean(torch.sum(tn * sn, dim=-1)),
                        torch.mean(torch.linalg.vector_norm(tf - sf, dim=-1))])


def compute_real_metrics(config, size_factors, guidance_scales, num_samples,
                         teacher_model_arg, draws=None) -> Optional[Tuple[Metrics, Metrics]]:
    """``(cosine, euclid)``, ``{size_factor: [value per scale]}``, for the
    sizes that have a checkpoint; None when the teacher's checkpoint cannot
    be read (``FileNotFoundError`` / ``OSError``) or no student has one.
    Any other error, a missing GPU included, propagates."""
    import torch

    from ..config import resolve_device
    from ..diffusion.sampling import CFG_COND_PAIRS, NOCFG_COND_PAIRS
    from ..trajectories import make_sweep_trajectory_fn
    from ..trajectories.engine import _sweep_inputs

    device = resolve_device(config.device)
    try:
        teacher = load_teacher_from_arg(config, teacher_model_arg)
    except (FileNotFoundError, OSError) as e:
        print(f"Teacher model unavailable ({e}); using synthetic demo data")
        return None

    draws = (_sweep_inputs(config, num_samples, 0, config.timesteps, device) if draws is None
             else draws.to(device))
    seeds = np.arange(num_samples)
    teacher_fn = make_sweep_trajectory_fn(teacher, config.timesteps, config)
    teacher_chains = {}  # per scale, shared by every size
    rows = {}
    for sf in size_factors:
        try:
            student = load_student(config, sf)
        except FileNotFoundError:
            print(f"No student for size {sf}; skipping")
            continue
        student_fn = make_sweep_trajectory_fn(student, config.timesteps, config)
        row = []
        for gs in guidance_scales:
            pairs = CFG_COND_PAIRS if gs > 1.0 else NOCFG_COND_PAIRS
            if gs not in teacher_chains:
                teacher_chains[gs] = teacher_fn(draws.noises, seeds, pairs, gs,
                                                step_noise=draws.step_noise)
            s = student_fn(draws.noises, seeds, pairs, gs, step_noise=draws.step_noise)
            row.append(_pair_metrics(teacher_chains[gs], s))
        rows[sf] = torch.stack(row)
    if not rows:
        return None
    host = {sf: r.cpu().numpy() for sf, r in rows.items()}
    cosine = {sf: [float(v) for v in h[:, 0]] for sf, h in host.items()}
    euclid = {sf: [float(v) for v in h[:, 1]] for sf, h in host.items()}
    return cosine, euclid


def synthetic_metrics(size_factors, guidance_scales) -> Tuple[Metrics, Metrics]:
    """The reference's synthetic demonstration formulas."""
    cosine, euclid = {}, {}
    mx = max(size_factors)
    for sf in size_factors:
        base_similarity = 0.85 + 0.1 * (1 - sf / mx)
        cosine[sf] = [
            base_similarity + 0.02 * gs * (1 - sf / mx) for gs in guidance_scales
        ]
        base_distance = 0.2 + 0.3 * (sf / mx)
        euclid[sf] = [
            base_distance - 0.03 * gs * (1 - sf / mx) for gs in guidance_scales
        ]
    return cosine, euclid


def run(args, config=None, draws=None) -> Tuple[Metrics, Metrics, str]:
    """``(cosine, euclid, source)``: ``source`` is ``"real"``, or
    ``"synthetic"`` when :func:`compute_real_metrics` found no teacher or
    no student checkpoint."""
    config = make_config(args) if config is None else config
    size_factors = parse_float_list(args.size_factors)
    guidance_scales = parse_float_list(args.guidance_scales)
    real = compute_real_metrics(config, size_factors, guidance_scales, args.num_samples,
                                args.teacher_model, draws)
    if real is not None:
        print("Using real trajectory metrics")
        return (*real, "real")
    print("Using synthetic demonstration data (no trained models found)")
    return (*synthetic_metrics(size_factors, guidance_scales), "synthetic")


def create_consolidated_cfg_graph(output_dir, size_factors, guidance_scales,
                                  cosine, euclid):
    """``consolidated_cfg_metrics.png`` (cosine similarity and Euclidean
    distance vs scale) and ``cfg_effectiveness_ratio.png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    colors = list(POSTER_COLORS)
    while len(colors) < len(STANDARD_SIZE_FACTORS):
        colors += colors
    color_mapping = {
        sf: colors[i % len(colors)] for i, sf in enumerate(STANDARD_SIZE_FACTORS)
    }

    plt.figure(figsize=(12, 10))
    plt.subplot(2, 1, 1)
    for sf in size_factors:
        if sf not in cosine:
            continue
        plt.plot(guidance_scales, cosine[sf], "-o",
                 color=color_mapping.get(sf, colors[0]),
                 label=f"Size {sf}")
    plt.title("Cosine Similarity vs Guidance Scale")
    plt.xlabel("Guidance Scale")
    plt.ylabel("Cosine Similarity")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.7)

    plt.subplot(2, 1, 2)
    for sf in size_factors:
        if sf not in euclid:
            continue
        plt.plot(guidance_scales, euclid[sf], "-o",
                 color=color_mapping.get(sf, colors[0]),
                 label=f"Size {sf}")
    plt.title("Euclidean Distance vs Guidance Scale")
    plt.xlabel("Guidance Scale")
    plt.ylabel("Euclidean Distance")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.7)
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "consolidated_cfg_metrics.png"),
                dpi=300, bbox_inches="tight")
    plt.close()

    # Effectiveness ratio: similarity gain per unit guidance
    plt.figure(figsize=(12, 6))
    for sf in size_factors:
        if sf not in cosine:
            continue
        base = cosine[sf][0]
        ratio = [
            (c - base) / gs if gs > 0 else 0.0
            for c, gs in zip(cosine[sf], guidance_scales)
        ]
        plt.plot(guidance_scales, ratio, "-o",
                 color=color_mapping.get(sf, colors[0]), label=f"Size {sf}")
    plt.title("CFG Effectiveness Ratio by Model Size")
    plt.xlabel("Guidance Scale")
    plt.ylabel("Effectiveness (Δ similarity / scale)")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.7)
    plt.savefig(os.path.join(output_dir, "cfg_effectiveness_ratio.png"),
                dpi=300, bbox_inches="tight")
    plt.close()
    print(f"Saved consolidated CFG graphs to {output_dir}")


def main(argv=None, draws=None):
    args = parse_args(argv)
    config = make_config(args)
    cosine, euclid, source = run(args, config, draws)
    output_dir = resolve_output_dir(config, args.output_dir)
    create_consolidated_cfg_graph(output_dir, parse_float_list(args.size_factors),
                                  parse_float_list(args.guidance_scales), cosine, euclid)
    return cosine, euclid, source


if __name__ == "__main__":
    main()
