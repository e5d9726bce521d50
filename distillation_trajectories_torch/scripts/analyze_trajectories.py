"""Trajectory PCA CLI: one student size against the teacher across a
guidance-scale sweep (the flags, defaults and file names of
``scripts/analysis/analyze_trajectories.py``, plus the port's
``--base_dir``, ``--device``, ``--dataset``, ``--image_size`` and
``--num_channels``).

    python -m distillation_trajectories_torch.scripts.analyze_trajectories --size_factor 0.5

Two halves: :func:`run` loads both models and, per guidance scale, runs
one batch of ``num_samples`` chains per model through
``make_sweep_trajectory_fn`` (CFG pairs above scale 1.0) and averages it
over the samples on the device; the plot functions draw the 2-D/3-D PCA
plots, eight view angles, the final-image strips and the teacher-vs-student
overlay, and need matplotlib.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Tuple

import numpy as np

from ._common import (
    add_analysis_flags,
    analysis_config,
    load_student,
    load_teacher_from_arg,
    parse_float_list,
    resolve_output_dir,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Visualize denoising trajectories under CFG via PCA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--teacher_model", type=str, default=None,
                        help="Teacher checkpoint name; latest when omitted")
    parser.add_argument("--size_factor", type=float, default=0.5,
                        help="Student size factor to compare")
    parser.add_argument("--guidance_scales", type=str,
                        default="1.0,2.0,5.0,10.0,20.0,50.0,100.0",
                        help="Comma-separated guidance scales")
    parser.add_argument("--timesteps", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_samples", type=int, default=5,
                        help="Trajectories averaged per guidance scale")
    parser.add_argument("--output_dir", type=str,
                        default="analysis/trajectories")
    add_analysis_flags(parser)
    return parser.parse_args(argv)


def make_config(args):
    return analysis_config(args, args.timesteps)


def run(args, config=None, draws=None) -> Tuple[Dict[float, np.ndarray], Dict[float, np.ndarray]]:
    """``(teacher_trajs, student_trajs)``: per guidance scale, the chain
    averaged over the samples, ``[T+1, H, W, C]``.  ``draws`` (a
    ``SweepDraws`` of ``[S, H, W, C]`` noises and ``[T-1, S, H, W, C]``
    step noise) replaces the sweep's default draws: sample ``i`` (seed
    ``--seed + i``) from the generators of ``(seed, 0)`` and ``(seed, t)``,
    shared by every scale and both models."""
    import torch

    from ..config import resolve_device
    from ..diffusion.sampling import CFG_COND_PAIRS, NOCFG_COND_PAIRS
    from ..trajectories import make_sweep_trajectory_fn
    from ..trajectories.engine import _sweep_inputs

    config = make_config(args) if config is None else config
    device = resolve_device(config.device)
    guidance_scales = parse_float_list(args.guidance_scales)
    teacher = load_teacher_from_arg(config, args.teacher_model)
    student = load_student(config, args.size_factor)
    draws = (_sweep_inputs(config, args.num_samples, args.seed, config.timesteps, None, device)
             if draws is None else draws.to(device))
    seeds = np.arange(args.seed, args.seed + args.num_samples)
    fns = {"teacher": make_sweep_trajectory_fn(teacher, config.timesteps, config),
           "student": make_sweep_trajectory_fn(student, config.timesteps, config)}

    means = {"teacher": {}, "student": {}}
    for gs in guidance_scales:
        pairs = CFG_COND_PAIRS if gs > 1.0 else NOCFG_COND_PAIRS
        for role, fn in fns.items():
            trajs = fn(draws.noises, seeds, pairs, gs, step_noise=draws.step_noise)
            means[role][gs] = trajs.mean(dim=0)  # elementwise over samples
        print(f"Generated trajectories for guidance scale {gs}")
    host = torch.stack([m.float() for role in means.values() for m in role.values()]).cpu().numpy()
    n = len(guidance_scales)
    return (dict(zip(guidance_scales, host[:n])), dict(zip(guidance_scales, host[n:])))


def _project(features, components, mean):
    return (features - mean) @ components.T


def _pca_fit(features, n=3):
    from ..analysis import pca_fit_transform

    _, _, components, mean = pca_fit_transform(features, n)
    return components, mean


def visualize_trajectories_pca(trajectories, guidance_scales, output_dir,
                               size_factor, model_type):
    """``{model}_trajectories_pca_2d_size_{sf}.png``, ``..._3d_...`` and
    eight ``..._3d_angle_{a}_...`` views, on the PCA of the first scale."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    print(f"Visualizing {model_type} trajectories with PCA...")
    reference = trajectories[guidance_scales[0]]
    components, mean = _pca_fit(reference.reshape(reference.shape[0], -1), 3)

    fig_2d, ax_2d = plt.subplots(figsize=(16, 12))
    fig_3d = plt.figure(figsize=(16, 14))
    ax_3d = fig_3d.add_subplot(111, projection="3d")
    cmap = plt.cm.viridis
    norm = plt.Normalize(min(guidance_scales), max(guidance_scales))

    for g_scale in guidance_scales:
        traj = trajectories[g_scale]
        traj_pca = _project(traj.reshape(traj.shape[0], -1), components, mean)
        color = cmap(norm(g_scale))
        ax_2d.plot(traj_pca[:, 0], traj_pca[:, 1], "-o", color=color,
                   alpha=0.8, markersize=4, label=f"w={g_scale}")
        ax_3d.plot(traj_pca[:, 0], traj_pca[:, 1], traj_pca[:, 2], "-o",
                   color=color, alpha=0.8, markersize=4, label=f"w={g_scale}")
        ax_3d.scatter(*traj_pca[0, :3], color=color, s=100, marker="o",
                      edgecolor="black", linewidth=1.5)
        ax_3d.scatter(*traj_pca[-1, :3], color=color, s=100, marker="*",
                      edgecolor="black", linewidth=1.5)

    ax_2d.legend(bbox_to_anchor=(1.15, 1), loc="upper left", fontsize=10)
    sm = plt.cm.ScalarMappable(cmap=cmap, norm=norm)
    sm.set_array([])
    fig_2d.colorbar(sm, ax=ax_2d, label="Guidance Scale", pad=0.01)
    ax_2d.set_title(
        f"{model_type} Trajectories with Different Guidance Scales (2D)\n"
        f"(Size Factor: {size_factor})"
    )
    ax_2d.set_xlabel("First Principal Component")
    ax_2d.set_ylabel("Second Principal Component")
    ax_3d.set_title(
        f"{model_type} Trajectories with Different Guidance Scales (3D)\n"
        f"(Size Factor: {size_factor})"
    )
    ax_3d.set_xlabel("First Principal Component")
    ax_3d.set_ylabel("Second Principal Component")
    ax_3d.set_zlabel("Third Principal Component")
    ax_3d.legend(bbox_to_anchor=(1.15, 1), loc="upper left", fontsize=10)

    name = model_type.lower()
    path_2d = os.path.join(output_dir, f"{name}_trajectories_pca_2d_size_{size_factor}.png")
    fig_2d.savefig(path_2d)
    print(f"Saving 2D PCA visualization to {path_2d}")
    fig_3d.savefig(os.path.join(output_dir, f"{name}_trajectories_pca_3d_size_{size_factor}.png"))
    for angle in range(0, 360, 45):
        ax_3d.view_init(elev=30, azim=angle)
        fig_3d.savefig(os.path.join(
            output_dir, f"{name}_trajectories_pca_3d_angle_{angle}_size_{size_factor}.png"))
    plt.close(fig_2d)
    plt.close(fig_3d)


def visualize_final_images(trajectories, guidance_scales, output_dir,
                           size_factor, model_type):
    """``{model}_final_images_size_{sf}.png``: the final state per scale."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    print(f"Visualizing {model_type} final images...")
    fig, axes = plt.subplots(1, len(guidance_scales), figsize=(16, 4))
    axes = np.atleast_1d(axes)
    for i, g_scale in enumerate(guidance_scales):
        img = np.clip((np.asarray(trajectories[g_scale][-1]) + 1) / 2, 0, 1)
        if img.shape[-1] == 1:
            img = img[..., 0]
        axes[i].imshow(img, cmap="gray" if img.ndim == 2 else None)
        axes[i].set_title(f"w={g_scale}")
        axes[i].axis("off")
    fig.suptitle(
        f"{model_type} Final Images with Different Guidance Scales "
        f"(Size Factor: {size_factor})"
    )
    plt.tight_layout()
    path = os.path.join(output_dir, f"{model_type.lower()}_final_images_size_{size_factor}.png")
    plt.savefig(path)
    plt.close()
    print(f"Saving final images to {path}")


def visualize_trajectory_comparison(teacher_trajectories, student_trajectories,
                                    guidance_scales, output_dir, size_factor):
    """``comparison_pca_{2d,3d}_size_{sf}.png`` and eight 3-D angles:
    teacher (solid) vs student (dashed) on the teacher's first-scale PCA."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    print("Visualizing teacher vs student trajectory comparison...")
    reference = teacher_trajectories[guidance_scales[0]]
    components, mean = _pca_fit(reference.reshape(reference.shape[0], -1), 3)

    fig_2d, ax_2d = plt.subplots(figsize=(16, 12))
    fig_3d = plt.figure(figsize=(16, 14))
    ax_3d = fig_3d.add_subplot(111, projection="3d")
    cmap = plt.cm.viridis
    norm = plt.Normalize(min(guidance_scales), max(guidance_scales))

    for g_scale in guidance_scales:
        color = cmap(norm(g_scale))
        for trajs, style, label in (
            (teacher_trajectories, "-", "teacher"),
            (student_trajectories, "--", "student"),
        ):
            traj = trajs[g_scale]
            p = _project(traj.reshape(traj.shape[0], -1), components, mean)
            ax_2d.plot(p[:, 0], p[:, 1], style, color=color, alpha=0.8,
                       label=f"{label} w={g_scale}")
            ax_3d.plot(p[:, 0], p[:, 1], p[:, 2], style, color=color,
                       alpha=0.8, label=f"{label} w={g_scale}")

    for ax, dims in ((ax_2d, 2), (ax_3d, 3)):
        ax.set_title(
            f"Teacher vs Student Trajectories ({dims}D)\n"
            f"(Size Factor: {size_factor})"
        )
        ax.set_xlabel("First Principal Component")
        ax.set_ylabel("Second Principal Component")
        ax.legend(bbox_to_anchor=(1.15, 1), loc="upper left", fontsize=8)
    ax_3d.set_zlabel("Third Principal Component")

    fig_2d.savefig(os.path.join(output_dir, f"comparison_pca_2d_size_{size_factor}.png"))
    fig_3d.savefig(os.path.join(output_dir, f"comparison_pca_3d_size_{size_factor}.png"))
    for angle in range(0, 360, 45):
        ax_3d.view_init(elev=30, azim=angle)
        fig_3d.savefig(os.path.join(
            output_dir, f"comparison_pca_3d_angle_{angle}_size_{size_factor}.png"))
    plt.close(fig_2d)
    plt.close(fig_3d)


def plot_all(teacher_trajs, student_trajs, guidance_scales, output_dir, size_factor) -> None:
    """Every PNG of the JAX CLI into ``output_dir``."""
    os.makedirs(output_dir, exist_ok=True)
    for trajs, model_type in ((teacher_trajs, "Teacher"), (student_trajs, "Student")):
        visualize_trajectories_pca(trajs, guidance_scales, output_dir, size_factor, model_type)
        visualize_final_images(trajs, guidance_scales, output_dir, size_factor, model_type)
    visualize_trajectory_comparison(teacher_trajs, student_trajs, guidance_scales,
                                    output_dir, size_factor)


def main(argv=None, draws=None):
    args = parse_args(argv)
    config = make_config(args)
    teacher_trajs, student_trajs = run(args, config, draws)
    output_dir = resolve_output_dir(config, args.output_dir)
    plot_all(teacher_trajs, student_trajs, parse_float_list(args.guidance_scales),
             output_dir, args.size_factor)
    print(f"\nTrajectory analysis completed; results in {output_dir}")
    return teacher_trajs, student_trajs


if __name__ == "__main__":
    main()
