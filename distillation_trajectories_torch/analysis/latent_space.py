"""3-D latent-space trajectory visualization (port of
``analysis/latent_space.py``).

Two halves: :func:`latent_space_pca` fits the joint 3-component PCA of a
paired trajectory (numpy, no plotting library); :func:`plot_latent_space`
draws ``3d_latent_space.png``, eight rotation views and
``2d_latent_space.png`` under ``analysis/latent_space/size_{sf}/`` and
needs matplotlib.  :func:`generate_latent_space_visualization` is the
JAX-named function: both halves.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .dimensionality import _joint_rows, pca_fit_transform


def _first_pair(teacher_trajectory, student_trajectory):
    """The pair itself, or the first pair of a list of trajectories."""
    if (
        isinstance(teacher_trajectory, list)
        and len(teacher_trajectory)
        and isinstance(teacher_trajectory[0], (list, np.ndarray))
        and np.asarray(teacher_trajectory[0]).ndim >= 3
    ):
        return teacher_trajectory[0], student_trajectory[0]
    return teacher_trajectory, student_trajectory


def latent_space_pca(teacher_trajectory, student_trajectory) -> Dict[str, np.ndarray]:
    """Joint PCA-3 of a paired trajectory (or the first pair of lists):
    ``teacher`` and ``student`` ``[n, 3]`` coordinates and ``ratio``, the
    three explained-variance ratios."""
    combined, n_teacher = _joint_rows(*_first_pair(teacher_trajectory, student_trajectory))
    emb, ratio, _, _ = pca_fit_transform(combined, 3)
    return {"teacher": emb[:n_teacher], "student": emb[n_teacher:], "ratio": ratio}


def latent_space_output_dir(config, size_factor: Optional[float] = None) -> str:
    """``{config.latent_space_dir}[/size_{sf}]``."""
    output_dir = config.latent_space_dir
    if size_factor is not None:
        output_dir = os.path.join(output_dir, f"size_{size_factor}")
    return output_dir


def plot_latent_space(pca: Dict[str, np.ndarray], output_dir: str,
                      size_factor: Optional[float] = None) -> None:
    """The 3-D plot, its eight rotation views and the top-down 2-D view."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    teacher_pca, student_pca, ratio = pca["teacher"], pca["student"], pca["ratio"]
    teacher_colors = plt.cm.Blues(np.linspace(0.3, 1.0, len(teacher_pca)))
    student_colors = plt.cm.Oranges(np.linspace(0.3, 1.0, len(student_pca)))

    fig = plt.figure(figsize=(12, 10))
    ax = fig.add_subplot(111, projection="3d")
    for pca_pts, colors, line_color, label in (
        (teacher_pca, teacher_colors, "blue", "Teacher"),
        (student_pca, student_colors, "orange", "Student"),
    ):
        for i in range(len(pca_pts) - 1):
            ax.scatter(*pca_pts[i, :3], color=colors[i], marker="o", s=50,
                       alpha=0.7)
            ax.plot(
                [pca_pts[i, 0], pca_pts[i + 1, 0]],
                [pca_pts[i, 1], pca_pts[i + 1, 1]],
                [pca_pts[i, 2], pca_pts[i + 1, 2]],
                color=line_color, alpha=0.5, linewidth=1.5,
            )
        ax.scatter(*pca_pts[-1, :3], color=colors[-1], marker="*", s=200,
                   alpha=0.7, label=f"{label} End")
        ax.scatter(*pca_pts[0, :3], color=line_color, marker="D", s=100,
                   alpha=1.0, label=f"{label} Start")

    ax.set_xlabel(f"Principal Component 1 (Variance: {ratio[0]:.2%})")
    ax.set_ylabel(f"Principal Component 2 (Variance: {ratio[1]:.2%})")
    ax.set_zlabel(f"Principal Component 3 (Variance: {ratio[2]:.2%})")
    ax.set_title(f"3D Latent Space Trajectory (Size Factor: {size_factor})")
    ax.legend()
    plt.savefig(os.path.join(output_dir, "3d_latent_space.png"), dpi=300,
                bbox_inches="tight")
    for angle in range(0, 360, 45):  # eight rotation views
        ax.view_init(elev=20, azim=angle)
        plt.savefig(os.path.join(output_dir, f"3d_latent_space_angle_{angle}.png"),
                    dpi=300, bbox_inches="tight")
    plt.close()

    fig = plt.figure(figsize=(12, 10))
    ax = fig.add_subplot(111)
    for pca_pts, colors, line_color, label in (
        (teacher_pca, teacher_colors, "blue", "Teacher"),
        (student_pca, student_colors, "orange", "Student"),
    ):
        for i in range(len(pca_pts) - 1):
            ax.scatter(pca_pts[i, 0], pca_pts[i, 1], color=colors[i],
                       marker="o", s=50, alpha=0.7)
            ax.plot(
                [pca_pts[i, 0], pca_pts[i + 1, 0]],
                [pca_pts[i, 1], pca_pts[i + 1, 1]],
                color=line_color, alpha=0.5, linewidth=1.5,
            )
        ax.scatter(pca_pts[-1, 0], pca_pts[-1, 1], color=colors[-1],
                   marker="*", s=200, alpha=0.7, label=f"{label} End")
        ax.scatter(pca_pts[0, 0], pca_pts[0, 1], color=line_color, marker="D",
                   s=100, alpha=1.0, label=f"{label} Start")
    ax.set_xlabel(f"Principal Component 1 (Variance: {ratio[0]:.2%})")
    ax.set_ylabel(f"Principal Component 2 (Variance: {ratio[1]:.2%})")
    ax.set_title(f"2D Latent Space Trajectory (Size Factor: {size_factor})")
    ax.legend()
    ax.grid(True, linestyle="--", alpha=0.7)
    plt.savefig(os.path.join(output_dir, "2d_latent_space.png"), dpi=300,
                bbox_inches="tight")
    plt.close()


def generate_latent_space_visualization(
    teacher_trajectory,
    student_trajectory,
    config,
    size_factor: Optional[float] = None,
) -> str:
    """Joint PCA-3 and its plots; returns the absolute output directory.
    An error propagates (the JAX function prints it and returns)."""
    output_dir = latent_space_output_dir(config, size_factor)
    print(
        f"Generating 3D latent space visualization for size factor {size_factor}..."
    )
    plot_latent_space(latent_space_pca(teacher_trajectory, student_trajectory),
                      output_dir, size_factor)
    print(f"Latent space visualization completed for size factor {size_factor}")
    return os.path.abspath(output_dir)
