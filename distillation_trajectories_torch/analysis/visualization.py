"""Cross-size visualization suite: time-dependent grids, overlays and
ratios, trajectory divergence, the 3-D model-size surface and the
denoising comparison (port of ``analysis/visualization.py``).

The plot functions are numpy and matplotlib copies of the JAX package's,
with the same file names and ``{"status": ...}`` return values.  The
denoising comparison samples through the port's
``diffusion/sampling.py::generate_trajectory_scan``
(:func:`denoising_trajectories`, no plotting library), so on a CUDA tensor
its update tail is the Triton kernel; :func:`create_denoising_comparison_plot`
adds the grid.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _valid_size_factors(time_distances_dict: Dict) -> list:
    valid = []
    for size_factor, td in time_distances_dict.items():
        if (
            td.get("teacher_avg_per_timestep")
            and td.get("student_avg_per_timestep")
        ):
            valid.append(size_factor)
    valid.sort()
    return valid


def plot_time_dependent_grid(time_distances_dict: Dict, config, save_dir=None):
    """Grid of per-size teacher/student distance curves
    (reference visualization/time_dependent.py:11-112)."""
    print("Plotting time-dependent grid...")
    plt = _plt()
    if save_dir is None:
        save_dir = config.time_dependent_dir
    os.makedirs(save_dir, exist_ok=True)

    valid = _valid_size_factors(time_distances_dict or {})
    if not valid:
        print("  Warning: No valid time-dependent data available. Skipping grid plot.")
        return

    n_plots = len(valid)
    n_cols = min(3, n_plots)
    n_rows = (n_plots + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(15, 5 * n_rows))
    axes = np.atleast_1d(axes).ravel()

    for i, size_factor in enumerate(valid):
        td = time_distances_dict[size_factor]
        ax = axes[i]
        ax.plot(td["teacher_avg_per_timestep"], label="Teacher", color="blue")
        ax.plot(td["student_avg_per_timestep"], label="Student", color="orange")
        ax.set_title(f"Size Factor: {size_factor}")
        ax.set_xlabel("Timestep")
        ax.set_ylabel("Average Distance")
        ax.legend()
        ax.grid(True, linestyle="--", alpha=0.7)
    for j in range(len(valid), len(axes)):
        fig.delaxes(axes[j])
    plt.tight_layout()
    plt.savefig(
        os.path.join(save_dir, "time_dependent_grid.png"), dpi=300,
        bbox_inches="tight",
    )
    plt.close()


def plot_time_dependent_combined(time_distances_dict: Dict, config, save_dir=None):
    """Combined overlay + student/teacher ratio plot
    (reference visualization/time_dependent.py:114-242)."""
    print("Plotting time-dependent combined...")
    plt = _plt()
    if save_dir is None:
        save_dir = config.time_dependent_dir
    os.makedirs(save_dir, exist_ok=True)

    valid = _valid_size_factors(time_distances_dict or {})
    if not valid:
        print(
            "  Warning: No valid time-dependent data available. "
            "Skipping combined plot."
        )
        return

    cmap = plt.cm.viridis
    colors = [cmap(i / len(valid)) for i in range(len(valid))]

    plt.figure(figsize=(12, 8))
    for i, size_factor in enumerate(valid):
        plt.plot(
            time_distances_dict[size_factor]["student_avg_per_timestep"],
            label=f"Size Factor: {size_factor}",
            color=colors[i],
        )
    plt.plot(
        time_distances_dict[valid[0]]["teacher_avg_per_timestep"],
        label="Teacher",
        color="black",
        linestyle="--",
        linewidth=2,
    )
    plt.title("Time-Dependent Distances Across Size Factors")
    plt.xlabel("Timestep")
    plt.ylabel("Average Distance")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.7)
    plt.savefig(
        os.path.join(save_dir, "time_dependent_combined.png"), dpi=300,
        bbox_inches="tight",
    )
    plt.close()

    # Ratio plot
    plt.figure(figsize=(12, 8))
    for i, size_factor in enumerate(valid):
        student = np.asarray(
            time_distances_dict[size_factor]["student_avg_per_timestep"]
        )
        teacher = np.asarray(
            time_distances_dict[size_factor]["teacher_avg_per_timestep"]
        )
        n = min(len(student), len(teacher))
        ratio = np.where(teacher[:n] > 0, student[:n] / np.where(teacher[:n] > 0,
                         teacher[:n], 1.0), 1.0)
        plt.plot(ratio, label=f"Size Factor: {size_factor}", color=colors[i])
    plt.title("Student/Teacher Distance Ratio Across Size Factors")
    plt.xlabel("Timestep")
    plt.ylabel("Ratio (Student/Teacher)")
    plt.axhline(y=1.0, color="black", linestyle="--", alpha=0.5)
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.7)
    plt.savefig(
        os.path.join(save_dir, "time_dependent_ratio.png"), dpi=300,
        bbox_inches="tight",
    )
    plt.close()


def plot_trajectory_divergence_vs_timestep(all_metrics: Dict, config, save_dir=None):
    """Wasserstein-vs-normalized-timestep across sizes with viridis_r colormap
    (reference visualization/time_dependent.py:244-337)."""
    print("Plotting trajectory divergence (MSE) vs timestep...")
    plt = _plt()
    if save_dir is None:
        save_dir = config.time_dependent_dir
    os.makedirs(save_dir, exist_ok=True)

    wpt: Dict[float, np.ndarray] = {}
    for size_factor, metrics in (all_metrics or {}).items():
        per_traj = metrics.get("wasserstein_distances_per_timestep")
        if per_traj is not None and len(per_traj):
            wpt[size_factor] = np.mean(np.asarray(per_traj, dtype=np.float64), axis=0)
    if not wpt:
        print(
            "  Warning: No valid trajectory divergence data available. "
            "Skipping plot."
        )
        return
    valid = sorted(wpt.keys())

    plt.figure(figsize=(14, 10))
    cmap = plt.cm.viridis_r
    norm = plt.Normalize(min(valid), max(valid)) if len(valid) > 1 else plt.Normalize(
        0, 1
    )
    for size_factor in valid:
        plt.plot(
            np.linspace(0, 1, len(wpt[size_factor])),
            wpt[size_factor],
            label=f"Size {size_factor}",
            color=cmap(norm(size_factor)),
            linewidth=2.5,
        )
    plt.title("Trajectory Divergence (MSE) vs Timestep", fontsize=16)
    plt.xlabel("Normalized Timestep (0=start, 1=end)", fontsize=12)
    plt.ylabel("Wasserstein Distance (MSE)", fontsize=12)
    plt.grid(True, linestyle="--", alpha=0.7)
    sm = plt.cm.ScalarMappable(cmap=cmap, norm=norm)
    sm.set_array([])
    cbar = plt.colorbar(sm, ax=plt.gca())
    cbar.set_label("Student Model Size Factor", fontsize=12)
    plt.legend(loc="upper right")
    path = os.path.join(save_dir, "trajectory_divergence_vs_timestep.png")
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"  Saved trajectory divergence vs timestep plot to {path}")


def generate_3d_model_size_visualization(all_metrics: Dict, config, save_dir=None):
    """3-D surface of metric values over (size factor × timestep).

    The reference shipped only a placeholder returning
    ``{"status": "placeholder"}`` (model_size_viz.py:11-30); this is a real
    implementation: Wasserstein-per-timestep surfaces over the size sweep.
    """
    print("Generating 3D model size visualization...")
    plt = _plt()
    if save_dir is None:
        save_dir = os.path.join(config.analysis_dir, "model_size_3d")
    os.makedirs(save_dir, exist_ok=True)

    rows = []
    sizes = []
    for size_factor, metrics in sorted((all_metrics or {}).items()):
        per_traj = metrics.get("wasserstein_distances_per_timestep")
        if per_traj is not None and len(per_traj):
            rows.append(np.mean(np.asarray(per_traj, dtype=np.float64), axis=0))
            sizes.append(float(size_factor))
    if len(rows) < 2:
        print("  Not enough data for a 3D surface; skipping.")
        return {"status": "skipped", "reason": "insufficient data"}

    n_t = min(len(r) for r in rows)
    z = np.stack([r[:n_t] for r in rows])
    t_axis = np.linspace(0, 1, n_t)
    s_axis = np.asarray(sizes)
    tt, ss = np.meshgrid(t_axis, s_axis)

    fig = plt.figure(figsize=(14, 10))
    ax = fig.add_subplot(111, projection="3d")
    surf = ax.plot_surface(tt, ss, z, cmap="viridis", edgecolor="none", alpha=0.9)
    ax.set_xlabel("Normalized Timestep")
    ax.set_ylabel("Size Factor")
    ax.set_zlabel("Wasserstein Distance")
    ax.set_title("Trajectory Divergence over Size × Timestep")
    fig.colorbar(surf, shrink=0.6)
    path = os.path.join(save_dir, "model_size_3d_surface.png")
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"  Saved 3D model size surface to {path}")
    return {"status": "ok", "path": path}


def _chosen_sizes(sizes) -> list:
    """Smallest, middle and largest size (all of them when fewer than 3)."""
    sizes = sorted(sizes)
    if len(sizes) >= 3:
        return [sizes[0], sizes[len(sizes) // 2], sizes[-1]]
    return sizes


def denoising_trajectories(
    models: Dict,
    config,
    seed: int = 0,
    noise=None,
    step_noise=None,
) -> Dict[float, np.ndarray]:
    """``{size_factor: [T+1, H, W, C]}``: the no-CFG engine trajectory of
    each chosen size (smallest, middle, largest of ``models``, a
    ``{size_factor: model}`` dict) from one shared starting noise.

    ``noise`` (``[1, H, W, C]``) defaults to the generator draw of
    ``(seed, 0)`` and ``step_noise`` (``[T-1, 1, H, W, C]``) to the
    sampler's ``(seed, t)`` draws, on ``config.device``.
    """
    from ..config import resolve_device
    from ..diffusion import get_diffusion_params
    from ..diffusion.sampling import generate_trajectory_scan, seeded_normal
    from ..training.state import make_eval_model_fn

    device = resolve_device(config.device)
    shape = (config.image_size, config.image_size, config.channels)
    if noise is None:
        noise = seeded_normal([(seed, 0)], shape, device)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(device).reshape(1, *shape)
    if step_noise is not None:
        step_noise = torch.as_tensor(step_noise, dtype=torch.float32).to(device)
    alphas = get_diffusion_params(config.timesteps, config)["alphas"]
    out = {}
    for sf in _chosen_sizes(models):
        traj = generate_trajectory_scan(make_eval_model_fn(models[sf]), noise,
                                        config.timesteps, alphas, seed, step_noise=step_noise)
        out[sf] = traj[:, 0].float().cpu().numpy()
    return out


def plot_denoising_comparison(trajectories: Dict[float, np.ndarray], save_dir: str,
                              num_steps: int = 5) -> str:
    """``denoising_comparison.png``: ``num_steps`` evenly spaced states of
    each size's trajectory, one row per size."""
    plt = _plt()
    os.makedirs(save_dir, exist_ok=True)
    chosen = sorted(trajectories)
    fig, axes = plt.subplots(
        len(chosen), num_steps, figsize=(num_steps * 3, len(chosen) * 3)
    )
    axes = np.atleast_2d(axes)
    for r, sf in enumerate(chosen):
        traj = trajectories[sf]
        idx = np.linspace(0, traj.shape[0] - 1, num_steps).astype(int)
        for c, i in enumerate(idx):
            img = np.clip((traj[i] + 1) / 2, 0, 1)
            if img.shape[-1] == 1:
                img = img[..., 0]
            axes[r, c].imshow(img, cmap="gray" if img.ndim == 2 else None)
            axes[r, c].axis("off")
            if r == 0:
                axes[r, c].set_title(f"Step {i}")
        axes[r, 0].set_ylabel(f"Size {sf}")
    plt.suptitle("Denoising Comparison Across Model Sizes")
    plt.tight_layout()
    path = os.path.join(save_dir, "denoising_comparison.png")
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"  Saved denoising comparison to {path}")
    return path


def create_denoising_comparison_plot(
    models: Dict,
    config,
    save_dir=None,
    num_steps: int = 5,
    seed: int = 0,
    noise=None,
    step_noise=None,
):
    """Side-by-side denoising steps of the smallest, middle and largest
    model of ``models`` (``{size_factor: model}``): each row shows
    ``num_steps`` evenly spaced states of the actual reverse process.
    Returns the PNG's path (under ``config.denoising_dir`` by default)."""
    trajectories = denoising_trajectories(models, config, seed, noise, step_noise)
    return plot_denoising_comparison(
        trajectories, config.denoising_dir if save_dir is None else save_dir, num_steps)
