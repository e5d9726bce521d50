"""Per-timestep consecutive-step distance analysis (port of
``metrics/time_dependent.py``).

Two halves: :func:`time_dependent_distances` stacks the trajectories and
takes every consecutive-step distance in one float32 diff/norm on the
device; :func:`plot_time_dependent_distances` draws the PNG and needs
matplotlib.  :func:`analyze_time_dependent_distances` is the JAX-named
function: both halves, the plot only when ``save_dir`` is given.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import resolve_device


def _stack(trajectories) -> Optional[np.ndarray]:
    """``[n_traj, n_steps, ...]`` from a list of arrays or of lists of
    arrays or ``(image, t)`` tuples, cut to the shortest trajectory."""
    if trajectories is None or len(trajectories) == 0:
        return None
    out = []
    for traj in trajectories:
        if isinstance(traj[0], tuple):
            traj = [item[0] for item in traj]
        arr = np.stack([np.asarray(x) for x in traj]) if isinstance(
            traj, (list, tuple)
        ) else np.asarray(traj)
        out.append(arr)
    min_len = min(a.shape[0] for a in out)
    return np.stack([a[:min_len] for a in out])


def consecutive_distances(trajs, device="cuda") -> torch.Tensor:
    """``[n_traj, n_steps-1]`` Euclidean distances between consecutive
    states of ``trajs`` (``[n_traj, n_steps, ...]``), in float32 on
    ``device``."""
    x = torch.as_tensor(trajs).to(device=resolve_device(device), dtype=torch.float32)
    x = x.reshape(x.shape[0], x.shape[1], -1)
    return torch.linalg.vector_norm(x[:, 1:] - x[:, :-1], dim=-1)


def time_dependent_distances(teacher_trajectories, student_trajectories,
                             size_factor: Optional[float] = None, device="cuda") -> Dict:
    """Average per-timestep step distances of teacher and student: the
    JAX result keys, ``*_std_distance`` the population std of the
    per-timestep averages."""
    print("Analyzing time-dependent distances...")
    results: Dict = {
        "teacher_distances": [],
        "student_distances": [],
        "teacher_avg_distance": 0,
        "student_avg_distance": 0,
        "teacher_std_distance": 0,
        "student_std_distance": 0,
        "size_factor": size_factor,
    }
    t_stack = _stack(teacher_trajectories)
    s_stack = _stack(student_trajectories)
    if t_stack is None or s_stack is None:
        print("  Warning: Empty trajectories provided. Returning empty results.")
        return results

    t_dists = consecutive_distances(t_stack, device).cpu().numpy()
    s_dists = consecutive_distances(s_stack, device).cpu().numpy()
    t_avg = t_dists.mean(axis=0)
    s_avg = s_dists.mean(axis=0)

    results["teacher_distances"] = [list(map(float, row)) for row in t_dists]
    results["student_distances"] = [list(map(float, row)) for row in s_dists]
    results["teacher_avg_per_timestep"] = t_avg.tolist()
    results["student_avg_per_timestep"] = s_avg.tolist()
    results["teacher_avg_distance"] = float(t_avg.mean())
    results["student_avg_distance"] = float(s_avg.mean())
    results["teacher_std_distance"] = float(t_avg.std())
    results["student_std_distance"] = float(s_avg.std())
    return results


def plot_time_dependent_distances(results: Dict, save_dir: str,
                                  size_factor: Optional[float] = None) -> None:
    """``time_dependent_distances[_size_{sf}].png``: teacher and student
    average step distance per timestep (needs matplotlib)."""
    t_avg = results.get("teacher_avg_per_timestep") or []
    s_avg = results.get("student_avg_per_timestep") or []
    if not (len(t_avg) and len(s_avg)):
        return
    os.makedirs(save_dir, exist_ok=True)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(12, 6))
    plt.plot(t_avg, label="Teacher", color="blue")
    plt.plot(s_avg, label="Student", color="orange")
    title = "Average Distance Between Consecutive Timesteps"
    if size_factor is not None:
        title += f" (Size Factor: {size_factor})"
    plt.title(title)
    plt.xlabel("Timestep")
    plt.ylabel("Average Distance")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.7)
    filename = "time_dependent_distances.png"
    if size_factor is not None:
        filename = f"time_dependent_distances_size_{size_factor}.png"
    plt.savefig(os.path.join(save_dir, filename), dpi=300, bbox_inches="tight")
    plt.close()


def analyze_time_dependent_distances(
    teacher_trajectories,
    student_trajectories,
    config,
    size_factor: Optional[float] = None,
    save_dir: Optional[str] = None,
) -> Dict:
    """:func:`time_dependent_distances` on ``config.device``, and its PNG
    in ``save_dir`` when given."""
    results = time_dependent_distances(
        teacher_trajectories, student_trajectories, size_factor, config.device)
    if save_dir:
        plot_time_dependent_distances(results, save_dir, size_factor)
    return results
