"""Metric visualization and text reports (a numpy and matplotlib copy of
the JAX package's ``metrics/visualize.py``).

The file contract: per-metric PNGs (300 dpi) and ``summary{suffix}.txt``
reports with the same field names and order, and the same ``summary``
dict.  The metric dicts arrive already computed on the device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        plt.style.use("seaborn-v0_8-whitegrid")
    except OSError:
        pass
    return plt


def visualize_metrics(
    metrics_dict: Dict,
    output_dir: Optional[str] = None,
    size_factor: Optional[float] = None,
    suffix: str = "",
) -> None:
    """Per-pair metric plots + summary text (ref trajectory_metrics.py:327-473).

    Works on the raw output of ``compute_trajectory_metrics`` — unlike the
    reference, which read ``teacher_accelerations`` / ``path_length_ratio``
    keys its own compute function never produced (KeyError bug); our compute
    emits both, closing that gap.
    """
    plt = _plt()
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)

    def save(name):
        if output_dir:
            plt.savefig(
                os.path.join(output_dir, f"{name}{suffix}.png"),
                dpi=300,
                bbox_inches="tight",
            )
        plt.close()

    # Path lengths bar
    plt.figure(figsize=(10, 6))
    plt.bar(
        ["Teacher", "Student"],
        [metrics_dict["teacher_path_length"], metrics_dict["student_path_length"]],
        color=["blue", "orange"],
    )
    title = f'Path Lengths (Similarity: {metrics_dict["path_length_similarity"]:.3f})'
    if size_factor:
        title = (
            f"Path Lengths (Size Factor: {size_factor}, "
            f'Similarity: {metrics_dict["path_length_similarity"]:.3f})'
        )
    plt.title(title)
    plt.ylabel("Path Length")
    plt.grid(True, linestyle="--", alpha=0.7)
    save("path_lengths")

    # Endpoint distance bar
    plt.figure(figsize=(8, 5))
    plt.bar(["Endpoint Distance"], [metrics_dict["endpoint_distance"]], color="green")
    plt.title(
        f"Endpoint Distance (Size Factor: {size_factor})"
        if size_factor
        else "Endpoint Distance"
    )
    plt.ylabel("Distance")
    plt.grid(True, linestyle="--", alpha=0.7)
    save("endpoint_distances")

    # Velocity profile
    plt.figure(figsize=(12, 6))
    plt.plot(metrics_dict["teacher_velocities"], label="Teacher", color="blue")
    plt.plot(metrics_dict["student_velocities"], label="Student", color="orange")
    mvs = metrics_dict["mean_velocity_similarity"]
    plt.title(
        f"Velocity Profile (Size Factor: {size_factor}, Mean Similarity: {mvs:.3f})"
        if size_factor
        else f"Velocity Profile (Mean Similarity: {mvs:.3f})"
    )
    plt.xlabel("Step")
    plt.ylabel("Velocity")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.7)
    save("velocity_profile")

    # Acceleration profile
    plt.figure(figsize=(12, 6))
    plt.plot(metrics_dict["teacher_accelerations"], label="Teacher", color="blue")
    plt.plot(metrics_dict["student_accelerations"], label="Student", color="orange")
    plt.title(
        f"Acceleration Profile (Size Factor: {size_factor})"
        if size_factor
        else "Acceleration Profile"
    )
    plt.xlabel("Step")
    plt.ylabel("Acceleration")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.7)
    save("acceleration_profile")

    # Path efficiency bar
    plt.figure(figsize=(10, 6))
    plt.bar(
        ["Teacher", "Student"],
        [metrics_dict["teacher_efficiency"], metrics_dict["student_efficiency"]],
        color=["blue", "orange"],
    )
    es = metrics_dict["efficiency_similarity"]
    plt.title(
        f"Path Efficiency (Size Factor: {size_factor}, Similarity: {es:.3f})"
        if size_factor
        else f"Path Efficiency (Similarity: {es:.3f})"
    )
    plt.ylabel("Efficiency (Endpoint-to-Start Distance / Path Length)")
    plt.grid(True, linestyle="--", alpha=0.7)
    save("path_efficiency")

    # Wasserstein distances line
    plt.figure(figsize=(12, 6))
    plt.plot(metrics_dict["wasserstein_distances"], color="purple")
    plt.axhline(
        y=metrics_dict["mean_wasserstein"],
        color="red",
        linestyle="--",
        label=f'Mean: {metrics_dict["mean_wasserstein"]:.4f}',
    )
    ds = metrics_dict["distribution_similarity"]
    plt.title(
        f"Wasserstein Distances (Size Factor: {size_factor}, "
        f"Distribution Similarity: {ds:.3f})"
        if size_factor
        else f"Wasserstein Distances (Distribution Similarity: {ds:.3f})"
    )
    plt.xlabel("Step")
    plt.ylabel("Wasserstein Distance")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.7)
    save("wasserstein_distances")

    # Directional consistency
    if metrics_dict.get("directional_consistency") is not None and len(
        metrics_dict["directional_consistency"]
    ):
        plt.figure(figsize=(12, 6))
        plt.plot(metrics_dict["directional_consistency"], color="green")
        plt.axhline(
            y=metrics_dict["mean_directional_consistency"],
            color="red",
            linestyle="--",
            label=f'Mean: {metrics_dict["mean_directional_consistency"]:.4f}',
        )
        plt.title(
            f"Directional Consistency (Size Factor: {size_factor})"
            if size_factor
            else "Directional Consistency"
        )
        plt.xlabel("Step")
        plt.ylabel("Cosine Similarity")
        plt.legend()
        plt.grid(True, linestyle="--", alpha=0.7)
        save("directional_consistency")

    # Position differences
    if metrics_dict.get("position_differences") is not None and len(
        metrics_dict["position_differences"]
    ):
        plt.figure(figsize=(12, 6))
        plt.plot(metrics_dict["position_differences"], color="orange")
        plt.axhline(
            y=metrics_dict["mean_position_difference"],
            color="red",
            linestyle="--",
            label=f'Mean: {metrics_dict["mean_position_difference"]:.4f}',
        )
        plt.title(
            f"Position Differences (Size Factor: {size_factor})"
            if size_factor
            else "Position Differences"
        )
        plt.xlabel("Step")
        plt.ylabel("Distance")
        plt.legend()
        plt.grid(True, linestyle="--", alpha=0.7)
        save("position_differences")

    # Summary text (ref :459-473 — same field names and order)
    if output_dir:
        with open(os.path.join(output_dir, f"summary{suffix}.txt"), "w") as f:
            f.write(f"Size Factor: {size_factor if size_factor else 'N/A'}\n")
            f.write(f"Endpoint Distance: {metrics_dict['endpoint_distance']:.4f}\n")
            f.write(
                "Path Length Similarity: "
                f"{metrics_dict['path_length_similarity']:.4f}\n"
            )
            f.write(
                "Path Length Ratio (Student/Teacher): "
                f"{metrics_dict['path_length_ratio']:.4f}\n"
            )
            f.write(
                f"Efficiency Similarity: {metrics_dict['efficiency_similarity']:.4f}\n"
            )
            f.write(
                "Mean Velocity Similarity: "
                f"{metrics_dict['mean_velocity_similarity']:.4f}\n"
            )
            f.write(
                "Mean Directional Consistency: "
                f"{metrics_dict['mean_directional_consistency']:.4f}\n"
            )
            f.write(
                "Mean Position Difference: "
                f"{metrics_dict['mean_position_difference']:.4f}\n"
            )
            f.write(
                "Distribution Similarity: "
                f"{metrics_dict['distribution_similarity']:.4f}\n"
            )
            f.write(
                f"Mean Wasserstein Distance: {metrics_dict['mean_wasserstein']:.4f}\n"
            )
            f.write(
                f"Teacher Path Length: {metrics_dict['teacher_path_length']:.4f}\n"
            )
            f.write(
                f"Student Path Length: {metrics_dict['student_path_length']:.4f}\n"
            )


def visualize_batch_metrics(
    metrics_batch: Dict,
    config,
    size_factor: Optional[float] = None,
    output_dir: Optional[str] = None,
) -> Dict:
    """Batch-level histograms/averages + summary report
    (ref trajectory_metrics.py:475-716).

    ``metrics_batch`` uses the reference batch key names
    (``wasserstein_distances`` [list per pair], ``endpoint_distances``,
    ``teacher_path_lengths``, …) — produced by TrajectoryManager's batch
    metric aggregation.
    """
    plt = _plt()
    if output_dir is None:
        output_dir = config.metrics_dir
    os.makedirs(output_dir, exist_ok=True)
    size_factor_str = f"_size_{size_factor}" if size_factor else ""
    summary: Dict = {}

    def hist(values, color, name, title, xlabel, mean_label=None):
        plt.figure(figsize=(10, 6))
        plt.hist(values, bins=20, alpha=0.7, color=color)
        mean_v = float(np.mean(values))
        plt.axvline(
            x=mean_v, color="red", linestyle="--", label=f"Mean: {mean_v:.4f}"
        )
        plt.title(title)
        plt.xlabel(xlabel)
        plt.ylabel("Frequency")
        plt.legend()
        plt.grid(True, linestyle="--", alpha=0.7)
        plt.savefig(
            os.path.join(output_dir, f"{name}{size_factor_str}.png"),
            dpi=300,
            bbox_inches="tight",
        )
        plt.close()
        return mean_v

    if metrics_batch.get("wasserstein_distances") is not None and len(
        metrics_batch["wasserstein_distances"]
    ):
        summary["mean_wasserstein"] = hist(
            metrics_batch["wasserstein_distances"],
            "purple",
            "wasserstein_distances_hist",
            "Wasserstein Distances Distribution",
            "Wasserstein Distance",
        )

    if metrics_batch.get("endpoint_distances") is not None and len(
        metrics_batch["endpoint_distances"]
    ):
        mean_endpoint = hist(
            metrics_batch["endpoint_distances"],
            "green",
            "endpoint_distances_hist",
            "Endpoint Distances Distribution",
            "Endpoint Distance",
        )
        summary["mean_endpoint_distance"] = mean_endpoint
        summary["endpoint_distance"] = mean_endpoint

    tpl = metrics_batch.get("teacher_path_lengths")
    spl = metrics_batch.get("student_path_lengths")
    if tpl is not None and spl is not None and len(tpl) and len(spl):
        mean_t, mean_s = float(np.mean(tpl)), float(np.mean(spl))
        plt.figure(figsize=(10, 6))
        plt.bar(["Teacher", "Student"], [mean_t, mean_s], color=["blue", "orange"])
        plt.title("Average Path Lengths")
        plt.ylabel("Path Length")
        plt.grid(True, linestyle="--", alpha=0.7)
        plt.savefig(
            os.path.join(output_dir, f"avg_path_lengths{size_factor_str}.png"),
            dpi=300,
            bbox_inches="tight",
        )
        plt.close()

        plt.figure(figsize=(12, 6))
        plt.hist(tpl, bins=20, alpha=0.5, label="Teacher", color="blue")
        plt.hist(spl, bins=20, alpha=0.5, label="Student", color="orange")
        plt.axvline(x=mean_t, color="blue", linestyle="--",
                    label=f"Teacher Mean: {mean_t:.4f}")
        plt.axvline(x=mean_s, color="orange", linestyle="--",
                    label=f"Student Mean: {mean_s:.4f}")
        plt.title("Path Lengths Distribution")
        plt.xlabel("Path Length")
        plt.ylabel("Frequency")
        plt.legend()
        plt.grid(True, linestyle="--", alpha=0.7)
        plt.savefig(
            os.path.join(output_dir, f"path_lengths_hist{size_factor_str}.png"),
            dpi=300,
            bbox_inches="tight",
        )
        plt.close()

        summary["mean_teacher_path_length"] = mean_t
        summary["mean_student_path_length"] = mean_s
        summary["path_length_ratio"] = mean_s / mean_t if mean_t > 0 else float("inf")
        if "path_length_similarity_avg" in metrics_batch:
            summary["path_length_similarity"] = metrics_batch[
                "path_length_similarity_avg"
            ]
        elif "path_length_similarity" in metrics_batch:
            summary["path_length_similarity"] = metrics_batch["path_length_similarity"]
        else:
            summary["path_length_similarity"] = min(mean_t, mean_s) / max(
                mean_t, mean_s
            )

    te = metrics_batch.get("teacher_efficiency")
    se = metrics_batch.get("student_efficiency")
    if te is not None and se is not None and len(te) and len(se):
        mean_te, mean_se = float(np.mean(te)), float(np.mean(se))
        plt.figure(figsize=(10, 6))
        plt.bar(["Teacher", "Student"], [mean_te, mean_se], color=["blue", "orange"])
        plt.title("Average Path Efficiency")
        plt.ylabel("Efficiency (Endpoint Distance / Path Length)")
        plt.grid(True, linestyle="--", alpha=0.7)
        plt.savefig(
            os.path.join(output_dir, f"avg_path_efficiency{size_factor_str}.png"),
            dpi=300,
            bbox_inches="tight",
        )
        plt.close()

        plt.figure(figsize=(12, 6))
        plt.hist(te, bins=20, alpha=0.5, label="Teacher", color="blue")
        plt.hist(se, bins=20, alpha=0.5, label="Student", color="orange")
        plt.axvline(x=mean_te, color="blue", linestyle="--",
                    label=f"Teacher Mean: {mean_te:.4f}")
        plt.axvline(x=mean_se, color="orange", linestyle="--",
                    label=f"Student Mean: {mean_se:.4f}")
        plt.title("Path Efficiency Distribution")
        plt.xlabel("Efficiency")
        plt.ylabel("Frequency")
        plt.legend()
        plt.grid(True, linestyle="--", alpha=0.7)
        plt.savefig(
            os.path.join(output_dir, f"path_efficiency_hist{size_factor_str}.png"),
            dpi=300,
            bbox_inches="tight",
        )
        plt.close()

        summary["mean_teacher_efficiency"] = mean_te
        summary["mean_student_efficiency"] = mean_se
        summary["efficiency_ratio"] = (
            mean_se / mean_te if mean_te > 0 else float("inf")
        )
        if "efficiency_similarity_avg" in metrics_batch:
            summary["efficiency_similarity"] = metrics_batch[
                "efficiency_similarity_avg"
            ]
        elif "efficiency_similarity" in metrics_batch:
            summary["efficiency_similarity"] = metrics_batch["efficiency_similarity"]
        else:
            summary["efficiency_similarity"] = min(mean_te, mean_se) / max(
                mean_te, mean_se
            )

    wpt = metrics_batch.get("wasserstein_distances_per_timestep")
    if wpt is not None and len(wpt):
        avg_wpt = np.mean(np.asarray(wpt, dtype=np.float64), axis=0)
        plt.figure(figsize=(12, 6))
        plt.plot(avg_wpt, color="purple")
        plt.title("Average Wasserstein Distance per Timestep")
        plt.xlabel("Timestep")
        plt.ylabel("Wasserstein Distance")
        plt.grid(True, linestyle="--", alpha=0.7)
        plt.savefig(
            os.path.join(output_dir, f"wasserstein_per_timestep{size_factor_str}.png"),
            dpi=300,
            bbox_inches="tight",
        )
        plt.close()
        summary["wasserstein_per_timestep"] = avg_wpt.tolist()

    for metric_name in (
        "mean_velocity_similarity",
        "mean_directional_consistency",
        "mean_position_difference",
        "distribution_similarity",
    ):
        if f"{metric_name}_avg" in metrics_batch:
            summary[metric_name] = metrics_batch[f"{metric_name}_avg"]
        elif metric_name in metrics_batch:
            summary[metric_name] = metrics_batch[metric_name]

    # Summary text (ref :678-708 — same lines, same order)
    with open(os.path.join(output_dir, f"summary{size_factor_str}.txt"), "w") as f:
        f.write(f"Size Factor: {size_factor_str if size_factor_str else 'N/A'}\n\n")
        if "mean_endpoint_distance" in summary:
            f.write(
                f"Mean Endpoint Distance: {summary['mean_endpoint_distance']:.4f}\n"
            )
        if "path_length_ratio" in summary:
            f.write(
                "Mean Path Length Ratio (Student/Teacher): "
                f"{summary['path_length_ratio']:.4f}\n"
            )
            f.write(
                f"Mean Teacher Path Length: {summary['mean_teacher_path_length']:.4f}\n"
            )
            f.write(
                f"Mean Student Path Length: {summary['mean_student_path_length']:.4f}\n"
            )
        if "efficiency_ratio" in summary:
            f.write(
                "Mean Efficiency Ratio (Student/Teacher): "
                f"{summary['efficiency_ratio']:.4f}\n"
            )
            f.write(
                f"Mean Teacher Efficiency: {summary['mean_teacher_efficiency']:.4f}\n"
            )
            f.write(
                f"Mean Student Efficiency: {summary['mean_student_efficiency']:.4f}\n"
            )
        if "mean_wasserstein" in summary:
            f.write(f"Mean Wasserstein Distance: {summary['mean_wasserstein']:.4f}\n")
        for metric_name, display_name in (
            ("path_length_similarity", "Path Length Similarity"),
            ("efficiency_similarity", "Efficiency Similarity"),
            ("mean_velocity_similarity", "Mean Velocity Similarity"),
            ("mean_directional_consistency", "Mean Directional Consistency"),
            ("mean_position_difference", "Mean Position Difference"),
            ("distribution_similarity", "Distribution Similarity"),
        ):
            if metric_name in summary:
                f.write(f"{display_name}: {summary[metric_name]:.4f}\n")

    print(f"Metrics summary for size factor {size_factor_str}:")
    for k, v in summary.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            print(f"  {k}: {v:.4f}")
    return summary
