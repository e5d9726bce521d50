"""Metric-vs-model-size plots (a numpy and matplotlib copy of the JAX
package's ``metrics/size_dependent.py``: the same file names and panels).

A missing metric is plotted as 0, as in the JAX package, not as the
original reference's ``np.random.uniform`` placeholder.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _extract_size(model_key) -> Optional[float]:
    if isinstance(model_key, str) and "size_" in model_key:
        try:
            return float(model_key.split("size_")[1])
        except ValueError:
            print(f"  Could not extract size factor from {model_key}")
            return None
    if isinstance(model_key, (int, float)):
        return float(model_key)
    return None


def plot_mse_vs_size(metrics: Dict, config, save_dir: Optional[str] = None) -> None:
    """MSE (or Wasserstein proxy) vs size factor with trend line
    (reference size_dependent.py:10-94)."""
    print("Plotting MSE vs model size...")
    if save_dir is None:
        save_dir = config.size_dependent_dir
    os.makedirs(save_dir, exist_ok=True)

    size_factors, mse_values = [], []
    for model_key, model_metrics in metrics.items():
        sf = _extract_size(model_key)
        if sf is None:
            continue
        size_factors.append(sf)
        if "mse" in model_metrics:
            mse_values.append(model_metrics["mse"])
        elif "mean_wasserstein" in model_metrics:
            mse_values.append(model_metrics["mean_wasserstein"])
        else:
            mse_values.append(0.0)

    if not (size_factors and mse_values):
        print("  Not enough data to create MSE vs size plot")
        return

    order = np.argsort(size_factors)
    size_factors = [size_factors[i] for i in order]
    mse_values = [mse_values[i] for i in order]

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 6))
    plt.plot(size_factors, mse_values, "o-", linewidth=2, markersize=8)
    plt.xlabel("Model Size Factor")
    plt.ylabel("MSE (or Wasserstein Distance)")
    plt.title("Model Performance vs Size Factor")
    plt.grid(True, linestyle="--", alpha=0.7)
    if len(size_factors) > 1:
        z = np.polyfit(size_factors, mse_values, 1)
        plt.plot(size_factors, np.poly1d(z)(size_factors), "r--", alpha=0.7)
    plt.savefig(os.path.join(save_dir, "mse_vs_size.png"), dpi=300, bbox_inches="tight")
    plt.close()
    print(f"  Saved MSE vs size plot to {os.path.join(save_dir, 'mse_vs_size.png')}")


def plot_metrics_vs_size(metrics: Dict, config, save_dir: Optional[str] = None) -> None:
    """4-panel (Wasserstein / endpoint / path-ratio / efficiency-ratio) vs
    size factor (reference size_dependent.py:96-192)."""
    print("Plotting metrics vs model size...")
    if save_dir is None:
        save_dir = config.size_dependent_dir
    os.makedirs(save_dir, exist_ok=True)

    rows = []
    for model_key, model_metrics in metrics.items():
        sf = _extract_size(model_key)
        if sf is None:
            continue
        rows.append(
            (
                sf,
                model_metrics.get("mean_wasserstein", 0),
                model_metrics.get("mean_endpoint_distance", 0),
                model_metrics.get("path_length_ratio", 0),
                model_metrics.get("efficiency_ratio", 0),
            )
        )
    if not rows:
        print("  Not enough data to create metrics vs size plot")
        return
    rows.sort(key=lambda r: r[0])
    sfs, wass, endp, plr, effr = map(list, zip(*rows))

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(2, 2, figsize=(15, 10))
    panels = [
        (axs[0, 0], wass, "Wasserstein Distance", "blue"),
        (axs[0, 1], endp, "Endpoint Distance", "green"),
        (axs[1, 0], plr, "Path Length Ratio", "red"),
        (axs[1, 1], effr, "Efficiency Ratio", "purple"),
    ]
    for ax, vals, label, color in panels:
        ax.plot(sfs, vals, "o-", linewidth=2, markersize=8, color=color)
        ax.set_title(f"{label} vs Size Factor")
        ax.set_xlabel("Size Factor")
        ax.set_ylabel(label)
        ax.grid(True, linestyle="--", alpha=0.7)
    plt.tight_layout()
    plt.savefig(
        os.path.join(save_dir, "metrics_vs_size.png"), dpi=300, bbox_inches="tight"
    )
    plt.close()
    print(
        f"  Saved metrics vs size plot to "
        f"{os.path.join(save_dir, 'metrics_vs_size.png')}"
    )
