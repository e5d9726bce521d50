"""Metric normalisation to [0, 1] for the CFG heatmaps and radar plots (the
port's own copy of ``metrics/transformations.py``: numpy only, the same
arithmetic, so the plots' numbers are identical)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def transform_metrics(
    path_length_similarity,
    trajectory_mse,
    directional_consistency,
    distribution_similarity,
) -> Dict[str, np.ndarray]:
    """Normalize the four headline metrics to [0,1] scores.

    * path-length similarity: passthrough
    * trajectory MSE: clip≥0 → log1p → invert/normalize by log1p(1)
    * directional consistency: absolute value
    * distribution similarity: log1p → normalize by log1p(1), clipped
    """
    path_length_score = path_length_similarity

    trajectory_mse = np.clip(trajectory_mse, 0, None)
    mse_similarity = np.log1p(trajectory_mse)
    mse_similarity = np.clip(1 - (mse_similarity / np.log1p(1.0)), 0, 1)

    directional_score = np.abs(directional_consistency)

    distribution_score = np.log1p(distribution_similarity)
    distribution_score = np.clip(distribution_score / np.log1p(1.0), 0, 1)

    return {
        "path_length_similarity": path_length_score,
        "trajectory_mse": mse_similarity,
        "mean_directional_consistency": directional_score,
        "distribution_similarity": distribution_score,
    }
