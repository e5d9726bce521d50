"""Trajectory-similarity metric suite, the heatmap normalisation, the
time-dependent distances and the metric plots.  FID, LPIPS and the
evaluation helpers live in ``metrics.fid``, ``metrics.lpips`` and
``metrics.evaluation``."""
from .trajectory_metrics import (
    compute_trajectory_metrics,
    compute_trajectory_metrics_batch,
    wasserstein_1d,
    resample_trajectory,
)
from .transformations import transform_metrics
from .visualize import visualize_metrics, visualize_batch_metrics
from .time_dependent import analyze_time_dependent_distances
from .size_dependent import plot_mse_vs_size, plot_metrics_vs_size
