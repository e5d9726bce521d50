"""Trajectory-similarity metric suite, the heatmap normalisation, the
time-dependent distances, the metric plots, FID (``metrics.fid``) and the
evaluation helpers (``metrics.evaluation``); LPIPS is ``metrics.lpips``."""
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
from .fid import (
    InceptionModel,
    calculate_fid,
    calculate_and_visualize_fid,
    fid_across_sizes,
    generate_samples,
)
from .evaluation import (
    compute_lpips,
    compute_fid,
    compute_trajectory_divergence,
    visualize_evaluation_metrics,
)
