"""Trajectory-similarity metric suite and the heatmap normalisation.  FID,
LPIPS and the evaluation helpers live in ``metrics.fid``,
``metrics.lpips`` and ``metrics.evaluation``."""
from .trajectory_metrics import (
    compute_trajectory_metrics,
    compute_trajectory_metrics_batch,
    wasserstein_1d,
    resample_trajectory,
)
from .transformations import transform_metrics
