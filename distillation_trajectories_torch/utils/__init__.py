"""Phase timers, anomaly checks, the metrics log and sample-grid images."""
from .profiling import (
    MetricsLogger,
    dump_phase_times,
    enable_nan_checks,
    phase_timer,
    phase_times,
    reset_phase_times,
)
from .viz import make_grid, save_image_grid
