"""Phase timers, the metrics log and sample-grid images."""
from .profiling import MetricsLogger, phase_timer, phase_times
from .viz import make_grid, save_image_grid
