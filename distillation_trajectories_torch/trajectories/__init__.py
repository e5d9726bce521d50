"""Trajectory generation and teacher/student comparison."""
from .engine import (
    SweepDraws,
    generate_trajectory,
    compare_trajectories,
    make_batch_trajectory_fn,
    make_paired_trajectory_fn,
    make_sweep_trajectory_fn,
    sweep_compare_trajectories,
    sweep_compare_trajectories_multi,
)
from .manager import TrajectoryManager, generate_trajectories_with_disk_storage
