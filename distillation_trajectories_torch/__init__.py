"""distillation_trajectories_torch — the PyTorch/CUDA port of
``distillation_trajectories_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names, imports neither JAX nor the JAX package, and runs on the
GPU unless a caller asks for the CPU (``device="cpu"``).  Ported so far: the
CFG trajectory sweep (config, schedules, U-Net, checkpoints, engine samplers
with the fused Triton update kernel, metric suite, sweep engine) and
training (forward process, the U-Net's train mode, reference samplers, data
layer, train steps, epoch loop, checkpoint writing, and the teacher,
student and resume trainers with their CLIs under ``scripts/``).
"""

__version__ = "0.1.0"

from .config import Config, resolve_device
from .models import DiffusionUNet, make_unet
from .diffusion import get_diffusion_params, generate_trajectory_scan
from .metrics import compute_trajectory_metrics
from .trajectories import (
    compare_trajectories,
    generate_trajectory,
    sweep_compare_trajectories,
)
