"""distillation_trajectories_torch — the PyTorch/CUDA port of
``distillation_trajectories_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names, imports neither JAX nor the JAX package, and runs on the
GPU unless a caller asks for the CPU (``device="cpu"``).  Ported so far:

- the CFG trajectory sweep: config, schedules, the U-Net, checkpoints, the
  engine samplers with the fused Triton update kernel, the metric suite
  and the sweep engine;
- training: the forward process, the U-Net's train mode (with ``remat``),
  reference samplers, the data layer, train steps, the epoch loop,
  checkpoint writing, and the teacher, student and resume trainers with
  their CLIs under ``scripts/``;
- analysis: the trajectory manager, FID, LPIPS, ``analysis/*``, the metric
  plots, and the seven analysis CLIs with their orchestrator
  ``scripts/run_analysis.py``;
- editing (inpainting, latent manipulation, simulated prompt editing and
  the editing-demo CLI) and progressive step-halving distillation, plain
  and CFG-distilled;
- the sampler's opt-in lanes: the int8 forward (``models/quantized.py``)
  and sliding-window ParaDiGMS (``diffusion/parallel_sampling.py``);
  reference-checkpoint migration (``models/torch_port.py`` and two CLIs);
  and the full-sweep orchestrator ``scripts/run_full_sweep.py``.

The multi-device lanes (``parallel/*`` and the orbax sharded checkpoint)
are not ported yet and raise ``NotImplementedError``.
"""

__version__ = "0.1.0"

from .config import Config, resolve_device
from .models import DiffusionUNet, SimpleUNet, StudentUNet, make_unet
from .diffusion import (
    get_diffusion_params,
    q_sample,
    p_losses,
    p_sample,
    p_sample_loop,
    generate_trajectory_scan,
)
from .metrics import (
    compute_trajectory_metrics,
    transform_metrics,
    visualize_metrics,
    visualize_batch_metrics,
    calculate_fid,
    calculate_and_visualize_fid,
    analyze_time_dependent_distances,
    plot_mse_vs_size,
    plot_metrics_vs_size,
)
from .analysis import (
    dimensionality_reduction_analysis,
    analyze_noise_prediction,
    generate_latent_space_visualization,
)
from .trajectories import (
    compare_trajectories,
    generate_trajectory,
    sweep_compare_trajectories,
)
