"""Configuration for diffusion model training and analysis (PyTorch port).

The same dataclass as ``distillation_trajectories_tpu/config.py``: field
names, defaults and the ``output/`` directory contract are identical, so the
two packages share checkpoints, directory layouts and command lines.  The
port adds two fields: ``device``, and ``architecture`` (the U-Net, or the
DiT transformer of ``models/dit.py``, which only the trajectory sweep
runs).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import torch


def _default_student_size_factors() -> List[float]:
    return [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]


def _default_hidden_dims() -> List[int]:
    return [128, 256, 256, 256]


def _default_student_architectures() -> Dict[str, List[int]]:
    return {
        "tiny": [32, 64],
        "small": [32, 64, 128],
        "medium": [48, 96, 192],
        "full": [128, 256, 256, 256],
    }


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent, so no entry point silently runs on the CPU instead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass
class Config:
    """All hyperparameters plus the output directory contract.

    Mirrors the JAX package's ``Config`` field for field.
    ``mesh_shape=(d, m)`` shards the trainers' state and batches and the
    sweep's samples over a ``(data, model)`` mesh of ``d·m`` ranks,
    ``spatial_shape=(d, s)`` partitions the eval forward's image rows, and
    ``checkpoint_sharded`` writes ``model_epoch_{e}.dcp`` sharded
    checkpoints (``parallel/*``, ``training/checkpoints.py``; the ranks
    come from a launcher such as ``torchrun``).  ``sampler_quant="int8"``
    selects the int8 forward (``models/quantized.py``) and
    ``parallel_sampling="window"`` the sliding-window sampler of
    ``generate_trajectory`` (``paradigms_window``, ``paradigms_tol``);
    ``remat`` recomputes each U-Net block in the backward pass
    (``torch.utils.checkpoint``).  ``pallas_cfg_update`` selects nothing in
    the port's samplers: in JAX it picks the fused Pallas kernel over the
    unfused combine then ``engine_update``, and the port's fused
    ``ops.cfg_update.cfg_engine_update`` computes that unfused tail
    (bit-equal on the CPU), so every step goes through it under either
    value (the Triton kernel on the card).  As in JAX, the
    ``parallel_sampling="window"`` path says that it ignores the flag when
    it is set.
    ``epoch_scan`` selects what it selects in JAX: on one device the
    trainers upload the dataset once and run each epoch through the epoch
    lane (one captured CUDA graph replayed a batch on the card; also off
    with ``DTT_EPOCH_SCAN=0``), else the per-batch loop.  ``vmap_students``
    trains the size factors that floor to one U-Net as one group step on
    that lane (not with ``checkpoint_sharded`` or ``sweep_parallel``).
    """

    # Dataset
    dataset: str = "CIFAR10"
    image_size: int = 32
    channels: int = 3
    batch_size: int = 128

    # Model
    latent_dim: int = 128
    hidden_dims: List[int] = dataclasses.field(default_factory=_default_hidden_dims)
    dropout: float = 0.3
    num_res_blocks: int = 3
    learn_sigma: bool = True

    # Diffusion process
    sample_steps: int = 100
    timesteps: int = 100
    beta_start: float = 1e-4
    beta_end: float = 0.02
    noise_schedule: str = "linear"

    # Training
    epochs: int = 10
    lr: float = 1e-4
    save_interval: int = 1
    adam_beta1: float = 0.8
    adam_beta2: float = 0.999
    ema_rate: float = 0.9999

    # Distillation
    distill: bool = True
    teacher_steps: int = 100
    student_steps: int = 100
    student_size_factors: List[float] = dataclasses.field(
        default_factory=_default_student_size_factors
    )
    student_architectures: Dict[str, List[int]] = dataclasses.field(
        default_factory=_default_student_architectures
    )

    # Progress bar
    progress_bar_leave: bool = False
    progress_bar_position: int = 0
    progress_bar_ncols: int = 100

    # Sampling
    num_samples_to_generate: int = 16
    samples_grid_size: int = 4
    samples_figure_size: Tuple[int, int] = (10, 10)

    # Training parameters
    noise_diversity_weight: float = 0.1
    mps_enabled: bool = False
    force_cpu: bool = False

    # Compute dtype of model forwards; params stay float32.
    compute_dtype: str = "bfloat16"
    sampler: str = "engine"
    sample_mode: str = "reference"
    mesh_shape: Tuple[int, int] = (1, 1)
    limit_batches_per_epoch: Optional[int] = None
    epoch_scan: bool = True
    vmap_students: bool = True
    checkpoint_sharded: bool = False
    # Storage dtype of stacked trajectories ("float32" or "bfloat16"); the
    # sampling math stays float32, only the stored states are cast.
    trajectory_store_dtype: str = "float32"
    pallas_cfg_update: bool = False
    spatial_shape: Optional[Tuple[int, int]] = None
    sampler_quant: str = "none"
    parallel_sampling: str = "off"
    paradigms_window: int = 8
    paradigms_tol: float = 1e-3
    use_ema: bool = False
    remat: bool = False
    # "batch" (BatchNorm, reference parity) or "group" (GroupNorm).
    norm: str = "batch"
    # Full-resolution decoder head that consumes the enc1 skip.
    full_res_head: bool = False
    # Root directory override (tests point this at a tmpdir).
    base_dir: Optional[str] = None

    # --- PyTorch port additions ---
    # Device of the port's entry points; "cuda" raises when no GPU exists.
    device: str = "cuda"
    # The model family models.make_model builds: "unet" (the published
    # teacher/student U-Net, every path) or "dit" (models/dit.py: the
    # trajectory sweep only; the paths built for the U-Net refuse it).
    architecture: str = "unet"

    def __post_init__(self):
        if self.base_dir is None:
            # Repo root = parent of the package directory.
            self.base_dir = os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))
            )
        self.teacher_steps = self.timesteps
        self.student_steps = self.timesteps
        self._setup_directories()

    def _setup_directories(self) -> None:
        self.output_dir = os.path.join(self.base_dir, "output")
        self.results_dir = os.path.join(self.output_dir, "results")

        self.models_dir = os.path.join(self.output_dir, "models")
        self.teacher_models_dir = os.path.join(self.models_dir, "teacher")
        self.student_models_dir = os.path.join(self.models_dir, "students")

        self.data_dir = os.path.join(self.base_dir, "data")
        self.trajectory_dir = os.path.join(self.data_dir, "trajectories")

        self.analysis_dir = os.path.join(self.output_dir, "analysis")
        self.metrics_dir = os.path.join(self.analysis_dir, "metrics")
        self.model_comparisons_dir = os.path.join(
            self.analysis_dir, "model_comparisons"
        )
        self.time_dependent_dir = os.path.join(self.analysis_dir, "time_dependent")
        self.size_dependent_dir = os.path.join(self.analysis_dir, "size_dependent")
        self.dimensionality_dir = os.path.join(self.analysis_dir, "dimensionality")
        self.latent_space_dir = os.path.join(self.analysis_dir, "latent_space")
        self.attention_dir = os.path.join(self.analysis_dir, "attention")
        self.noise_prediction_dir = os.path.join(
            self.analysis_dir, "noise_prediction"
        )
        self.denoising_dir = os.path.join(self.analysis_dir, "denoising")
        self.fid_dir = os.path.join(self.analysis_dir, "fid")

    def create_directories(self) -> "Config":
        """Create the full output directory tree."""
        directories = [
            self.output_dir,
            self.results_dir,
            self.models_dir,
            self.teacher_models_dir,
            self.student_models_dir,
            self.data_dir,
            self.trajectory_dir,
            self.analysis_dir,
            self.metrics_dir,
            self.model_comparisons_dir,
            self.time_dependent_dir,
            self.size_dependent_dir,
            self.dimensionality_dir,
            self.latent_space_dir,
            self.attention_dir,
            self.noise_prediction_dir,
            self.denoising_dir,
            self.fid_dir,
        ]
        for size_factor in self.student_size_factors:
            directories.append(
                os.path.join(self.student_models_dir, f"size_{size_factor}")
            )
        for dir_path in directories:
            os.makedirs(dir_path, exist_ok=True)
        return self

    def student_dir(self, size_factor: float) -> str:
        """Per-size student checkpoint directory."""
        return os.path.join(self.student_models_dir, f"size_{size_factor}")

    def get_test_dataset(self):
        """Test-split ``(images, labels)``: NHWC float32 in [-1, 1]."""
        from .data import load_dataset

        return load_dataset(self, train=False)
