"""Disk-backed trajectory store (port of ``trajectories/manager.py``).

Paired teacher/student trajectories are generated in one batch per chunk
(samples ride the U-Net's batch axis, through
:func:`.engine.make_paired_trajectory_fn`), then written as compressed
``trajectory_size_{sf}_sample_{i}.npz`` files with the keys ``teacher``,
``student``, ``timesteps`` and ``size_factor``, always float32 on disk.
Like the JAX manager, the chains are the engine's no-CFG chains.

Starting noise, per-step noise and the Wasserstein subsample keys are
injectable, so that tests can hand in the JAX draws.  By default sample
``i`` starts from the generator of ``(i, 0)`` and takes its step-t noise
from that of ``(i, t)``; pair ``i`` of a scoring run draws its keys from a
generator seeded with ``i``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion.sampling import draw_step_noise, seeded_normal
from ..metrics.trajectory_metrics import WASSERSTEIN_SAMPLE_SIZE, compute_trajectory_metrics
from .engine import _entry_device, make_paired_trajectory_fn

_TRAJ_RE = re.compile(r"trajectory_size_(.+)_sample_(\d+)\.(npz|pkl)$")

_METRIC_KEYS = (
    "wasserstein_distances",
    "wasserstein_distances_per_timestep",
    "endpoint_distances",
    "teacher_path_lengths",
    "student_path_lengths",
    "teacher_efficiency",
    "student_efficiency",
    "path_length_similarity",
    "efficiency_similarity",
    "mean_velocity_similarity",
    "mean_directional_consistency",
    "mean_position_difference",
    "distribution_similarity",
)
# Per-pair metric-dict key of each list above.
_SOURCE = {
    "wasserstein_distances": "mean_wasserstein",
    "wasserstein_distances_per_timestep": "wasserstein_distances",
    "endpoint_distances": "endpoint_distance",
    "teacher_path_lengths": "teacher_path_length",
    "student_path_lengths": "student_path_length",
}


class TrajectoryManager:
    """Generates, stores and scores paired teacher/student trajectories on
    ``device`` (default ``config.device``)."""

    def __init__(self, teacher_model, student_model, config, size_factor: float = 1.0,
                 fixed_samples=None, device=None):
        self.teacher_model = teacher_model
        self.student_model = student_model
        self.config = config
        self.size_factor = size_factor
        self.fixed_samples = fixed_samples
        self.device = _entry_device(config, device)
        os.makedirs(config.trajectory_dir, exist_ok=True)

    # -- generation -----------------------------------------------------

    def _pairs(self, noises, seeds, step_noise=None):
        fn = make_paired_trajectory_fn(
            self.teacher_model, self.student_model, self.config.teacher_steps,
            self.config, use_cfg=False, device=self.device)
        return fn(noises, seeds, 1.0, step_noise=step_noise)

    def _shape(self) -> Tuple[int, int, int]:
        cfg = self.config
        return (cfg.image_size, cfg.image_size, cfg.channels)

    def generate_trajectory(self, seed: Optional[int] = None, noise=None, step_noise=None):
        """One paired trajectory: ``(teacher, student)``, each a
        ``[T+1, H, W, C]`` numpy array.  ``noise`` (``[H, W, C]``) defaults
        to the draw of ``(seed, 0)``; ``step_noise`` is ``[T-1, H, W, C]``."""
        seed = 0 if seed is None else seed
        if noise is None:
            noise = seeded_normal([(seed, 0)], self._shape(), self.device)[0]
        return self.generate_trajectory_from_sample(noise, seed, step_noise)

    def generate_trajectory_from_sample(self, sample, seed: Optional[int] = None,
                                        step_noise=None):
        """Paired trajectory from a fixed ``[H, W, C]`` starting sample."""
        seed = 0 if seed is None else seed
        sample = torch.as_tensor(sample, dtype=torch.float32).reshape(1, *self._shape())
        if step_noise is not None:
            step_noise = torch.as_tensor(step_noise)[:, None]
        t_trajs, s_trajs = self._pairs(sample, [seed], step_noise)
        return (t_trajs[0].float().cpu().numpy(), s_trajs[0].float().cpu().numpy())

    def _file_path(self, index: int) -> str:
        return os.path.join(
            self.config.trajectory_dir,
            f"trajectory_size_{self.size_factor}_sample_{index}.npz",
        )

    def generate_and_save_trajectories(self, num_samples: int = 10,
                                       chunk_size: Optional[int] = None,
                                       noises=None, step_noise=None) -> List[str]:
        """Generate and write ``num_samples`` pairs, ``chunk_size`` samples
        per batch (default: all at once).  ``noises`` (``[S, H, W, C]``)
        and ``step_noise`` (``[T-1, S, H, W, C]``) replace the default
        draws; ``fixed_samples`` given to the manager take precedence over
        both noise sources for the starting noise."""
        chunk = num_samples if chunk_size is None else max(1, min(chunk_size, num_samples))
        paths: List[str] = []
        for start in range(0, num_samples, chunk):
            end = min(start + chunk, num_samples)
            paths.extend(self._generate_chunk(
                start, end - start,
                None if noises is None else noises[start:end],
                None if step_noise is None else step_noise[:, start:end]))
        return paths

    def _generate_chunk(self, start: int, num_samples: int, noises=None,
                        step_noise=None) -> List[str]:
        end = start + num_samples
        shape = self._shape()
        if self.fixed_samples is not None and end <= len(self.fixed_samples):
            print(f"Using {num_samples} fixed samples for consistent comparison")
            noises = np.stack([np.asarray(s, dtype=np.float32).reshape(shape)
                               for s in self.fixed_samples[start:end]])
        elif noises is None:
            noises = seeded_normal([(i, 0) for i in range(start, end)], shape, self.device)
        seeds = list(range(start, end))
        if step_noise is None:
            step_noise = draw_step_noise(seeds, self.config.teacher_steps, shape, self.device)
        t_trajs, s_trajs = self._pairs(torch.as_tensor(noises), seeds, torch.as_tensor(step_noise))
        # The npz contract is float32 whatever the storage dtype on the device.
        both = torch.stack([t_trajs, s_trajs]).float().cpu().numpy()
        t_trajs, s_trajs = both[0], both[1]
        T = self.config.teacher_steps
        tsteps = np.concatenate([[T], np.arange(T - 1, -1, -1)])

        file_paths = []
        for i in range(num_samples):
            # A pair with a non-finite state is skipped, the others kept.
            if not (np.isfinite(t_trajs[i]).all() and np.isfinite(s_trajs[i]).all()):
                print(f"Warning: non-finite trajectory for sample {start + i}; skipping")
                continue
            path = self._file_path(start + i)
            np.savez_compressed(path, teacher=t_trajs[i], student=s_trajs[i],
                                timesteps=tsteps, size_factor=self.size_factor)
            file_paths.append(path)
        return file_paths

    # -- loading --------------------------------------------------------

    def load_trajectories(self, size_factor: Optional[float] = None,
                          indices: Optional[Sequence[int]] = None
                          ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Stored pairs of one size factor, by file name, in name order."""
        sf = self.size_factor if size_factor is None else size_factor
        out = []
        for name in sorted(os.listdir(self.config.trajectory_dir)):
            m = _TRAJ_RE.match(name)
            if not m or m.group(1) != str(sf):
                continue
            if indices is not None and int(m.group(2)) not in indices:
                continue
            with np.load(os.path.join(self.config.trajectory_dir, name)) as z:
                out.append((z["teacher"], z["student"]))
        return out

    # -- metrics --------------------------------------------------------

    def compute_trajectory_metrics_batch(self, size_factor: Optional[float] = None,
                                         uniforms=None) -> Dict[str, object]:
        """The metric suite over every stored pair, one by one in load
        order, on the manager's device: 13 per-pair metric lists, a
        ``{key}_avg`` for each list of scalars, and scalar aliases of the
        six similarity averages.  ``uniforms[i]`` (``[T+1, H·W·C]``) are
        pair ``i``'s Wasserstein keys."""
        pairs = self.load_trajectories(size_factor=size_factor)
        if not pairs:
            return {}
        all_metrics: Dict[str, list] = {k: [] for k in _METRIC_KEYS}
        for i, (t_traj, s_traj) in enumerate(pairs):
            n, d = t_traj.shape[0], int(np.prod(t_traj.shape[1:]))
            if uniforms is not None:
                u = torch.as_tensor(uniforms[i]).to(self.device)
            elif d > WASSERSTEIN_SAMPLE_SIZE:
                gen = torch.Generator(device=self.device).manual_seed(i)
                u = torch.rand((n, d), generator=gen, device=self.device)
            else:
                u = None
            metrics = compute_trajectory_metrics(
                torch.from_numpy(t_traj).to(self.device),
                torch.from_numpy(s_traj).to(self.device),
                self.config, uniforms=u)
            for k in _METRIC_KEYS:
                all_metrics[k].append(metrics[_SOURCE.get(k, k)])

        for k in _METRIC_KEYS:
            vals = all_metrics[k]
            if vals and not isinstance(vals[0], (list, np.ndarray)):
                all_metrics[k + "_avg"] = float(np.mean(vals))
        for k in _METRIC_KEYS[7:]:
            if k + "_avg" in all_metrics:
                all_metrics[k] = all_metrics[k + "_avg"]
        return all_metrics


def generate_trajectories_with_disk_storage(teacher_model, student_model, config,
                                            size_factor: float = 1.0, num_samples: int = 10,
                                            fixed_samples=None, device=None) -> TrajectoryManager:
    """A manager for ``size_factor`` whose store holds at least
    ``num_samples`` pairs: generated unless already on disk."""
    manager = TrajectoryManager(teacher_model, student_model, config, size_factor=size_factor,
                                fixed_samples=fixed_samples, device=device)
    existing = manager.load_trajectories()
    if len(existing) >= num_samples:
        print(f"Found {len(existing)} existing trajectories for size "
              f"{size_factor}; skipping generation")
        return manager
    manager.generate_and_save_trajectories(num_samples)
    return manager
