"""Noise-prediction accuracy: teacher vs student ε̂ at sampled timesteps
(port of ``analysis/noise_prediction.py``).

ᾱ_t follows the reference's local formula ``β_i = β_start +
(β_end−β_start)·i/T`` (``/T``, not the schedule's ``/(T−1)``), as a float64
cumprod on the host.  Three parts:

* :func:`noise_prediction_metrics` — the compute half, on the device: one
  teacher and one student forward per analysed timestep on the same noisy
  images, and MSE / MAE / cosine similarity per timestep.  The
  per-timestep noise (``[n_timesteps, *images.shape]``) is injectable; the
  default draw comes from a ``torch.Generator`` seeded with ``seed`` on the
  device.
* :func:`write_noise_metrics` — ``noise_metrics_size_{sf}.txt``.
* :func:`visualize_noise_predictions`, :func:`plot_noise_metrics_by_timestep`
  — the two PNGs (need matplotlib).

:func:`analyze_noise_prediction` is the JAX-named function: all of it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..models.unet import resize_bilinear_align_corners
from ..training.state import make_eval_model_fn


def local_alpha_bars(config) -> np.ndarray:
    """ᾱ_t per the reference's local formula, float64."""
    t = np.arange(config.timesteps, dtype=np.float64)
    betas = config.beta_start + (config.beta_end - config.beta_start) * t / config.timesteps
    return np.cumprod(1.0 - betas)


def _noise_metric_tensor(teacher_noise: torch.Tensor, student_noise: torch.Tensor) -> torch.Tensor:
    """``[mse, mae, cosine]`` on the inputs' device; the student's map is
    resized (bilinear, align_corners) when the shapes differ."""
    if teacher_noise.shape != student_noise.shape:
        student_noise = resize_bilinear_align_corners(student_noise, teacher_noise.shape[1:3])
    diff = teacher_noise - student_noise
    t_flat = teacher_noise.reshape(teacher_noise.shape[0], -1)
    s_flat = student_noise.reshape(student_noise.shape[0], -1)
    t_norm = t_flat / torch.linalg.vector_norm(t_flat, dim=1, keepdim=True)
    s_norm = s_flat / torch.linalg.vector_norm(s_flat, dim=1, keepdim=True)
    return torch.stack([torch.mean(diff ** 2), torch.mean(diff.abs()),
                        torch.mean(torch.sum(t_norm * s_norm, dim=1))])


def calculate_noise_metrics(teacher_noise, student_noise) -> Dict[str, float]:
    """MSE / MAE / cosine similarity between two ε̂ maps (NHWC)."""
    mse, mae, cosine = _noise_metric_tensor(
        torch.as_tensor(teacher_noise), torch.as_tensor(student_noise)).tolist()
    return {"mse": mse, "mae": mae, "cosine_similarity": cosine}


def noise_prediction_metrics(
    teacher_model,
    student_model,
    config,
    images=None,
    n_timesteps: int = 10,
    seed: int = 0,
    noise=None,
) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """The compute half on ``config.device``.

    ``images`` default to ``get_real_images(config, 10)``.  The timesteps
    are ``np.linspace(0, T-1, n_timesteps)`` as integers; at each,
    ``noisy = √ᾱ·images + √(1−ᾱ)·noise[i]`` (ᾱ cast to float32) feeds both
    models.  Returns the JAX function's result dict (``avg_mse``,
    ``avg_mae``, ``avg_cosine_similarity``, ``metrics_by_timestep``) and
    the first timestep's ``images``, ``noisy``, ``true_noise``,
    ``teacher_pred`` and ``student_pred`` as numpy arrays for the plot.
    """
    device = resolve_device(config.device)
    if images is None:
        from ..data import get_real_images

        images = get_real_images(config, 10)
    images = torch.as_tensor(np.asarray(images), dtype=torch.float32).to(device)
    shape = (n_timesteps, *images.shape)
    if noise is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        noise = torch.randn(shape, generator=gen, device=device)
    else:
        noise = torch.as_tensor(noise, dtype=torch.float32).to(device)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")

    teacher_fn = make_eval_model_fn(teacher_model)
    student_fn = make_eval_model_fn(student_model)
    ts = np.linspace(0, config.timesteps - 1, n_timesteps).astype(np.int64)
    alpha_bars = local_alpha_bars(config)
    rows, samples = [], {}
    for idx, t in enumerate(ts):
        alpha_bar = np.float32(alpha_bars[t])
        noisy = (float(np.sqrt(alpha_bar)) * images
                 + float(np.sqrt(np.float32(1.0) - alpha_bar)) * noise[idx])
        tvec = torch.full((images.shape[0],), float(t), dtype=torch.float32, device=device)
        teacher_pred = teacher_fn(noisy, tvec)
        student_pred = student_fn(noisy, tvec)
        rows.append(_noise_metric_tensor(teacher_pred, student_pred))
        if idx == 0:
            samples = {"images": images, "noisy": noisy, "true_noise": noise[idx],
                       "teacher_pred": teacher_pred, "student_pred": student_pred}
    values = torch.stack(rows).cpu().numpy()  # one transfer: [n_timesteps, 3]
    metrics_by_timestep = {
        int(t): {"mse": float(v[0]), "mae": float(v[1]), "cosine_similarity": float(v[2])}
        for t, v in zip(ts, values)
    }
    results = {
        "avg_mse": float(np.mean([m["mse"] for m in metrics_by_timestep.values()])),
        "avg_mae": float(np.mean([m["mae"] for m in metrics_by_timestep.values()])),
        "avg_cosine_similarity": float(
            np.mean([m["cosine_similarity"] for m in metrics_by_timestep.values()])),
        "metrics_by_timestep": metrics_by_timestep,
    }
    return results, {k: v.cpu().numpy() for k, v in samples.items()}


def noise_prediction_dir(config, size_factor) -> str:
    return os.path.join(config.analysis_dir, "noise_prediction", f"size_{size_factor}")


def write_noise_metrics(results: Dict, output_dir: str, size_factor) -> str:
    """``noise_metrics_size_{sf}.txt`` with the JAX function's text."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"noise_metrics_size_{size_factor}.txt")
    with open(path, "w") as f:
        f.write(f"Average MSE: {results['avg_mse']:.6f}\n")
        f.write(f"Average MAE: {results['avg_mae']:.6f}\n")
        f.write(f"Average Cosine Similarity: {results['avg_cosine_similarity']:.6f}\n\n")
        f.write("Metrics by Timestep:\n")
        for t, m in sorted(results["metrics_by_timestep"].items()):
            f.write(f"  Timestep {t}:\n")
            f.write(f"    MSE: {m['mse']:.6f}\n")
            f.write(f"    MAE: {m['mae']:.6f}\n")
            f.write(f"    Cosine Similarity: {m['cosine_similarity']:.6f}\n")
    print(f"  Average MSE: {results['avg_mse']:.6f}")
    print(f"  Average MAE: {results['avg_mae']:.6f}")
    print(f"  Average Cosine Similarity: {results['avg_cosine_similarity']:.6f}")
    return path


def visualize_noise_predictions(
    original_images,
    noisy_images,
    teacher_noise,
    student_noise,
    true_noise,
    output_dir: str,
    size_factor,
) -> None:
    """``noise_predictions_size_{sf}.png``, a 5-row grid: original / noisy
    / true ε / teacher ε̂ / student ε̂."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_images = min(5, original_images.shape[0])
    fig, axes = plt.subplots(5, n_images, figsize=(n_images * 3, 15))
    fig.suptitle(f"Noise Prediction Comparison (Size Factor: {size_factor})",
                 fontsize=16)
    rows = [
        ("Original", original_images),
        ("Noisy", noisy_images),
        ("True Noise", true_noise),
        ("Teacher Pred", teacher_noise),
        ("Student Pred", student_noise),
    ]
    for r, (title, batch) in enumerate(rows):
        for i in range(n_images):
            img = np.asarray(batch[i])
            img = (img + 1) / 2.0
            img = np.clip(img, 0, 1)
            if img.shape[-1] == 1:
                img = img[..., 0]
            ax = axes[r, i] if n_images > 1 else axes[r]
            ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
            ax.axis("off")
            if r == 0:
                ax.set_title(f"Image {i + 1}")
        (axes[r, 0] if n_images > 1 else axes[r]).set_ylabel(title)
    plt.tight_layout()
    plt.savefig(
        os.path.join(output_dir, f"noise_predictions_size_{size_factor}.png"),
        dpi=300,
        bbox_inches="tight",
    )
    plt.close()


def plot_noise_metrics_by_timestep(
    metrics_by_timestep: Dict, output_dir: str, size_factor
) -> None:
    """``noise_metrics_by_timestep_size_{sf}.png``: MSE, MAE and cosine vs
    timestep."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ts = sorted(metrics_by_timestep.keys())
    fig, axes = plt.subplots(3, 1, figsize=(10, 15))
    panels = [("mse", "MSE"), ("mae", "MAE"), ("cosine_similarity", "Cosine Similarity")]
    for ax, (key, label) in zip(axes, panels):
        ax.plot(ts, [metrics_by_timestep[t][key] for t in ts], "o-")
        ax.set_title(f"{label} by Timestep (Size Factor: {size_factor})")
        ax.set_ylabel(label)
        ax.set_xlabel("Timestep")
        ax.grid(True, linestyle="--", alpha=0.7)
    plt.tight_layout()
    plt.savefig(
        os.path.join(output_dir, f"noise_metrics_by_timestep_size_{size_factor}.png"),
        dpi=300,
        bbox_inches="tight",
    )
    plt.close()


def plot_noise_prediction(results: Dict, samples: Dict[str, np.ndarray], output_dir: str,
                          size_factor) -> None:
    """Both PNGs of one :func:`noise_prediction_metrics` run."""
    os.makedirs(output_dir, exist_ok=True)
    visualize_noise_predictions(samples["images"], samples["noisy"], samples["teacher_pred"],
                                samples["student_pred"], samples["true_noise"], output_dir,
                                size_factor)
    plot_noise_metrics_by_timestep(results["metrics_by_timestep"], output_dir, size_factor)


def analyze_noise_prediction(
    teacher_model,
    student_model,
    config,
    output_dir: Optional[str] = None,
    size_factor: Optional[float] = None,
    fixed_samples=None,
    n_timesteps: int = 10,
    seed: int = 0,
    noise=None,
) -> Dict:
    """The full analysis: metrics, the text file and both PNGs under
    ``output_dir`` (default ``analysis/noise_prediction/size_{sf}``)."""
    if output_dir is None:
        output_dir = noise_prediction_dir(config, size_factor)
    print(f"Analyzing noise prediction for size factor {size_factor}...")
    if fixed_samples is not None:
        print(f"Using {len(fixed_samples)} fixed samples for consistent comparison")
    results, samples = noise_prediction_metrics(
        teacher_model, student_model, config, images=fixed_samples,
        n_timesteps=n_timesteps, seed=seed, noise=noise)
    write_noise_metrics(results, output_dir, size_factor)
    plot_noise_prediction(results, samples, output_dir, size_factor)
    return results
