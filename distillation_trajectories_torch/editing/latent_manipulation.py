"""Latent-space manipulation: semantic directions via PCA, re-denoising
(port of ``editing/latent_manipulation.py``).

* ``apply_latent_manipulation`` — add ``strength·direction`` to a final
  latent, then re-denoise from T/2.
* ``find_semantic_directions`` — PCA(10) over the final latents of
  ``num_samples`` generations, run as ONE batched ``[num_samples, H, W, C]``
  chain (the JAX package vmaps the per-sample chain); sample ``i``'s draws
  are those of seed ``i``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..analysis.dimensionality import pca_fit_transform
from ..diffusion import get_diffusion_params
from ..training.state import make_eval_fn_from_config
from .core import EditingDraws, denoise_with_trajectory, editing_device, to_image


def generate_image_with_latents(model, config, seed: int = 0, mode: str = "engine",
                                draws=None):
    """Generate one image: host ``(image in [0, 1], final latent,
    trajectory)``, its draws ``draws.chain(seed, (1, H, W, C), T − 1)``."""
    device = editing_device(model, config)
    model_fn = make_eval_fn_from_config(model, config)
    dp = get_diffusion_params(config.timesteps, config)
    draws = draws or EditingDraws(device)
    shape = (1, config.image_size, config.image_size, config.channels)
    noise, step_noise = draws.chain(seed, shape, config.timesteps - 1)
    x_final, trajectory = denoise_with_trajectory(
        model_fn, noise.to(device), dp["alphas"], config.timesteps - 1, step_noise=step_noise,
        diffusion_params=dp, mode=mode,
    )
    return (to_image(x_final).cpu().numpy(), x_final.cpu().numpy(),
            trajectory.cpu().numpy())


def apply_latent_manipulation(
    model,
    config,
    latent=None,
    direction=None,
    strength: float = 1.0,
    record_trajectory: bool = True,
    seed: int = 0,
    mode: str = "engine",
    draws=None,
) -> Dict:
    """Move a latent by ``strength·direction`` and re-denoise it from
    ``T // 2``.  ``latent`` defaults to :func:`generate_image_with_latents`
    of ``seed``; ``direction`` to ``draws.direction(seed + 2, ·)``
    normalised to unit norm; the re-denoise's step noise is
    ``draws.redenoise(seed + 1, ·, T // 2)``."""
    device = editing_device(model, config)
    model_fn = make_eval_fn_from_config(model, config)
    dp = get_diffusion_params(config.timesteps, config)
    draws = draws or EditingDraws(device)

    if latent is None:
        _, latent, _ = generate_image_with_latents(model, config, seed=seed, mode=mode,
                                                   draws=draws)
    latent = torch.as_tensor(latent, dtype=torch.float32).to(device)
    if latent.ndim == 3:
        latent = latent[None]
    if direction is None:
        direction = draws.direction(seed + 2, tuple(latent.shape)).to(device)
        direction = direction / torch.linalg.norm(direction)
    direction = torch.as_tensor(direction, dtype=torch.float32).to(device).reshape(latent.shape)

    manipulated = latent + strength * direction
    start_t = config.timesteps // 2
    x_final, trajectory = denoise_with_trajectory(
        model_fn, manipulated, dp["alphas"], start_t,
        step_noise=draws.redenoise(seed + 1, tuple(latent.shape), start_t),
        diffusion_params=dp, mode=mode,
    )
    result = {
        "original_latent": latent.cpu().numpy(),
        "manipulated_latent": manipulated.cpu().numpy(),
        "original_image": to_image(latent).cpu().numpy(),
        "manipulated_image": to_image(x_final).cpu().numpy(),
        "strength": strength,
    }
    if record_trajectory:
        result["trajectory"] = trajectory.cpu().numpy()
    return result


def find_semantic_directions(model, config, num_samples: int = 100, mode: str = "engine",
                             draws=None) -> Dict[str, np.ndarray]:
    """PCA(10) over the final latents of ``num_samples`` generations (seeds
    ``0 … num_samples − 1``), generated as one batched chain."""
    device = editing_device(model, config)
    model_fn = make_eval_fn_from_config(model, config)
    dp = get_diffusion_params(config.timesteps, config)
    draws = draws or EditingDraws(device)
    shape = (1, config.image_size, config.image_size, config.channels)
    start_t = config.timesteps - 1
    chains = [draws.chain(i, shape, start_t) for i in range(num_samples)]
    noises = torch.cat([n.to(device) for n, _ in chains])
    step_noise = torch.cat([s.to(device) for _, s in chains], dim=1)
    latents, _ = denoise_with_trajectory(
        model_fn, noises, dp["alphas"], start_t, step_noise=step_noise,
        diffusion_params=dp, mode=mode,
    )
    flat = latents.cpu().numpy().reshape(num_samples, -1)
    _, _, components, _ = pca_fit_transform(flat, 10)
    return {f"pca_{i}": components[i] for i in range(10)}


def visualize_latent_manipulation(
    result: Dict, output_dir: str, size_factor=None, suffix: str = ""
) -> None:
    """Original vs manipulated panel + trajectory strip."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)

    def prep(img):
        img = np.asarray(img)
        if img.ndim == 4:
            img = img[0]
        img = np.clip(img, 0, 1)
        return img[..., 0] if img.shape[-1] == 1 else img

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    for ax, k, title in (
        (axes[0], "original_image", "Original"),
        (axes[1], "manipulated_image", f"Manipulated (s={result['strength']})"),
    ):
        img = prep(result[k])
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        ax.set_title(title)
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(
        os.path.join(output_dir, f"latent_manipulation{suffix}.png"),
        dpi=300,
        bbox_inches="tight",
    )
    plt.close()

    if "trajectory" in result:
        traj = result["trajectory"]
        n_show = min(8, traj.shape[0])
        idx = np.linspace(0, traj.shape[0] - 1, n_show).astype(int)
        fig, axes = plt.subplots(1, n_show, figsize=(2.5 * n_show, 3))
        for ax, i in zip(np.atleast_1d(axes), idx):
            img = prep((traj[i] + 1) / 2)
            ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
            ax.set_title(f"step {i}")
            ax.axis("off")
        plt.tight_layout()
        plt.savefig(
            os.path.join(output_dir, f"latent_manipulation_trajectory{suffix}.png"),
            dpi=300,
            bbox_inches="tight",
        )
        plt.close()
