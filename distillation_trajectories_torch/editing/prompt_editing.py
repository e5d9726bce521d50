"""Simulated prompt-based editing (port of ``editing/prompt_editing.py``).

The model is unconditional, so "prompt editing" is two generations from
seeds ``seed`` and ``seed + 1`` standing in for two prompts, run as two
chains, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..diffusion import get_diffusion_params
from ..training.state import make_eval_fn_from_config
from .core import EditingDraws, denoise_with_trajectory, editing_device, to_image


def generate_image_with_trajectory(model, config, seed: int = 0, mode: str = "engine",
                                   draws=None):
    """One unconditional generation: host ``(image in [0, 1],
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
    return to_image(x_final).cpu().numpy(), trajectory.cpu().numpy()


def apply_prompt_editing(
    model,
    config,
    original_prompt: str = "original",
    edited_prompt: str = "edited",
    record_trajectory: bool = True,
    seed: Optional[int] = None,
    mode: str = "engine",
    draws=None,
) -> Dict:
    """Simulated prompt edit: the same pipeline from ``seed`` and
    ``seed + 1`` (``seed`` drawn from 0–9999 when None)."""
    if seed is None:
        seed = int(np.random.default_rng().integers(0, 10000))

    original_image, original_trajectory = generate_image_with_trajectory(
        model, config, seed=seed, mode=mode, draws=draws
    )
    edited_image, edited_trajectory = generate_image_with_trajectory(
        model, config, seed=seed + 1, mode=mode, draws=draws
    )

    result = {
        "original_image": original_image,
        "edited_image": edited_image,
        "original_prompt": original_prompt,
        "edited_prompt": edited_prompt,
    }
    if record_trajectory:
        result["original_trajectory"] = original_trajectory
        result["edited_trajectory"] = edited_trajectory
    return result


def visualize_prompt_editing(result: Dict, output_dir: str, suffix: str = "") -> None:
    """Side-by-side original/edited + paired trajectory strips."""
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
        (axes[0], "original_image", f'"{result["original_prompt"]}"'),
        (axes[1], "edited_image", f'"{result["edited_prompt"]}"'),
    ):
        img = prep(result[k])
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        ax.set_title(title)
        ax.axis("off")
    plt.suptitle("Prompt Editing (simulated)")
    plt.tight_layout()
    plt.savefig(
        os.path.join(output_dir, f"prompt_editing{suffix}.png"), dpi=300,
        bbox_inches="tight",
    )
    plt.close()

    if "original_trajectory" in result:
        n_show = 6
        fig, axes = plt.subplots(2, n_show, figsize=(2.5 * n_show, 6))
        for row, key, label in (
            (0, "original_trajectory", "Original"),
            (1, "edited_trajectory", "Edited"),
        ):
            traj = result[key]
            idx = np.linspace(0, traj.shape[0] - 1, n_show).astype(int)
            for c, i in enumerate(idx):
                img = prep((traj[i] + 1) / 2)
                axes[row, c].imshow(img, cmap="gray" if img.ndim == 2 else None)
                axes[row, c].axis("off")
                if c == 0:
                    axes[row, c].set_ylabel(label)
                if row == 0:
                    axes[row, c].set_title(f"step {i}")
        plt.tight_layout()
        plt.savefig(
            os.path.join(output_dir, f"prompt_editing_trajectories{suffix}.png"),
            dpi=300,
            bbox_inches="tight",
        )
        plt.close()
