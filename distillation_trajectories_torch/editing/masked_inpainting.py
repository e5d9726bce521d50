"""RePaint-style masked inpainting (port of ``editing/masked_inpainting.py``).

Start from ``mask·noise + (1−mask)·original`` and re-impose the known
region after every reverse step (``post_step``).  ``create_random_mask``
makes the same ``np.random.Generator`` calls in the same order as the JAX
package, so a seed gives the same mask in both.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..diffusion import get_diffusion_params
from ..training.state import make_eval_fn_from_config
from .core import EditingDraws, denoise_with_trajectory, editing_device, to_image


def create_random_mask(
    height: int,
    width: int,
    min_size: float = 0.2,
    max_size: float = 0.5,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random rectangular mask; 1 = inpaint region."""
    if rng is None:
        rng = np.random.default_rng()
    mask = np.zeros((height, width), dtype=np.float32)
    mask_h = int(rng.uniform(min_size, max_size) * height)
    mask_w = int(rng.uniform(min_size, max_size) * width)
    mask_y = int(rng.integers(0, height - mask_h))
    mask_x = int(rng.integers(0, width - mask_w))
    mask[mask_y : mask_y + mask_h, mask_x : mask_x + mask_w] = 1.0
    return mask


def apply_masked_inpainting(
    model: torch.nn.Module,
    config,
    original_image,
    mask=None,
    record_trajectory: bool = True,
    seed: int = 0,
    mode: str = "engine",
    draws=None,
) -> Dict:
    """Inpaint the masked region of ``original_image`` (in [0, 1], NHWC or
    HWC) on ``config.device`` over ``config.timesteps − 1`` steps.

    The starting and step noise are ``draws.chain(seed, shape, T − 1)``
    (default :class:`.core.EditingDraws`).  Returns host numpy arrays: the
    original and inpainted images, the mask broadcast to the image, and
    optionally the trajectory ``[T + 1, B, H, W, C]``.
    """
    device = editing_device(model, config)
    model_fn = make_eval_fn_from_config(model, config)
    dp = get_diffusion_params(config.timesteps, config)
    draws = draws or EditingDraws(device)

    original = torch.as_tensor(original_image, dtype=torch.float32).to(device)
    if original.ndim == 3:
        original = original[None]
    if mask is None:
        mask = create_random_mask(config.image_size, config.image_size,
                                  rng=np.random.default_rng(seed))
    mask = torch.as_tensor(mask, dtype=torch.float32).to(device)
    if mask.ndim == 2:
        mask = mask[None, :, :, None]
    mask = mask.expand(original.shape).contiguous()

    original_scaled = 2.0 * original - 1.0  # [0,1] → model space
    start_t = config.timesteps - 1
    noise, step_noise = draws.chain(seed, tuple(original.shape), start_t)
    x = mask * noise.to(device) + (1.0 - mask) * original_scaled

    def reimpose(z):
        return mask * z + (1.0 - mask) * original_scaled

    x_final, trajectory = denoise_with_trajectory(
        model_fn, x, dp["alphas"], start_t, step_noise=step_noise, post_step=reimpose,
        diffusion_params=dp, mode=mode,
    )
    result = {
        "original_image": original.cpu().numpy(),
        "inpainted_image": to_image(x_final).cpu().numpy(),
        "mask": mask.cpu().numpy(),
    }
    if record_trajectory:
        result["trajectory"] = trajectory.cpu().numpy()
    return result


def visualize_inpainting(result: Dict, output_dir: str, suffix: str = "") -> None:
    """Original / mask / inpainted panel + red-tinted mask-evolution strip."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)

    def show(ax, img, title):
        img = np.asarray(img)
        if img.ndim == 4:
            img = img[0]
        img = np.clip(img, 0, 1)
        if img.shape[-1] == 1:
            img = img[..., 0]
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        ax.set_title(title)
        ax.axis("off")

    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    show(axes[0], result["original_image"], "Original")
    show(axes[1], result["mask"], "Mask")
    show(axes[2], result["inpainted_image"], "Inpainted")
    plt.tight_layout()
    plt.savefig(
        os.path.join(output_dir, f"inpainting{suffix}.png"), dpi=300,
        bbox_inches="tight",
    )
    plt.close()

    if "trajectory" in result:
        traj = result["trajectory"]
        mask = np.asarray(result["mask"])[0]
        n_show = min(8, traj.shape[0])
        idx = np.linspace(0, traj.shape[0] - 1, n_show).astype(int)
        fig, axes = plt.subplots(1, n_show, figsize=(2.5 * n_show, 3))
        for ax, i in zip(np.atleast_1d(axes), idx):
            img = np.clip((traj[i, 0] + 1) / 2, 0, 1)
            if img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            # red-tint the masked region
            tint = img.copy()
            m = mask[..., :1]
            tint[..., 0] = np.clip(tint[..., 0] + 0.3 * m[..., 0], 0, 1)
            ax.imshow(tint)
            ax.set_title(f"t={i}")
            ax.axis("off")
        plt.tight_layout()
        plt.savefig(
            os.path.join(output_dir, f"inpainting_trajectory{suffix}.png"),
            dpi=300,
            bbox_inches="tight",
        )
        plt.close()
