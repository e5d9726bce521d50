"""Show real dataset samples (the port's counterpart of the repository's
``scripts/show_real_samples.py``): a 4x4 grid of the first 16 test images,
then 5 of them one by one.

    python -m distillation_trajectories_torch.scripts.show_real_samples [--base_dir DIR]

``run`` writes ``real_images.png`` under the config's ``results_dir``
without a plotting package; ``main`` then draws the single images with
matplotlib, and says so and skips them where matplotlib is absent.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def run(config):
    """``(grid path, the [16, H, W, C] images)``: the first 16 test images
    of ``config.dataset`` (its synthetic stand-in without the files) as a
    grid of 4 a row."""
    from ..data import get_real_images
    from ..utils.viz import save_image_grid

    config.create_directories()
    print(f"Loading real images from {config.dataset} dataset...")
    images = get_real_images(config, num_images=16)
    path = os.path.join(config.results_dir, "real_images.png")
    save_image_grid(images, path, nrow=4)
    print(f"Saved real images to {path}")
    return path, images


def plot_single_images(images, results_dir, n=5):
    """The first ``n`` images, one 5x5-inch figure each, as
    ``real_image_{i}.png`` (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(n, len(images))
    for i in range(n):
        img = np.clip((images[i] + 1) / 2, 0, 1)
        if img.shape[-1] == 1:
            img = img[..., 0]
        plt.figure(figsize=(5, 5))
        plt.imshow(img, cmap="gray" if img.ndim == 2 else None)
        plt.axis("off")
        plt.title(f"Real Image {i + 1}")
        plt.savefig(os.path.join(results_dir, f"real_image_{i + 1}.png"))
        plt.close()
    print(f"Saved {n} individual real images for closer inspection")


def main(argv=None):
    from ..config import Config
    from ._common import plots_available

    parser = argparse.ArgumentParser(description="Show real dataset samples")
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Override the output root directory")
    args = parser.parse_args(argv)
    config = Config(base_dir=args.base_dir) if args.base_dir else Config()
    _, images = run(config)
    if plots_available():
        plot_single_images(images, config.results_dir)


if __name__ == "__main__":
    main()
