"""Analyze the latest generated sample grid (the port's counterpart of the
repository's ``scripts/analyze_latest_sample.py``): basic statistics, the
local patch-correlation structure score, and a training-progress verdict.

    python -m distillation_trajectories_torch.scripts.analyze_latest_sample [--base_dir DIR]

It reads the newest ``samples_epoch_*.png`` under the config's
``results_dir`` with ``utils/viz.py::read_png`` (no PIL).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional

import numpy as np


def structure_score(sample_img: np.ndarray, patch_size: int = 16) -> float:
    """Mean |corr| between vertically adjacent patches."""
    rows = sample_img.shape[0] // patch_size
    cols = sample_img.shape[1] // patch_size
    score, count = 0.0, 0
    for i in range(rows - 1):
        for j in range(cols - 1):
            p1 = sample_img[i * patch_size:(i + 1) * patch_size,
                            j * patch_size:(j + 1) * patch_size]
            p2 = sample_img[(i + 1) * patch_size:(i + 2) * patch_size,
                            j * patch_size:(j + 1) * patch_size]
            if p1.size and p2.size:
                c = np.corrcoef(p1.flatten(), p2.flatten())[0, 1]
                if not np.isnan(c):
                    score += abs(c)
            count += 1
    return score / count if count else 0.0


def _epoch_of(path: str) -> int:
    return int(path.split("_")[-1].split(".")[0])


def run(results_dir: str) -> Optional[dict]:
    """Print the analysis of the newest sample grid under ``results_dir``;
    returns its file, epoch, image and structure score (None without one)."""
    from ..utils.viz import read_png

    sample_files = glob.glob(os.path.join(results_dir, "samples_epoch_*.png"))
    if not sample_files:
        print(f"No sample images found in {results_dir}")
        return None
    latest = max(sample_files, key=_epoch_of)
    epoch_num = _epoch_of(latest)
    print(f"Analyzing latest sample image: {os.path.basename(latest)} "
          f"(Epoch {epoch_num})")

    img = read_png(latest)
    print("\nImage Statistics:")
    print(f"  Shape: {img.shape}")
    print(f"  Min value: {img.min()}")
    print(f"  Max value: {img.max()}")
    print(f"  Mean value: {img.mean():.2f}")
    print(f"  Std deviation: {img.std():.2f}")

    print("\nStructure Analysis:")
    if img.ndim > 2 and img.shape[2] >= 3:
        for i, channel in enumerate(["Red", "Green", "Blue"]):
            print(f"  {channel} channel variance: {np.var(img[:, :, i]):.2f}")

    s = structure_score(img)
    print(f"  Local structure score: {s:.4f} "
          "(higher values indicate more structure)")

    if s < 0.1:
        print("\nProgress Assessment: EARLY STAGE")
        print("Your samples still appear mostly random. This is normal for "
              "early training.")
    elif s < 0.3:
        print("\nProgress Assessment: DEVELOPING STRUCTURE")
        print("Your samples are beginning to show basic patterns and color "
              "grouping.")
    elif s < 0.5:
        print("\nProgress Assessment: INTERMEDIATE PROGRESS")
        print("Your samples now show recognizable patterns and shapes.")
    else:
        print("\nProgress Assessment: ADVANCED STAGE")
        print("Your samples contain clear structure and possibly "
              "recognizable objects.")

    print("\nRecommendation:")
    if epoch_num < 50:
        print(f"  Continue training for at least {50 - epoch_num} more epochs")
    else:
        print("  You've trained for a good number of epochs")
    return {"file": latest, "epoch": epoch_num, "image": img, "structure_score": s}


def main(argv=None):
    from ..config import Config

    parser = argparse.ArgumentParser(description="Analyze the latest sample grid")
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Output root whose results_dir holds the grids")
    args = parser.parse_args(argv)
    config = Config(base_dir=args.base_dir) if args.base_dir else Config()
    return run(config.results_dir)


if __name__ == "__main__":
    main()
