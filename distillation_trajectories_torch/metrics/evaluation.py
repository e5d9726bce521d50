"""Standalone evaluation metrics: LPIPS, FID, trajectory divergence (port
of ``metrics/evaluation.py``).

* :func:`compute_lpips` — the ``lpips`` package when it imports and builds,
  else the port's AlexNet-LPIPS (``metrics/lpips.py``) when pretrained
  weights are present, else the reference's placeholder 0.5 per pair with
  a warning.  A failed ``lpips`` build is tried once per process.
* :func:`compute_fid` — the FID core of ``metrics/fid.py``.
* :func:`compute_trajectory_divergence` — per-step L2 distance, cosine
  similarity and path-length ratio of two trajectories.
* :func:`visualize_evaluation_metrics` — plots (matplotlib, imported when
  called) and ``metrics_summary.txt``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_device
from .fid import InceptionModel, calculate_fid

# Backend cache: "torch" holds the lpips package's scorer, or None once it
# failed; ("alex", weights_path, device) holds (scorer, pretrained).
_LPIPS_CACHE: Dict[object, object] = {}


def _lpips_package(x: np.ndarray, y: np.ndarray) -> Optional[List[float]]:
    """Distances from the ``lpips`` package, or None when it is absent or
    cannot be built (tried once per process)."""
    if _LPIPS_CACHE.get("torch", "unset") is None:
        return None
    try:
        import lpips

        if "torch" not in _LPIPS_CACHE:
            # Building LPIPS(net="alex") downloads the backbone on first
            # use; without a network that raises, not ImportError.
            _LPIPS_CACHE["torch"] = lpips.LPIPS(net="alex")
        loss_fn = _LPIPS_CACHE["torch"]

        def to_nchw(a):
            if a.ndim == 3:
                a = a[:, None]
            elif a.shape[-1] in (1, 3):
                a = a.transpose(0, 3, 1, 2)
            if a.shape[1] == 1:
                a = np.repeat(a, 3, axis=1)
            return torch.from_numpy(np.ascontiguousarray(a))

        with torch.no_grad():
            d = loss_fn(to_nchw(x), to_nchw(y))
        return [float(v) for v in d.reshape(-1)]
    except ImportError:
        _LPIPS_CACHE["torch"] = None
    except Exception as e:  # noqa: BLE001 - any build failure falls through
        _LPIPS_CACHE["torch"] = None
        print(f"Warning: lpips package backend unavailable ({e}); trying AlexNet-LPIPS")
    return None


def compute_lpips(images1, images2, weights_path: Optional[str] = None,
                  device=None) -> List[float]:
    """LPIPS per image pair (inputs in [0, 1], the reference convention).
    The port's AlexNet-LPIPS runs on ``device`` (default ``cuda``)."""
    from .lpips import _weights_search_paths, create_lpips

    n = min(len(images1), len(images2))
    x = 2.0 * np.asarray(images1)[:n].astype(np.float32) - 1.0
    y = 2.0 * np.asarray(images2)[:n].astype(np.float32) - 1.0

    out = _lpips_package(x, y)
    if out is not None:
        return out

    device = resolve_device("cuda" if device is None else device)
    key = ("alex", weights_path, str(device))
    weights_available = any(
        p and os.path.exists(p)
        for p in ([weights_path] if weights_path else _weights_search_paths())
    )
    cached = _LPIPS_CACHE.get(key)
    # A scorer without weights is rebuilt once a weights file appears.
    if cached is None or (not cached[1] and weights_available):
        _LPIPS_CACHE[key] = create_lpips(weights_path, device=device)
    scorer, pretrained = _LPIPS_CACHE[key]
    if pretrained:
        if x.ndim == 3:
            x, y = x[..., None], y[..., None]
        with torch.no_grad():
            return [float(v) for v in scorer(torch.from_numpy(x), torch.from_numpy(y)).cpu()]

    print("Warning: no LPIPS backend (lpips package absent, no ported "
          "weights); returning placeholder 0.5 per pair (matches reference "
          "fallback)")
    return [0.5] * n


def compute_fid(real_images, generated_images, inception: Optional[InceptionModel] = None,
                device=None) -> float:
    """FID between two image sets in [−1, 1] (features on ``device``,
    default ``cuda``)."""
    if inception is None:
        inception = InceptionModel(device=device)
    return calculate_fid(inception.get_features(real_images),
                         inception.get_features(generated_images))


def _images(traj) -> np.ndarray:
    if isinstance(traj, (list, tuple)):
        if isinstance(traj[0], tuple):
            traj = [item[0] for item in traj]
        return np.stack([np.asarray(x) for x in traj])
    return np.asarray(traj)


def compute_trajectory_divergence(trajectory1, trajectory2, device=None) -> Dict:
    """Per-step L2 distance, cosine similarity and the path-length ratio
    (second over first) of two trajectories, on ``device`` (default
    ``cuda``)."""
    device = resolve_device("cuda" if device is None else device)
    x, y = _images(trajectory1), _images(trajectory2)
    n = min(x.shape[0], y.shape[0])
    xf = torch.as_tensor(x[:n].reshape(n, -1), dtype=torch.float32, device=device)
    yf = torch.as_tensor(y[:n].reshape(n, -1), dtype=torch.float32, device=device)
    norm = torch.linalg.vector_norm
    distances = norm(xf - yf, dim=1)
    similarities = ((xf / norm(xf, dim=1, keepdim=True))
                    * (yf / norm(yf, dim=1, keepdim=True))).sum(dim=1)
    lengths = torch.stack([norm(xf[1:] - xf[:-1], dim=1).sum(),
                           norm(yf[1:] - yf[:-1], dim=1).sum()])
    distances, similarities, lengths = (t.cpu().numpy() for t in (distances, similarities, lengths))
    length1, length2 = float(lengths[0]), float(lengths[1])
    return {
        "distances": distances.tolist(),
        "similarities": similarities.tolist(),
        "avg_distance": float(np.mean(distances)),
        "max_distance": float(np.max(distances)),
        "avg_similarity": float(np.mean(similarities)),
        "min_similarity": float(np.min(similarities)),
        "length_ratio": length2 / length1 if length1 > 0 else float("inf"),
    }


def visualize_evaluation_metrics(metrics: Dict, output_dir: str,
                                 size_factor: Optional[float] = None) -> None:
    """Bar and line plots of LPIPS, FID and trajectory divergence, and
    ``metrics_summary.txt`` (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    suffix = f" (Size Factor: {size_factor})" if size_factor else ""

    if "lpips" in metrics:
        plt.figure(figsize=(10, 6))
        plt.bar(range(len(metrics["lpips"])), metrics["lpips"])
        plt.axhline(y=np.mean(metrics["lpips"]), color="r", linestyle="--",
                    label=f'Mean: {np.mean(metrics["lpips"]):.4f}')
        plt.title(f"LPIPS Distances{suffix}")
        plt.xlabel("Sample")
        plt.ylabel("LPIPS Distance")
        plt.legend()
        plt.grid(True, linestyle="--", alpha=0.7)
        plt.savefig(os.path.join(output_dir, "lpips_distances.png"), dpi=300,
                    bbox_inches="tight")
        plt.close()

    if "fid" in metrics:
        plt.figure(figsize=(8, 5))
        plt.bar(["FID Score"], [metrics["fid"]])
        plt.title(f"FID Score{suffix}")
        plt.ylabel("FID")
        plt.grid(True, linestyle="--", alpha=0.7)
        plt.savefig(os.path.join(output_dir, "fid_score.png"), dpi=300, bbox_inches="tight")
        plt.close()

    if "trajectory_divergence" in metrics:
        td = metrics["trajectory_divergence"]
        for key, avg_key, name, ylabel in (
            ("distances", "avg_distance", "trajectory_distances", "Distance"),
            ("similarities", "avg_similarity", "trajectory_similarities", "Cosine Similarity"),
        ):
            plt.figure(figsize=(12, 6))
            plt.plot(td[key])
            plt.axhline(y=td[avg_key], color="r", linestyle="--",
                        label=f"Mean: {td[avg_key]:.4f}")
            plt.title(name.replace("_", " ").title() + suffix)
            plt.xlabel("Step")
            plt.ylabel(ylabel)
            plt.legend()
            plt.grid(True, linestyle="--", alpha=0.7)
            plt.savefig(os.path.join(output_dir, f"{name}.png"), dpi=300, bbox_inches="tight")
            plt.close()

    with open(os.path.join(output_dir, "metrics_summary.txt"), "w") as f:
        f.write(f"Evaluation Metrics Summary (Size Factor: "
                f"{size_factor if size_factor else 'N/A'})\n")
        f.write("=" * 50 + "\n\n")
        if "lpips" in metrics:
            f.write(f"LPIPS Mean: {np.mean(metrics['lpips']):.4f}\n")
        if "fid" in metrics:
            f.write(f"FID Score: {metrics['fid']:.4f}\n")
        if "trajectory_divergence" in metrics:
            td = metrics["trajectory_divergence"]
            f.write("\nTrajectory Divergence:\n")
            f.write(f"  Average Distance: {td['avg_distance']:.4f}\n")
            f.write(f"  Maximum Distance: {td['max_distance']:.4f}\n")
            f.write(f"  Average Similarity: {td['avg_similarity']:.4f}\n")
            f.write(f"  Minimum Similarity: {td['min_similarity']:.4f}\n")
            f.write(f"  Length Ratio: {td['length_ratio']:.4f}\n")


visualize_metrics = visualize_evaluation_metrics
