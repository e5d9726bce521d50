"""Dimensionality-reduction trajectory analysis: PCA, t-SNE and UMAP
(port of ``analysis/dimensionality.py``).

``pca_fit_transform``, ``umap_fallback_embedding`` and ``_traj_images`` are
numpy copies of the JAX package's.  Two halves:
:func:`dimensionality_embeddings` computes the embeddings (PCA by SVD;
t-SNE through sklearn when it imports, up to 500 points; UMAP through
umap-learn when it imports, else the numpy fallback) and imports no
plotting library; :func:`plot_dimensionality` draws
``size_{sf}/trajectory_{i}/{pca,tsne,umap}_trajectory.png`` and needs
matplotlib.  :func:`dimensionality_reduction_analysis` is the JAX-named
function: both halves.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def pca_fit_transform(data: np.ndarray, n_components: int):
    """PCA via SVD; returns (embedding, explained_variance_ratio, components,
    mean)."""
    mean = data.mean(axis=0)
    centered = data - mean
    u, s, vt = np.linalg.svd(centered, full_matrices=False)
    var = (s**2) / max(len(data) - 1, 1)
    ratio = var / var.sum() if var.sum() > 0 else var
    emb = centered @ vt[:n_components].T
    return emb, ratio[:n_components], vt[:n_components], mean


def umap_fallback_embedding(
    data: np.ndarray,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    random_state: int = 42,
    n_epochs: int = 200,
) -> np.ndarray:
    """Pure-numpy UMAP-style 2-D embedding (no umap-learn dependency).

    The core of UMAP (McInnes et al. 2018) at the scale of this analysis (a
    few hundred trajectory points): the fuzzy k-NN graph with per-point
    bandwidths binary-searched so the neighbour weights sum to log2(k),
    symmetrised by the probabilistic t-conorm, a normalised-Laplacian
    spectral initialisation, then umap-learn's optimisation schedule
    (edges sampled in proportion to their weight, both endpoints moved,
    ``negative_sample_rate`` random repulsions per sampled edge, clipped
    gradients).  Not bit-compatible with umap-learn (other random streams,
    dense bookkeeping).
    """
    rng = np.random.default_rng(random_state)
    n = len(data)
    k = int(min(n_neighbors, n - 1))
    d2 = np.sum((data[:, None, :] - data[None, :, :]) ** 2, axis=-1)
    dist = np.sqrt(np.maximum(d2, 0.0))
    np.fill_diagonal(dist, np.inf)

    # Fuzzy simplicial set: rho = nearest-neighbor distance, sigma by binary
    # search so sum_j exp(-(d_ij - rho_i)/sigma_i) = log2(k) over the kNN.
    knn_idx = np.argsort(dist, axis=1)[:, :k]
    knn_d = np.take_along_axis(dist, knn_idx, axis=1)
    rho = knn_d[:, 0]
    target = np.log2(k) if k > 1 else 1.0
    sigma = np.ones(n)
    for i in range(n):
        lo, hi = 1e-8, 1e3
        di = np.maximum(knn_d[i] - rho[i], 0.0)
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            s = np.exp(-di / mid).sum()
            if s > target:
                hi = mid
            else:
                lo = mid
        sigma[i] = 0.5 * (lo + hi)

    P = np.zeros((n, n))
    rows = np.repeat(np.arange(n), k)
    cols = knn_idx.reshape(-1)
    vals = np.exp(
        -np.maximum(knn_d - rho[:, None], 0.0) / sigma[:, None]
    ).reshape(-1)
    P[rows, cols] = vals
    P = P + P.T - P * P.T  # probabilistic t-conorm symmetrization

    # Spectral initialization: bottom non-trivial eigenvectors of the
    # symmetric normalized Laplacian of the fuzzy graph.
    deg = P.sum(axis=1)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    L = np.eye(n) - (dinv[:, None] * P) * dinv[None, :]
    w, v = np.linalg.eigh(L)
    emb = v[:, 1:3] * 10.0
    emb = emb + rng.normal(scale=1e-4, size=emb.shape)

    # Low-dim kernel 1/(1 + a d^(2b)) with (a, b) fitted to min_dist the way
    # umap-learn does (least squares on the target curve).
    xs = np.linspace(0.0, 3.0, 300)
    ys = np.where(xs < min_dist, 1.0, np.exp(-(xs - min_dist)))
    best, ab = np.inf, (1.577, 0.895)
    for a in np.linspace(0.5, 3.0, 26):
        for b in np.linspace(0.5, 2.0, 31):
            err = np.mean((1.0 / (1.0 + a * xs ** (2 * b)) - ys) ** 2)
            if err < best:
                best, ab = err, (a, b)
    a, b = ab

    # Force refinement with umap-learn's negative-sampling schedule: each
    # epoch samples edges with probability P_e / P_max, attracts both
    # endpoints along each sampled edge, and repels the head from
    # `negative_sample_rate` uniform random points per sampled edge, with
    # umap-learn's gradient forms and per-component clip to [-4, 4].
    negative_sample_rate = 5
    # Directed edges of the symmetrized graph: each undirected edge appears
    # twice, so both endpoints take a turn as head and are repelled.
    P_offdiag = P.copy()
    np.fill_diagonal(P_offdiag, 0.0)
    heads, tails = np.nonzero(P_offdiag)
    weights = P[heads, tails]
    if len(heads) == 0:
        return emb
    sample_prob = weights / weights.max()
    alpha0 = 1.0
    for epoch in range(n_epochs):
        alpha = alpha0 * (1.0 - epoch / n_epochs)
        picked = rng.random(len(heads)) < sample_prob
        if not picked.any():
            continue
        i, j = heads[picked], tails[picked]

        # Attraction: move i toward j and j toward i.
        diff = emb[i] - emb[j]
        dd2 = np.sum(diff**2, axis=-1) + 1e-12
        coeff = (-2.0 * a * b * dd2 ** (b - 1.0)) / (1.0 + a * dd2**b)
        grad = np.clip(coeff[:, None] * diff, -4.0, 4.0)
        np.add.at(emb, i, alpha * grad)
        np.add.at(emb, j, -alpha * grad)

        # Repulsion: for each sampled edge, negative_sample_rate uniform
        # random "non-neighbors" push the head away.
        m = len(i)
        neg_i = np.repeat(i, negative_sample_rate)
        neg_k = rng.integers(0, n, size=m * negative_sample_rate)
        keep = neg_i != neg_k
        neg_i, neg_k = neg_i[keep], neg_k[keep]
        diff = emb[neg_i] - emb[neg_k]
        dd2 = np.sum(diff**2, axis=-1) + 1e-12
        coeff = (2.0 * b) / ((0.001 + dd2) * (1.0 + a * dd2**b))
        grad = np.clip(coeff[:, None] * diff, -4.0, 4.0)
        np.add.at(emb, neg_i, alpha * grad)
    return emb


def _traj_images(traj):
    if isinstance(traj[0], tuple):
        traj = [item[0] for item in traj]
    return np.stack([np.asarray(x) for x in traj]) if isinstance(
        traj, (list, tuple)
    ) else np.asarray(traj)


def _joint_rows(teacher_traj, student_traj):
    """``(combined [n_t + n_s, D], n_t)``: both trajectories' states as rows."""
    t_imgs = _traj_images(teacher_traj)
    s_imgs = _traj_images(student_traj)
    t_flat = t_imgs.reshape(t_imgs.shape[0], -1)
    s_flat = s_imgs.reshape(s_imgs.shape[0], -1)
    return np.vstack([t_flat, s_flat]), len(t_flat)


def dimensionality_embeddings(teacher_trajectories, student_trajectories,
                              max_trajectories: int = 3) -> List[Dict]:
    """Joint 2-D embeddings of the first ``max_trajectories`` pairs.

    Each entry holds ``n_teacher`` (the teacher's rows come first), ``pca``
    and ``pca_ratio``; ``tsne`` (None when skipped, with the reason in
    ``tsne_skipped``: more than 500 points, or sklearn missing, in the JAX
    package's words); ``umap`` and ``umap_method`` (``"umap-learn"`` or
    ``"numpy fallback"``).
    """
    out = []
    for traj_idx, (teacher_traj, student_traj) in enumerate(
        zip(teacher_trajectories, student_trajectories)
    ):
        if traj_idx >= max_trajectories:
            break
        combined, n_teacher = _joint_rows(teacher_traj, student_traj)
        entry: Dict = {"n_teacher": n_teacher, "tsne": None, "tsne_skipped": None}

        print(f"  Performing PCA for trajectory {traj_idx}...")
        entry["pca"], entry["pca_ratio"], _, _ = pca_fit_transform(combined, 2)

        if len(combined) <= 500:
            print(f"  Performing t-SNE for trajectory {traj_idx}...")
            try:
                from sklearn.manifold import TSNE
            except ImportError as e:
                entry["tsne_skipped"] = f"Error performing t-SNE: {e}"
                print(f"  {entry['tsne_skipped']}")
            else:
                tsne = TSNE(
                    n_components=2,
                    perplexity=min(30, max(len(combined) // 5, 2)),
                    random_state=42,
                )
                entry["tsne"] = tsne.fit_transform(combined)
        else:
            entry["tsne_skipped"] = f"Skipping t-SNE for trajectory {traj_idx} (too many points)"
            print(f"  {entry['tsne_skipped']}")

        print(f"  Performing UMAP for trajectory {traj_idx}...")
        n_neighbors = min(15, max(len(combined) // 3, 2))
        try:
            import umap
        except ImportError:
            print("  umap-learn not installed; using numpy UMAP fallback")
            entry["umap"] = umap_fallback_embedding(
                combined, n_neighbors=n_neighbors, min_dist=0.1, random_state=42)
            entry["umap_method"] = "numpy fallback"
        else:
            reducer = umap.UMAP(n_components=2, random_state=42,
                                n_neighbors=n_neighbors, min_dist=0.1)
            entry["umap"] = reducer.fit_transform(combined)
            entry["umap_method"] = "umap-learn"
        out.append(entry)
    return out


def _plot_embedding(
    teacher_emb, student_emb, title, xlabel, ylabel, path
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 8))
    teacher_colors = plt.cm.Blues(np.linspace(0.3, 1.0, len(teacher_emb)))
    student_colors = plt.cm.Oranges(np.linspace(0.3, 1.0, len(student_emb)))

    for emb, colors in ((teacher_emb, teacher_colors), (student_emb, student_colors)):
        for i in range(len(emb) - 1):
            plt.scatter(emb[i, 0], emb[i, 1], color=colors[i], marker="o", s=50,
                        alpha=0.7)
            plt.arrow(
                emb[i, 0], emb[i, 1],
                emb[i + 1, 0] - emb[i, 0], emb[i + 1, 1] - emb[i, 1],
                color=colors[i], width=0.01, head_width=0.1, alpha=0.5,
            )
    plt.scatter(teacher_emb[-1, 0], teacher_emb[-1, 1], color=teacher_colors[-1],
                marker="*", s=200, alpha=0.7, label="Teacher End")
    plt.scatter(student_emb[-1, 0], student_emb[-1, 1], color=student_colors[-1],
                marker="*", s=200, alpha=0.7, label="Student End")
    plt.scatter(teacher_emb[0, 0], teacher_emb[0, 1], color="blue", marker="D",
                s=100, alpha=1.0, label="Teacher Start")
    plt.scatter(student_emb[0, 0], student_emb[0, 1], color="orange", marker="D",
                s=100, alpha=1.0, label="Student Start")
    plt.title(title)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.grid(True, linestyle="--", alpha=0.7)
    plt.legend()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()


def plot_dimensionality(embeddings: List[Dict], output_dir: str,
                        size_factor: Optional[float] = None) -> None:
    """``trajectory_{i}/{pca,tsne,umap}_trajectory.png`` under
    ``output_dir`` for :func:`dimensionality_embeddings`' entries."""
    for traj_idx, entry in enumerate(embeddings):
        traj_dir = os.path.join(output_dir, f"trajectory_{traj_idx}")
        os.makedirs(traj_dir, exist_ok=True)
        n, ratio = entry["n_teacher"], entry["pca_ratio"]
        _plot_embedding(
            entry["pca"][:n], entry["pca"][n:],
            f"PCA - Trajectory {traj_idx} (Size Factor: {size_factor})",
            f"Principal Component 1 (Variance: {ratio[0]:.2%})",
            f"Principal Component 2 (Variance: {ratio[1]:.2%})",
            os.path.join(traj_dir, "pca_trajectory.png"),
        )
        if entry["tsne"] is not None:
            _plot_embedding(
                entry["tsne"][:n], entry["tsne"][n:],
                f"t-SNE - Trajectory {traj_idx} (Size Factor: {size_factor})",
                "t-SNE Dimension 1", "t-SNE Dimension 2",
                os.path.join(traj_dir, "tsne_trajectory.png"),
            )
        label = "UMAP" if entry["umap_method"] == "umap-learn" else "UMAP (numpy fallback)"
        _plot_embedding(
            entry["umap"][:n], entry["umap"][n:],
            f"{label} - Trajectory {traj_idx} (Size Factor: {size_factor})",
            "UMAP Dimension 1", "UMAP Dimension 2",
            os.path.join(traj_dir, "umap_trajectory.png"),
        )


def dimensionality_output_dir(config, size_factor: Optional[float] = None) -> str:
    """``{config.dimensionality_dir}[/size_{sf}]``."""
    output_dir = config.dimensionality_dir
    if size_factor is not None:
        output_dir = os.path.join(output_dir, f"size_{size_factor}")
    return output_dir


def dimensionality_reduction_analysis(
    teacher_trajectories,
    student_trajectories,
    config,
    output_dir: Optional[str] = None,
    size_factor: Optional[float] = None,
    max_trajectories: int = 3,
) -> str:
    """Embeddings and plots of up to ``max_trajectories`` pairs; returns
    the absolute output directory.  As in the JAX package, the plots go
    under ``config.dimensionality_dir`` whatever ``output_dir`` says."""
    output_dir = dimensionality_output_dir(config, size_factor)
    os.makedirs(output_dir, exist_ok=True)
    print(
        f"Performing dimensionality reduction analysis for size factor "
        f"{size_factor}..."
    )
    embeddings = dimensionality_embeddings(
        teacher_trajectories, student_trajectories, max_trajectories)
    plot_dimensionality(embeddings, output_dir, size_factor)
    print(
        f"Dimensionality reduction analysis completed for size factor {size_factor}"
    )
    return os.path.abspath(output_dir)
