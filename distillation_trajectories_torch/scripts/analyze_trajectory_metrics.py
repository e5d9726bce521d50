"""CFG-sweep analysis CLI: heatmaps and radar plots across student sizes
and guidance scales (the flags, defaults, ``--jobs`` semantics, colormap
and file names of ``scripts/analysis/analyze_trajectory_metrics.py``, plus
``--device``).

    python -m distillation_trajectories_torch.scripts.analyze_trajectory_metrics \
        --jobs '[{"output_dir": "analysis/heatmaps"},
                 {"size_factors": "0.1,0.5,0.9", "timesteps": 50,
                  "output_dir": "analysis/trio"}]'

Two halves: :func:`run` loads the teacher and the union of the jobs'
students once and runs every job in one
``sweep_compare_trajectories_multi`` call (teacher chains shared across
jobs); the plot functions draw each job's figures and need matplotlib.
Relative output directories resolve against the config's ``base_dir``
(the checkout root unless ``--base_dir`` is given).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..metrics.transformations import transform_metrics
from ..parallel.distributed import is_main_process
from ..parallel.mesh import require_ranks
from ._common import (
    load_student,
    load_teacher_from_arg,
    parse_axes,
    parse_float_list,
    plots_available,
    resolve_output_dir,
    start_distributed,
)

# Poster teal→purple colormap of the reference plots.
POSTER_COLORS = [
    "#65d0a0", "#50c090", "#41a086", "#47988b", "#4d9090",
    "#538895", "#59809a", "#5f789f", "#6570a4", "#6b68a9",
]

METRICS_TO_ANALYZE = [
    ("path_length_similarity", "Path Length Similarity"),
    ("trajectory_mse", "Trajectory MSE Similarity"),
    ("mean_directional_consistency", "Directional Consistency"),
    ("distribution_similarity", "Distribution Similarity"),
]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Analyze CFG impact across different model sizes using trajectory generation",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--teacher_model", type=str, default=None,
                        help="Teacher checkpoint name (model_epoch_N); latest when omitted")
    parser.add_argument("--size_factors", type=str, default="0.05,0.75,0.1,0.2,0.4,0.6,0.8,1.0",
                        help="Comma-separated list of size factors to compare")
    parser.add_argument("--guidance_scales", type=str,
                        default="1.0,2.0,3.0,5.0,7.5,10.0,15.0,20.0,30.0,50.0",
                        help="Comma-separated list of guidance scales to use")
    parser.add_argument("--timesteps", type=int, default=100,
                        help="Number of timesteps for the diffusion process")
    parser.add_argument("--num_samples", type=int, default=10,
                        help="Number of noise samples to average over")
    parser.add_argument("--output_dir", type=str, default="analysis/heatmaps",
                        help="Directory to save analysis results")
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--num_channels", type=int, default=None)
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Override the output root directory "
                        "(checkpoints are read from <base_dir>/output/models)")
    parser.add_argument(
        "--jobs", type=str, default=None,
        help="JSON list of jobs to run in one process, e.g. "
        '\'[{"output_dir": "analysis/heatmaps"}, {"size_factors": '
        '"0.1,0.5,0.9", "timesteps": 50, "output_dir": "analysis/trio"}]\'. '
        "Each job may override size_factors/guidance_scales/timesteps/"
        "num_samples/output_dir; unset fields inherit the top-level flags. "
        "Checkpoints are loaded once and teacher chains are shared across "
        "jobs with matching (T, scale, samples) cells.",
    )
    parser.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                        help="(data, model) mesh over the launched ranks: the sample "
                        "axis is sharded over data (torchrun --nproc_per_node=D·M)")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on (default: the config's, cuda)")
    return parser.parse_args(argv)


def make_config(args):
    from ..config import Config

    config = Config(base_dir=args.base_dir) if args.base_dir else Config()
    if args.device is not None:
        config.device = args.device
    if args.mesh:
        config.mesh_shape = parse_axes(args.mesh)
    start_distributed(config)
    if args.mesh:
        require_ranks(config.mesh_shape, "--mesh")
    config.timesteps = args.timesteps
    if args.dataset:
        config.dataset = args.dataset
    if args.image_size:
        config.image_size = args.image_size
    if args.num_channels:
        config.channels = args.num_channels
    return config


def job_specs(args, config) -> List[dict]:
    """The jobs of ``--jobs`` (one job of the top-level flags without it),
    with unset fields inherited and output directories made absolute and
    created."""
    if args.jobs:
        specs = json.loads(args.jobs)
        if not isinstance(specs, list) or not specs:
            raise SystemExit("--jobs must be a non-empty JSON list")
    else:
        specs = [{}]
    for spec in specs:
        spec.setdefault("size_factors", args.size_factors)
        spec.setdefault("guidance_scales", args.guidance_scales)
        spec.setdefault("timesteps", args.timesteps)
        spec.setdefault("num_samples", args.num_samples)
        spec.setdefault("output_dir", args.output_dir)
        for key in ("size_factors", "guidance_scales"):
            v = spec[key]
            spec[key] = ([float(x) for x in v] if isinstance(v, (list, tuple))
                         else parse_float_list(v))
        spec["output_dir"] = resolve_output_dir(config, spec["output_dir"])
        os.makedirs(spec["output_dir"], exist_ok=True)
    return specs


def run(args, config=None, specs: Optional[List[dict]] = None) -> List[Dict[float, dict]]:
    """Load the checkpoints and sweep every job: one ``metrics_by_size``
    (``{size_factor: {"teacher_metrics": …, "student_metrics": …}}``) per
    job, an empty dict for a job none of whose students exist."""
    from ..trajectories import sweep_compare_trajectories_multi

    t_start = time.perf_counter()
    config = make_config(args) if config is None else config
    specs = job_specs(args, config) if specs is None else specs
    teacher = load_teacher_from_arg(config, args.teacher_model)
    students = {}
    for size_factor in sorted({sf for s in specs for sf in s["size_factors"]}):
        try:
            students[size_factor] = load_student(config, size_factor)
        except FileNotFoundError:
            print(f"Warning: No models found for size factor {size_factor}")
            continue
        print(f"Computing CFG impact for size factor {size_factor}...")
    print(f"[timing] checkpoint loading: {time.perf_counter() - t_start:.1f}s")

    engine_jobs = [{
        "students": {sf: students[sf] for sf in spec["size_factors"] if sf in students},
        "guidance_scales": spec["guidance_scales"],
        "num_samples": spec["num_samples"],
        "timesteps": spec["timesteps"],
    } for spec in specs]
    live = [job for job in engine_jobs if job["students"]]
    if not live:
        print("No student models found; nothing to analyze")
        return [{} for _ in specs]
    t0 = time.perf_counter()
    results = iter(sweep_compare_trajectories_multi(teacher, live, config))
    print(f"[timing] trajectory sweep: {time.perf_counter() - t0:.1f}s")
    return [next(results) if job["students"] else {} for job in engine_jobs]


def _poster_cmap(plt):
    return plt.cm.colors.LinearSegmentedColormap.from_list("poster_colors", POSTER_COLORS, N=256)


def _savefig(fig_or_plt, path, **kwargs):
    """savefig with fast PNG encoding (zlib level 1 through Pillow) where
    the backend takes it."""
    try:
        fig_or_plt.savefig(path, pil_kwargs={"compress_level": 1}, **kwargs)
    except TypeError:
        fig_or_plt.savefig(path, **kwargs)


def _transformed(metrics, gs):
    sm = metrics["student_metrics"][gs]
    return transform_metrics(sm["path_length_similarity"], sm["trajectory_mse"],
                             sm["mean_directional_consistency"], sm["distribution_similarity"])


def transformed_matrix(metrics_by_size, guidance_scales, metric_key) -> np.ndarray:
    """``[sizes, scales]`` transformed values of one metric, sizes sorted."""
    size_factors = sorted(metrics_by_size)
    data = np.zeros((len(size_factors), len(guidance_scales)))
    for i, sf in enumerate(size_factors):
        for j, gs in enumerate(guidance_scales):
            data[i, j] = _transformed(metrics_by_size[sf], gs)[metric_key]
    return data


def visualize_cfg_heatmap(metrics_by_size, output_dir, guidance_scales):
    """``cfg_heatmap_{metric}.png`` per metric and ``cfg_heatmap_combined.png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    size_factors = sorted(metrics_by_size)
    cmap = _poster_cmap(plt)

    # One figure reused across the four per-metric heatmaps.
    fig = plt.figure(figsize=(12, 8))
    ax = fig.add_subplot(111)
    im = ax.imshow(np.zeros((len(size_factors), len(guidance_scales))),
                   cmap=cmap, aspect="auto", interpolation="nearest")
    cbar = fig.colorbar(im)
    ax.set_xlabel("Guidance Scale", fontsize=12)
    ax.set_ylabel("Model Size Factor", fontsize=12)
    ax.set_xticks(np.arange(len(guidance_scales)))
    ax.set_xticklabels([str(gs) for gs in guidance_scales])
    ax.set_yticks(np.arange(len(size_factors)))
    ax.set_yticklabels([str(sf) for sf in size_factors])
    texts = [[ax.text(j, i, "", ha="center", va="center", color="white", fontsize=10,
                      fontweight="bold") for j in range(len(guidance_scales))]
             for i in range(len(size_factors))]
    for metric_key, metric_name in METRICS_TO_ANALYZE:
        data = transformed_matrix(metrics_by_size, guidance_scales, metric_key)
        im.set_data(data)
        im.set_clim(np.nanmin(data), np.nanmax(data))
        cbar.set_label(f"{metric_name} Value", fontsize=12)
        ax.set_title(f"Impact of CFG on {metric_name}\nAcross Model Sizes and Guidance Scales",
                     fontsize=14, pad=20)
        for i in range(len(size_factors)):
            for j in range(len(guidance_scales)):
                texts[i][j].set_text(f"{data[i, j]:.3f}")
        fig.tight_layout()
        output_path = os.path.join(output_dir, f"cfg_heatmap_{metric_key}.png")
        _savefig(fig, output_path, dpi=300, bbox_inches="tight")
        print(f"Saved {metric_name} heatmap to {output_path}")
    plt.close(fig)

    fig, axs = plt.subplots(2, 2, figsize=(16, 12))
    for ax, (metric_key, metric_name) in zip(axs.flatten(), METRICS_TO_ANALYZE):
        data = transformed_matrix(metrics_by_size, guidance_scales, metric_key)
        im = ax.imshow(data, cmap=cmap, aspect="auto", interpolation="nearest")
        fig.colorbar(im, ax=ax).set_label(f"{metric_name} Value", fontsize=10)
        ax.set_title(metric_name, fontsize=14)
        ax.set_xlabel("Guidance Scale", fontsize=12)
        ax.set_ylabel("Model Size Factor", fontsize=12)
        ax.set_xticks(np.arange(len(guidance_scales)))
        ax.set_xticklabels([str(gs) for gs in guidance_scales])
        ax.set_yticks(np.arange(len(size_factors)))
        ax.set_yticklabels([str(sf) for sf in size_factors])
        for i_sf in range(len(size_factors)):
            for j_gs in range(len(guidance_scales)):
                ax.text(j_gs, i_sf, f"{data[i_sf, j_gs]:.3f}", ha="center", va="center",
                        color="white", fontsize=8, fontweight="bold")
    fig.suptitle("Impact of CFG Across Different Model Sizes and Guidance Scales",
                 fontsize=16, y=0.98)
    plt.tight_layout(rect=[0, 0, 1, 0.95])
    output_path = os.path.join(output_dir, "cfg_heatmap_combined.png")
    _savefig(plt, output_path, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"Saved combined heatmap to {output_path}")


def _radar_angles():
    angles = np.linspace(0, 2 * np.pi, len(METRICS_TO_ANALYZE), endpoint=False)
    return angles, np.concatenate((angles, [angles[0]]))


def _radar_values(metrics, gs):
    t = _transformed(metrics, gs)
    values = [t[k] for k, _ in METRICS_TO_ANALYZE]
    return np.concatenate((values, [values[0]]))


def create_radar_plot_grid(metrics_by_size, output_dir, guidance_scales):
    """``radar_plots_gs_{gs:.1f}.png``: one radar per size, per scale."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    size_factors = sorted(metrics_by_size)
    n_cols = min(3, len(size_factors))
    n_rows = (len(size_factors) + n_cols - 1) // n_cols
    angles, angles_closed = _radar_angles()

    # One figure reused across guidance scales; only the data artists and
    # titles change between frames.
    fig = plt.figure(figsize=(15, 10))
    axes = []
    for idx in range(len(size_factors)):
        ax = plt.subplot(n_rows, n_cols, idx + 1, projection="polar")
        ax.set_xticks(angles)
        ax.set_xticklabels([label for _, label in METRICS_TO_ANALYZE])
        ax.set_ylim(0, 1)
        ax.set_title(" \n ")  # reserves the two-line title box for tight_layout
        axes.append(ax)
    fig.tight_layout()
    for gs in guidance_scales:
        for ax, sf in zip(axes, size_factors):
            for artist in ax.lines[:] + ax.patches[:]:
                artist.remove()
            values = _radar_values(metrics_by_size[sf], gs)
            ax.plot(angles_closed, values, "o-", linewidth=2, color="C0")
            ax.fill(angles_closed, values, alpha=0.25, color="C0")
            ax.set_title(f"Size Factor: {sf:.2f}\nGuidance Scale: {gs:.1f}")
        _savefig(fig, os.path.join(output_dir, f"radar_plots_gs_{gs:.1f}.png"))
    plt.close(fig)


def create_composite_radar_plot(metrics_by_size, output_dir, guidance_scales):
    """``composite_radar_plot_gs_{gs:.1f}.png``: every size on one radar."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    size_factors = sorted(metrics_by_size)
    colors = plt.cm.viridis(np.linspace(0, 1, len(size_factors)))
    angles, angles_closed = _radar_angles()
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="polar")
    ax.set_xticks(angles)
    ax.set_xticklabels([label for _, label in METRICS_TO_ANALYZE])
    ax.set_ylim(0, 1)
    for gs in guidance_scales:
        for artist in ax.lines[:] + ax.patches[:]:
            artist.remove()
        for color, sf in zip(colors, size_factors):
            values = _radar_values(metrics_by_size[sf], gs)
            ax.plot(angles_closed, values, "o-", linewidth=2, color=color,
                    label=f"Size {sf:.2f}")
            ax.fill(angles_closed, values, alpha=0.1, color=color)
        ax.set_title(f"Composite Radar Plot\nGuidance Scale: {gs:.1f}")
        ax.legend(loc="upper right", bbox_to_anchor=(1.3, 1.1))
        _savefig(fig, os.path.join(output_dir, f"composite_radar_plot_gs_{gs:.1f}.png"))
    plt.close(fig)


def main(argv=None):
    t_start = time.perf_counter()
    args = parse_args(argv)
    config = make_config(args)
    specs = job_specs(args, config)
    results = run(args, config, specs)
    shared_s = time.perf_counter() - t_start
    live = [(spec, m) for spec, m in zip(specs, results) if m]
    plots = is_main_process() and plots_available()
    for i, (spec, metrics_by_size) in enumerate(live):
        t_job = time.perf_counter()
        output_dir, guidance_scales = spec["output_dir"], spec["guidance_scales"]
        if plots:
            print("\nVisualizing CFG heatmaps...")
            visualize_cfg_heatmap(metrics_by_size, output_dir, guidance_scales)
            print("\nCreating radar plots...")
            create_radar_plot_grid(metrics_by_size, output_dir, guidance_scales)
            create_composite_radar_plot(metrics_by_size, output_dir, guidance_scales)
        print("\nCFG analysis completed")
        print(f"Results saved in {output_dir}")
        # Per-job marginal seconds (plots only; loading and the sweep are
        # shared), in the line format the full-sweep runner parses.
        print(f"[jobs] job {i} ({os.path.basename(output_dir)}): "
              f"marginal {time.perf_counter() - t_job:.1f}s")
    print(f"[jobs] shared (imports+load+generate): {shared_s:.1f}s")
    print(f"[timing] total: {time.perf_counter() - t_start:.1f}s")
    return results


if __name__ == "__main__":
    main()
