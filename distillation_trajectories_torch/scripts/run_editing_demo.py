"""Editing demo CLI: inpainting, latent manipulation and prompt editing on
the trained teacher (the flags of ``scripts/run_editing_demo.py``, plus
``--device``).

    python -m distillation_trajectories_torch.scripts.run_editing_demo

Two halves: :func:`run` loads the teacher and returns the three results
and the PCA directions, importing no plotting library; :func:`plot` draws
the JAX CLI's PNGs under ``config.analysis_dir/editing``.  ``--spatial D,S``
runs every forward spatially partitioned over the launched ranks
(``torchrun --nproc_per_node=D·S``); rank 0 draws the PNGs.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np

from ..parallel.distributed import is_main_process
from ..parallel.mesh import require_ranks
from ._common import load_teacher_from_arg, parse_axes, start_distributed

DIRECTION_SAMPLES = 32  # generations behind the PCA directions, as in the JAX CLI


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run inpainting / latent-manipulation / prompt-editing demos",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--teacher_model", type=str, default=None)
    parser.add_argument("--timesteps", type=int, default=50)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--strength", type=float, default=2.0,
                        help="Latent manipulation strength")
    parser.add_argument("--base_dir", type=str, default=None)
    parser.add_argument("--full_res_head", action="store_true")
    parser.add_argument("--noise_schedule", type=str, default=None)
    parser.add_argument("--spatial", type=str, default=None,
                        help="D,S: run the editing forwards spatially partitioned over a "
                        "(data, spatial) mesh of the launched ranks (image rows split "
                        "S-way; torchrun --nproc_per_node=D·S)")
    parser.add_argument("--sample_mode", type=str, default="engine",
                        choices=["engine", "ancestral"])
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on (default: the config's, cuda)")
    return parser.parse_args(argv)


def make_config(args):
    """The Config of the demo on the resolved device (raises when that is
    CUDA and no GPU exists), its directories created."""
    from ..config import Config, resolve_device

    config = Config(base_dir=args.base_dir) if args.base_dir else Config()
    if args.device is not None:
        config.device = args.device
    if args.spatial:
        config.spatial_shape = parse_axes(args.spatial, "--spatial")
    start_distributed(config)
    if args.spatial:
        require_ranks(config.spatial_shape, "--spatial")
    if args.full_res_head:
        config.full_res_head = True
    if args.noise_schedule:
        config.noise_schedule = args.noise_schedule
    config.timesteps = args.timesteps
    if args.dataset:
        config.dataset = args.dataset
    if args.image_size:
        config.image_size = args.image_size
    resolve_device(config.device)
    return config.create_directories()


def run(args, config=None, draws=None, timings: Optional[Dict[str, float]] = None) -> Dict:
    """The three editing flows on the teacher: ``{"inpainting", "directions",
    "latent_manipulation", "prompt_editing"}``.  ``draws`` (an
    :class:`..editing.EditingDraws`-like source) replaces the default draws;
    ``timings`` receives each stage's wall seconds."""
    import torch

    from ..data import get_real_images
    from ..editing import (
        apply_latent_manipulation,
        apply_masked_inpainting,
        apply_prompt_editing,
        create_random_mask,
        find_semantic_directions,
    )

    config = make_config(args) if config is None else config
    timings = {} if timings is None else timings
    device = torch.device(config.device)

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = time.perf_counter() - t0
        return out

    teacher = stage("teacher_load_s", lambda: load_teacher_from_arg(config, args.teacher_model))

    print("\n[1/3] Masked inpainting...")

    def inpaint():
        real01 = (get_real_images(config, 1)[0] + 1.0) / 2.0  # the API takes [0,1] images
        mask = create_random_mask(config.image_size, config.image_size,
                                  rng=np.random.default_rng(args.seed))
        return apply_masked_inpainting(teacher, config, real01, mask=mask, seed=args.seed,
                                       mode=args.sample_mode, draws=draws)

    out = {"inpainting": stage("inpainting_s", inpaint)}

    print("\n[2/3] Latent manipulation (PCA semantic directions)...")

    def manipulate():
        directions = find_semantic_directions(teacher, config, num_samples=DIRECTION_SAMPLES,
                                              mode=args.sample_mode, draws=draws)
        result = apply_latent_manipulation(
            teacher, config, direction=directions["pca_0"], strength=args.strength,
            seed=args.seed, mode=args.sample_mode, draws=draws)
        return directions, result

    out["directions"], out["latent_manipulation"] = stage("latent_manipulation_s", manipulate)

    print("\n[3/3] Prompt editing (simulated)...")
    out["prompt_editing"] = stage("prompt_editing_s", lambda: apply_prompt_editing(
        teacher, config, "a digit", "another digit", seed=args.seed, mode=args.sample_mode,
        draws=draws))
    return out


def output_dir(config) -> str:
    return os.path.join(config.analysis_dir, "editing")


def plot(results: Dict, config) -> None:
    """The JAX CLI's PNGs of :func:`run`'s results."""
    from ..editing import visualize_inpainting, visualize_latent_manipulation, visualize_prompt_editing

    visualize_inpainting(results["inpainting"], output_dir(config))
    visualize_latent_manipulation(results["latent_manipulation"], output_dir(config))
    visualize_prompt_editing(results["prompt_editing"], output_dir(config))


def main(argv=None, draws=None):
    args = parse_args(argv)
    config = make_config(args)
    results = run(args, config, draws)
    if is_main_process():
        plot(results, config)
        print(f"\nEditing demos saved under {output_dir(config)}")
    return results


if __name__ == "__main__":
    main()
