"""Manual smoke suite (the port's counterpart of the repository's
``testing/test_diffusion.py``): seven stages in sequence, each printed ✓ or
✗, with an early abort when a critical stage fails.

    python -m distillation_trajectories_torch.scripts.smoke_diffusion [--device cpu] [--base_dir DIR]

The stages are device setup, model init + forward, diffusion params,
forward diffusion (a noised white square, saved as a grid), data loader,
one training step, and sampling through ``p_sample_loop`` with a tracked
trajectory, on the shrunk config of the JAX suite (MNIST shapes, 16x16x1,
batch 16, T=20, float32).  It runs on ``--device`` (default ``cuda``;
device setup fails, critically, when the card is asked for and absent) and
writes under ``--base_dir`` (default: a fresh temporary directory).  Exits
1 unless all seven pass.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import traceback

import numpy as np


def _require(condition, message="check failed"):
    if not condition:
        raise AssertionError(message)


def make_test_config(device, base_dir):
    """The JAX suite's shrunk config (``testing/test_diffusion.py:25-36``)."""
    from ..config import Config

    cfg = Config(
        dataset="MNIST",
        image_size=16,
        channels=1,
        batch_size=16,
        sample_steps=20,
        timesteps=20,
        epochs=2,
        compute_dtype="float32",
        base_dir=base_dir,
        device=device,
    )
    return cfg.create_directories()


def stage_device_setup(cfg, state):
    import torch

    from ..config import resolve_device

    device = resolve_device(cfg.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"  device: {device} ({name})")
    _require(float(torch.ones(2, device=device).sum()) == 2.0)
    state["device"] = device


def stage_model_forward(cfg, state):
    import torch

    from ..models import make_unet

    model = make_unet(cfg, size_factor=0.25, seed=0)
    gen = torch.Generator(device=state["device"]).manual_seed(1)
    x = torch.randn((2, 16, 16, 1), generator=gen, device=state["device"])
    with torch.no_grad():
        out = model.eval()(x, torch.tensor([1.0, 5.0], device=state["device"]))
    _require(out.shape == x.shape, f"shape mismatch: {tuple(out.shape)} vs {tuple(x.shape)}")
    state["model"] = model


def stage_diffusion_params(cfg, state):
    from ..diffusion import get_diffusion_params

    dp = get_diffusion_params(cfg.timesteps, cfg)
    for k in (
        "betas", "alphas_cumprod", "sqrt_recip_alphas", "sqrt_alphas_cumprod",
        "sqrt_one_minus_alphas_cumprod", "posterior_variance",
    ):
        _require(k in dp, f"missing schedule key {k}")
        _require(dp[k].shape[0] == cfg.timesteps or dp[k].ndim == 0)
    state["dp"] = dp


def stage_forward_diffusion(cfg, state):
    import torch

    from ..diffusion import q_sample
    from ..utils.viz import save_image_grid

    x = -torch.ones((1, 16, 16, 1), device=state["device"])
    x[:, 4:12, 4:12, :] = 1.0
    frames = []
    for t in (0, 5, 10, 15, 19):
        gen = torch.Generator(device=state["device"]).manual_seed(t)
        noisy, _ = q_sample(x, torch.tensor([t], device=state["device"]), state["dp"],
                            generator=gen)
        frames.append(noisy[0].cpu().numpy())
    save_image_grid(np.stack(frames),
                    os.path.join(cfg.results_dir, "forward_diffusion_test.png"), nrow=5)


def stage_data_loader(cfg, state):
    from ..data import get_data_loader
    from ..utils.viz import save_image_grid

    images, _ = next(iter(get_data_loader(cfg)))
    _require(images.shape == (cfg.batch_size, 16, 16, 1))
    _require(images.min() >= -1.0 and images.max() <= 1.0)
    save_image_grid(images[:16], os.path.join(cfg.results_dir, "data_loader_test.png"))
    state["batch"] = images


def stage_training_step(cfg, state):
    import torch

    from ..training import TorchDraws, create_train_state, make_teacher_train_step

    train_state = create_train_state(state["model"], cfg, TorchDraws(2, state["device"]))
    step = make_teacher_train_step(state["dp"], cfg.timesteps)
    images = torch.from_numpy(np.asarray(state["batch"])).to(state["device"])
    _, loss = step(train_state, images)
    loss = float(loss)
    print(f"  one-step loss: {loss:.5f}")
    _require(np.isfinite(loss))


def stage_sampling(cfg, state):
    import torch

    from ..diffusion import p_sample_loop
    from ..training import make_eval_model_fn

    gen = torch.Generator(device=state["device"]).manual_seed(3)
    img, traj = p_sample_loop(
        make_eval_model_fn(state["model"]), (2, 16, 16, 1), cfg.sample_steps, state["dp"],
        generator=gen, num_timesteps=5, track_trajectory=True, device=state["device"],
    )
    _require(img.shape == (2, 16, 16, 1))
    _require(traj.shape[0] == 6)


# (name, stage, critical), in order (testing/test_diffusion.py:168-176).
STAGES = (
    ("device setup", stage_device_setup, True),
    ("model init + forward", stage_model_forward, True),
    ("diffusion params", stage_diffusion_params, True),
    ("forward diffusion", stage_forward_diffusion, False),
    ("data loader", stage_data_loader, True),
    ("training step", stage_training_step, False),
    ("sampling", stage_sampling, False),
)


def run_tests(device="cuda", base_dir=None) -> bool:
    """Run the stages in order, stopping at a critical failure; True when
    all seven pass."""
    if base_dir is None:
        base_dir = tempfile.mkdtemp(prefix="dtt_smoke_")
    print(f"smoke suite on {device}, writing under {base_dir}")
    cfg = make_test_config(device, base_dir)
    state = {}
    passed = 0
    for name, stage, critical in STAGES:
        print(f"\n[{name}]")
        try:
            stage(cfg, state)
            print(f"  ✓ {name}")
            passed += 1
        except Exception as e:  # a stage's failure is reported, then the next runs
            print(f"  ✗ {name}: {e}")
            traceback.print_exc()
            if critical:
                print("critical failure — aborting")
                break
    print(f"\n{passed}/{len(STAGES)} smoke tests passed")
    return passed == len(STAGES)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run the seven-stage smoke suite")
    parser.add_argument("--device", default="cuda",
                        help="Device to run on (cuda fails device setup without a GPU)")
    parser.add_argument("--base_dir", default=None,
                        help="Output root (default: a fresh temporary directory)")
    args = parser.parse_args(argv)
    return 0 if run_tests(args.device, args.base_dir) else 1


if __name__ == "__main__":
    sys.exit(main())
