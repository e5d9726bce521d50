"""The port's sampler experiments (``distillation_trajectories_torch/scripts/bench_r2.py``)
on the CPU, in float32: the kernel arm and the plain arm are the same chain
here (a CPU tensor takes the plain version in both), the sequential chain
of the ``paradigms`` experiment is JAX's chain (rtol 2e-5 / atol 1e-5) and
the window sampler at tol 0 is that chain (1e-5), and the ablation's FLOPs
are ``conv_flops`` of two forwards a step."""

import json

import jax
import numpy as np
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion.sampling import generate_trajectory_scan as jax_scan
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import make_eval_model_fn as jax_eval_fn
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.diffusion import generate_trajectory_scan, get_diffusion_params
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.scripts import bench_r2
from distillation_trajectories_torch.training import make_eval_model_fn
from distillation_trajectories_torch.utils.profiling import conv_flops
from torch_parity import JaxBenchDraws, jax_variables

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--batch", "2", "--size_factor", "0.1", "--image_size", "16",
        "--iters", "1", "--compute_dtype", "float32"]


def test_pallas_arms_are_one_chain_on_the_cpu(tmp_path):
    args = bench_r2.parse_args(TINY + ["--exp", "pallas", "--timesteps", "4"])
    out = bench_r2.run(args)
    res = out["pallas"]
    assert out["preflight"]["status"] == "skipped"
    assert res["max_abs_deviation"] == 0.0 and res["exp"] == "pallas_cfg_update"
    assert res["jnp_seconds"] > 0 and res["pallas_seconds"] > 0
    assert res["traj_per_s_jnp"] > 0 and res["traj_per_s_pallas"] > 0
    assert len(res["jnp_call_seconds"]) == len(res["pallas_call_seconds"]) == 1


def test_paradigms_window_at_tol_0_is_the_jax_chain():
    """T=6 (5 steps) with a window of 4, so the window slides: at tol 0 it
    reproduces the sequential chain, which is JAX's for the same draws."""
    args = bench_r2.parse_args(TINY + ["--exp", "paradigms", "--timesteps", "6", "--windows", "4",
                                       "--tols", "0"])
    draws = JaxBenchDraws()
    res = bench_r2.exp_paradigms(args, draws)
    (row,) = res["rows"]
    assert row["window"] == 4 and row["tol"] == 0.0 and row["sweeps_at_seed3"] == 5
    assert row["max_abs_dev_vs_exact"] <= 1e-5

    cfg = Config(image_size=16, compute_dtype="float32", device="cpu")
    model = make_unet(cfg, size_factor=0.1, seed=0)
    noise = draws.noise(1, (1, 16, 16, 3))
    got = generate_trajectory_scan(make_eval_model_fn(model), noise, 6,
                                   get_diffusion_params(6, cfg)["alphas"], 3, guidance_scale=7.5,
                                   step_noise=draws.step_noise(3, 6, (1, 16, 16, 3)))
    jcfg = JaxConfig(image_size=16, compute_dtype="float32")
    fn = jax_eval_fn(jax_make_unet(jcfg, size_factor=0.1), jax_variables(model))
    want = jax_scan(fn, jax.random.normal(jax.random.PRNGKey(1), (1, 16, 16, 3)), 6,
                    jax_params(6, jcfg)["alphas"], 3, guidance_scale=7.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)


def test_ablate_counts_the_convolutions_of_two_forwards(tmp_path):
    out = bench_r2.main(["--exp", "ablate", "--timesteps", "4", "--out",
                         str(tmp_path / "r2.json")] + TINY)
    res = out["ablate"]
    model = make_unet(Config(image_size=16, compute_dtype="float32", device="cpu"),
                      size_factor=0.1, seed=0).eval()
    x, t, c = torch.zeros(2, 16, 16, 3), torch.full((2,), 25.0), torch.ones(2, 1)
    assert res["per_step_flops"] == 2 * conv_flops(model, x, t, c, c)
    for key in ("full_scan_seconds", "two_fwd_scan_seconds", "nearest_upsample_scan_seconds",
                "update_tail_scan_seconds"):
        assert res[key] > 0, key
    assert set(res["call_seconds"]) == {"full", "two_fwd", "nearest", "tail"}
    assert json.load(open(tmp_path / "r2.json"))["ablate"]["per_step_flops"] == \
        res["per_step_flops"]


def test_nearest_layout_repeats():
    h = torch.arange(8.0).reshape(1, 2, 2, 2)
    up = bench_r2._nearest_layout().up(h)
    assert up.shape == (1, 2, 4, 4)
    assert torch.equal(up[0, 0], torch.tensor([[0.0, 0, 1, 1], [0, 0, 1, 1],
                                               [2, 2, 3, 3], [2, 2, 3, 3]]))
