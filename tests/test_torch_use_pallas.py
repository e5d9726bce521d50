"""``Config.pallas_cfg_update`` in the port: JAX's flag picks its fused
Pallas kernel or the unfused combine then ``engine_update``; the port's one
tail, the fused ``ops.cfg_update.cfg_engine_update``, computes both.  A spy
on ``diffusion.sampling.cfg_engine_update`` shows every engine entry JAX
passes the flag from handing it both CFG predictions and the guidance,
T−1 calls a chain, under either value; and the engine's chain under either
value is JAX's under that value (float32, sf 0.1, 16x16x1, T=10, JAX's
step noise injected; rtol 2e-5 / atol 1e-5)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.trajectories import generate_trajectory as jax_generate_trajectory
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.diffusion import sampling
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.trajectories import (
    generate_trajectory,
    make_batch_trajectory_fn,
    make_paired_trajectory_fn,
    make_sweep_trajectory_fn,
    sweep_compare_trajectories,
)
from torch_parity import jax_variables

torch.set_num_threads(2)

T = 10
GS = 3.0
KW = dict(image_size=16, channels=1, timesteps=T, sample_steps=T, compute_dtype="float32")


class _Spy:
    """Records ``(uncond is cond, g)`` of every ``cfg_engine_update`` call
    and forwards it."""

    def __init__(self, monkeypatch):
        self.calls, self._fn = [], sampling.cfg_engine_update
        monkeypatch.setattr(sampling, "cfg_engine_update", self)

    def __call__(self, x, uncond, cond, noise, c1, c2, sigma, g):
        self.calls.append((uncond is cond, float(g)))
        return self._fn(x, uncond, cond, noise, c1, c2, sigma, g)

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def _model(cfg, sf=0.1, seed=0):
    return make_unet(cfg, size_factor=sf, seed=seed, device="cpu")


def _noise(n):
    return torch.randn((n, 16, 16, 1), generator=torch.Generator().manual_seed(n))


@pytest.mark.parametrize("flag", [False, True], ids=["unfused", "fused"])
def test_engine_entries_run_the_fused_tail_under_either_flag(monkeypatch, flag):
    """Each entry JAX passes ``config.pallas_cfg_update`` from
    (``trajectories/engine.py``: ``generate_trajectory``,
    ``make_paired_trajectory_fn``, ``make_batch_trajectory_fn``,
    ``make_sweep_trajectory_fn``, and the sweep through the latter) hands
    both predictions and the guidance to the fused entry, at a CFG scale."""
    spy = _Spy(monkeypatch)
    cfg = Config(device="cpu", pallas_cfg_update=flag, **KW)
    teacher, student = _model(cfg, 0.2, 0), _model(cfg, 0.1, 1)
    noises, seeds = _noise(2), np.array([5, 6])
    runs = {
        "generate_trajectory": (
            lambda: generate_trajectory(teacher, noises, T, seed=3, guidance_scale=GS,
                                        config=cfg), 1),
        "make_batch_trajectory_fn": (
            lambda: make_batch_trajectory_fn(teacher, T, cfg)(noises, seeds, GS), 1),
        "make_paired_trajectory_fn": (
            lambda: make_paired_trajectory_fn(teacher, student, T, cfg)(noises, seeds, GS), 2),
        "make_sweep_trajectory_fn": (
            lambda: make_sweep_trajectory_fn(teacher, T, cfg)(
                noises, seeds, sampling.CFG_COND_PAIRS, GS), 1),
        "sweep_compare_trajectories": (
            lambda: sweep_compare_trajectories(teacher, {0.1: student}, cfg,
                                               guidance_scales=(GS,), num_samples=2,
                                               verbose=False), 2),
    }
    for name, (run, chains) in runs.items():
        run()
        assert spy.take() == [(False, GS)] * (chains * (T - 1)), name


@pytest.mark.parametrize("flag", [False, True], ids=["unfused", "fused"])
def test_engine_chain_under_the_flag_matches_jax(flag):
    jcfg = JaxConfig(pallas_cfg_update=flag, **KW)
    cfg = Config(device="cpu", pallas_cfg_update=flag, **KW)
    model = _model(cfg)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(4), (2, 16, 16, 1)))
    seed = 7
    step_noise = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed), t),
                                     noise.shape))
        for t in range(T - 1, 0, -1)
    ])
    want = np.asarray(jax_generate_trajectory(
        jax_make_unet(jcfg, size_factor=0.1), jax_variables(model), noise, T, seed=seed,
        guidance_scale=GS, config=jcfg))
    got = generate_trajectory(model, torch.from_numpy(noise), T, seed=seed, guidance_scale=GS,
                              config=cfg, step_noise=torch.from_numpy(step_noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    # The flag selects nothing in the port.
    other = generate_trajectory(model, torch.from_numpy(noise), T, seed=seed, guidance_scale=GS,
                                config=dataclasses.replace(cfg, pallas_cfg_update=not flag),
                                step_noise=torch.from_numpy(step_noise))
    assert torch.equal(got, other)
