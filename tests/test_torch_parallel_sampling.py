"""Port parity: the Picard / sliding-window ParaDiGMS samplers
(``diffusion/parallel_sampling.py``), the seven cases of
``tests/test_parallel_sampling.py`` on the port, then against JAX's
functions with JAX's ``fold_in(PRNGKey(seed), t)`` step noise injected.

On the CPU the port's window at ``tol=0`` and its full Picard sweeps equal
its sequential chain bit for bit (the same float32 update, in the order of
the kernel's plain version, and the CPU convolutions give each row the
same sums at W·B rows as at B); the checks use JAX's tolerance, rtol 1e-4 /
atol 1e-5, as its own tests do, and hold to JAX's chains at rtol 2e-5 /
atol 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion.parallel_sampling import (
    parallel_generate_trajectory as jax_parallel,
)
from distillation_trajectories_tpu.diffusion.parallel_sampling import (
    sliding_window_trajectory as jax_window,
)
from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_torch.diffusion import get_diffusion_params
from distillation_trajectories_torch.diffusion.parallel_sampling import (
    parallel_generate_trajectory,
    sliding_window_trajectory,
)
from distillation_trajectories_torch.diffusion.sampling import generate_trajectory_scan
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.training import make_eval_model_fn
from distillation_trajectories_torch.trajectories import generate_trajectory
from torch_parity import as_torch, configs, jax_step_noise, numpy_tree, port_model

torch.set_num_threads(2)
T = 10


def _setup():
    _, tcfg = configs(timesteps=T)
    model = make_unet(tcfg, size_factor=0.1, device="cpu", seed=0)
    return tcfg, model, make_eval_model_fn(model), get_diffusion_params(T)["alphas"]


def _noise(seed, b):
    return torch.randn((b, 16, 16, 1), generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_parallel_exact_match_full_sweeps():
    _, _, fn, alphas = _setup()
    noise = _noise(1, 2)
    seq = generate_trajectory_scan(fn, noise, T, alphas, seed=5)
    par, sweeps = parallel_generate_trajectory(fn, noise, T, alphas, seed=5, tol=0.0)
    assert par.shape == seq.shape == (T + 1, 2, 16, 16, 1)
    _close(par, seq)
    assert sweeps == T - 1


def test_parallel_cfg_matches_sequential():
    _, _, fn, _ = _setup()
    alphas = get_diffusion_params(6)["alphas"]
    noise = _noise(2, 1)
    seq = generate_trajectory_scan(fn, noise, 6, alphas, seed=3, guidance_scale=5.0)
    par, _ = parallel_generate_trajectory(fn, noise, 6, alphas, seed=3, guidance_scale=5.0,
                                          tol=0.0)
    _close(par, seq)


def test_parallel_early_exit_uses_fewer_sweeps():
    _, _, fn, alphas = _setup()
    noise = _noise(3, 1)
    exact, sweeps_exact = parallel_generate_trajectory(fn, noise, T, alphas, seed=7, tol=0.0)
    loose, sweeps_loose = parallel_generate_trajectory(fn, noise, T, alphas, seed=7, tol=1e-2)
    assert sweeps_loose <= sweeps_exact
    torch.testing.assert_close(loose, exact, rtol=0, atol=0.1)
    _, one = parallel_generate_trajectory(fn, noise, T, alphas, seed=7, tol=1e9)
    assert one == 2  # the initial sweep and one more, whose change meets any tolerance


def test_sliding_window_tol0_matches_sequential():
    _, _, fn, alphas = _setup()
    noise = _noise(4, 2)
    seq = generate_trajectory_scan(fn, noise, T, alphas, seed=9)
    win, sweeps = sliding_window_trajectory(fn, noise, T, alphas, seed=9, window=4, tol=0.0)
    assert win.shape == seq.shape and sweeps == T - 1
    _close(win, seq)
    assert torch.equal(win[0], noise) and torch.equal(win[-1], win[-2])


def test_sliding_window_cfg_and_slide_mechanics():
    _, _, fn, alphas = _setup()
    noise = _noise(5, 1)
    seq = generate_trajectory_scan(fn, noise, T, alphas, seed=11, guidance_scale=4.0)
    win, _ = sliding_window_trajectory(fn, noise, T, alphas, seed=11, guidance_scale=4.0,
                                       window=4, tol=0.0)
    _close(win, seq)
    # An infinite tolerance slides the whole window every sweep: ceil(9 / 4).
    _, sweeps = sliding_window_trajectory(fn, noise, T, alphas, seed=11, window=4, tol=1e9)
    assert sweeps == -(-(T - 1) // 4)


def test_config_parallel_sampling_window_switch(capsys):
    tcfg, model, _, _ = _setup()
    noise = _noise(7, 1)
    seq = generate_trajectory(model, noise, T, seed=2, config=tcfg)
    wcfg = dataclasses.replace(tcfg, parallel_sampling="window", paradigms_tol=0.0,
                               paradigms_window=3)
    win = generate_trajectory(model, noise, T, seed=2, config=wcfg)
    assert "pallas_cfg_update is ignored" not in capsys.readouterr().out
    _close(win, seq)
    # The note follows the flag, as in JAX: said only when it is set.
    fused = generate_trajectory(model, noise, T, seed=2,
                                config=dataclasses.replace(wcfg, pallas_cfg_update=True))
    assert "pallas_cfg_update is ignored for this trajectory" in capsys.readouterr().out
    assert torch.equal(fused, win)
    stored = generate_trajectory(model, noise, T, seed=2,
                                 config=dataclasses.replace(wcfg, trajectory_store_dtype="bfloat16"))
    assert stored.dtype == torch.bfloat16 and torch.equal(stored, win.to(torch.bfloat16))


def test_sliding_window_finite_tol_close_to_exact():
    _, _, fn, alphas = _setup()
    noise = _noise(6, 1)
    exact = generate_trajectory_scan(fn, noise, T, alphas, seed=13)
    win, sweeps = sliding_window_trajectory(fn, noise, T, alphas, seed=13, window=4, tol=1e-2)
    assert sweeps <= T - 1
    torch.testing.assert_close(win, exact, rtol=0, atol=0.15)


@pytest.mark.parametrize("guidance_scale", [None, 4.0])
def test_window_and_picard_match_jax_with_its_step_noise(guidance_scale):
    jcfg, tcfg = configs(timesteps=T)
    jmodel = jax_make_unet(jcfg, size_factor=0.1)
    variables = numpy_tree(jax_init_unet(jmodel, jcfg, jax.random.PRNGKey(0)))
    jfn = lambda x, t, c, m: jmodel.apply(variables, x, t, cond=c, cond_mask=m)
    fn = make_eval_model_fn(port_model(tcfg, 0.1, variables))
    noise = np.random.default_rng(8).standard_normal((2, 16, 16, 1)).astype(np.float32)
    step_noise = as_torch(jax_step_noise([9], T, noise.shape)[:, 0])
    alphas = jax_params(T)["alphas"]
    kw = dict(guidance_scale=guidance_scale)
    for jax_fn, port_fn, extra in ((jax_window, sliding_window_trajectory, dict(window=4, tol=0.0)),
                                   (jax_parallel, parallel_generate_trajectory, dict(tol=0.0))):
        want, want_sweeps = jax_fn(jfn, noise, T, alphas, 9, **kw, **extra)
        got, sweeps = port_fn(fn, as_torch(noise), T, get_diffusion_params(T)["alphas"], 9,
                              **kw, **extra, step_noise=step_noise)
        assert sweeps == int(want_sweeps) == T - 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)
