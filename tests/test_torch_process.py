"""Port parity: the forward process, the ε-MSE loss and the reference
samplers (``p_sample``, ``p_sample_ancestral``, ``p_sample_loop``) against
the JAX package, with the JAX draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion import process as jax_process
from distillation_trajectories_tpu.diffusion import sampling as jax_sampling
from distillation_trajectories_tpu.models import make_init_fn
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training.state import make_eval_model_fn as jax_eval_fn
from distillation_trajectories_torch.diffusion import get_diffusion_params
from distillation_trajectories_torch.diffusion import process, sampling
from distillation_trajectories_torch.training import make_eval_model_fn
from torch_parity import as_torch, configs, port_model, sample_draws

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=1e-5)
SHAPE = (3, 16, 16, 1)


@pytest.fixture(scope="module")
def models():
    """A JAX U-Net (sf 0.2) and the port U-Net holding the same weights."""
    jcfg, tcfg = configs()
    jmodel = jax_make_unet(jcfg, size_factor=0.2)
    variables = make_init_fn(jmodel, jcfg, force_jit=True)(jax.random.PRNGKey(3))
    jfn = jax.jit(jax_eval_fn(jmodel, variables))
    return jfn, make_eval_model_fn(port_model(tcfg, 0.2, variables))


def _x(seed):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def test_q_sample_and_p_losses(models):
    jfn, tfn = models
    dp = jax_params(10)
    x, t = _x(0), np.array([0, 4, 9], np.int32)
    key = jax.random.PRNGKey(7)
    want_x, want_noise = jax_process.q_sample(jnp.asarray(x), jnp.asarray(t), dp, key)
    got_x, got_noise = process.q_sample(as_torch(x), as_torch(t), get_diffusion_params(10),
                                        noise=as_torch(want_noise))
    np.testing.assert_allclose(got_x.numpy(), want_x, **TOL)
    cond = np.ones((3, 1), np.float32)
    want = jax_process.p_losses(jfn, jnp.asarray(x), jnp.asarray(t), dp, key, cond, cond)
    got = process.p_losses(tfn, as_torch(x), as_torch(t), get_diffusion_params(10),
                           noise=as_torch(want_noise), cond=as_torch(cond), cond_mask=as_torch(cond))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # Without a given draw the generator draws it, reproducibly.
    a = process.q_sample(as_torch(x), as_torch(t), get_diffusion_params(10),
                         generator=torch.Generator().manual_seed(1))
    b = process.q_sample(as_torch(x), as_torch(t), get_diffusion_params(10),
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[1], b[1]) and a[1].shape == SHAPE


@pytest.mark.parametrize("name", ["p_sample", "p_sample_ancestral"])
@pytest.mark.parametrize("t_index", [0, 6])
def test_reverse_step(models, name, t_index):
    jfn, tfn = models
    x = _x(1)
    key = jax.random.PRNGKey(11)
    t = np.full((3,), t_index, np.int32)
    want = getattr(jax_sampling, name)(jfn, jnp.asarray(x), jnp.asarray(t), jnp.int32(t_index),
                                       jax_params(10), key, 3.0)
    noise = as_torch(jax.random.normal(key, SHAPE))
    got = getattr(sampling, name)(tfn, as_torch(x), as_torch(t), t_index,
                                  get_diffusion_params(10), noise, 3.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode, sample_steps, num_timesteps", [
    ("reference", 10, None), ("ancestral", 10, None), ("reference", 10, 5)])
def test_p_sample_loop(models, mode, sample_steps, num_timesteps):
    jfn, tfn = models
    key = jax.random.PRNGKey(5)
    want_img, want_traj = jax_sampling.p_sample_loop(
        jfn, SHAPE, sample_steps, jax_params(10), key, num_timesteps=num_timesteps,
        track_trajectory=True, guidance_scale=2.0, mode=mode)
    n_steps = len(jax_sampling.subsampled_timestep_indices(sample_steps, num_timesteps or sample_steps))
    noise, step_noise = sample_draws(key, SHAPE, n_steps)
    got_img, got_traj = sampling.p_sample_loop(
        tfn, SHAPE, sample_steps, get_diffusion_params(10), noise=noise, step_noise=step_noise,
        num_timesteps=num_timesteps, track_trajectory=True, guidance_scale=2.0, mode=mode)
    assert got_traj.shape == (n_steps + 1, *SHAPE)
    np.testing.assert_allclose(got_traj.numpy(), want_traj, **TOL)
    np.testing.assert_allclose(got_img.numpy(), want_img, **TOL)


def test_p_sample_loop_draws_and_checks_shapes(models):
    _, tfn = models
    run = lambda: sampling.p_sample_loop(tfn, SHAPE, 10, get_diffusion_params(10),
                                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(run(), run())
    with pytest.raises(ValueError, match="step_noise"):
        sampling.p_sample_loop(tfn, SHAPE, 10, get_diffusion_params(10),
                               step_noise=torch.zeros((3, *SHAPE)))
