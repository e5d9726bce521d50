"""Port parity: the engine samplers vs the JAX scans, with the JAX step
noise injected (float32, sf 0.1 at 16x16x1, T=10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.diffusion.sampling import (
    engine_update as jax_engine_update,
    generate_trajectory_batch_scan as jax_batch_scan,
    generate_trajectory_scan as jax_scan,
    subsampled_timestep_indices as jax_subsampled_timestep_indices,
)
from distillation_trajectories_tpu.diffusion.schedules import (
    get_diffusion_params as jax_get_diffusion_params,
)
from distillation_trajectories_tpu.models import make_init_fn
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import (
    make_eval_model_fn as jax_make_eval_model_fn,
)
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.diffusion.sampling import (
    CFG_COND_PAIRS,
    NOCFG_COND_PAIRS,
    draw_step_noise,
    engine_update,
    generate_trajectory_batch_scan,
    generate_trajectory_scan,
    subsampled_timestep_indices,
)
from distillation_trajectories_torch.diffusion.schedules import get_diffusion_params
from distillation_trajectories_torch.models import load_unet_variables, make_unet
from distillation_trajectories_torch.training import make_eval_model_fn

torch.set_num_threads(2)

T = 10
SEED = 0
_STATE = {}


def _setup():
    """JAX model fn and the port's eval fn on the same sf-0.1 weights."""
    if not _STATE:
        kw = dict(image_size=16, channels=1, timesteps=T, sample_steps=T,
                  compute_dtype="float32")
        jcfg = JaxConfig(**kw)
        jmodel = jax_make_unet(jcfg, size_factor=0.1)
        variables = make_init_fn(jmodel, jcfg, force_jit=True)(jax.random.PRNGKey(0))
        model = make_unet(Config(device="cpu", **kw), size_factor=0.1, device="cpu")
        load_unet_variables(model, jax.tree_util.tree_map(np.asarray, variables))
        _STATE.update(
            jax_fn=jax_make_eval_model_fn(jmodel, variables),
            port_fn=make_eval_model_fn(model),
            alphas=jax_get_diffusion_params(T, jcfg)["alphas"],
            noise=np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16, 1))),
        )
    return _STATE


def _jax_step_noise(seeds, sample_shape):
    """The JAX samplers' per-step draws, [T-1, S, *sample_shape]."""
    return np.stack([
        np.stack([
            np.asarray(jax.random.normal(
                jax.random.fold_in(jax.random.PRNGKey(s), t), sample_shape
            ))
            for s in seeds
        ])
        for t in range(T - 1, 0, -1)
    ])


def test_alphas_match():
    np.testing.assert_array_equal(
        get_diffusion_params(T)["alphas"], np.asarray(_setup()["alphas"])
    )


def test_engine_update_and_timestep_indices_match_jax():
    alphas = get_diffusion_params(50)["alphas"]
    rng = np.random.default_rng(2)
    x, eps, n = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32) for _ in range(3))
    for t in (49, 25, 1):
        want = np.asarray(jax_engine_update(x, eps, n, alphas[t], alphas[t - 1]))
        got = engine_update(*(torch.from_numpy(a) for a in (x, eps, n)),
                            alphas[t], alphas[t - 1])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for steps, num in ((100, 10), (50, 50), (10, 3)):
        np.testing.assert_array_equal(subsampled_timestep_indices(steps, num),
                                      jax_subsampled_timestep_indices(steps, num))


@pytest.mark.parametrize("gs", [None, 3.0])
def test_generate_trajectory_scan_matches_both_jax_branches(gs):
    st = _setup()
    step_noise = _jax_step_noise([SEED], st["noise"].shape)[:, 0]
    got = generate_trajectory_scan(
        st["port_fn"], torch.from_numpy(st["noise"]), T, st["alphas"], SEED,
        guidance_scale=gs, step_noise=torch.from_numpy(step_noise),
    )
    assert tuple(got.shape) == (T + 1, 2, 16, 16, 1)
    for use_pallas in (False, True):
        want = np.asarray(jax_scan(
            st["jax_fn"], jnp.asarray(st["noise"]), T, st["alphas"], SEED,
            guidance_scale=gs, use_pallas=use_pallas,
        ))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)


def test_generate_trajectory_batch_scan_matches_jax_both_cond_pairs():
    st = _setup()
    seeds = np.array([42, 43], dtype=np.int32)
    step_noise = torch.from_numpy(_jax_step_noise(seeds, (16, 16, 1)))
    jax_run = jax.jit(lambda noises, pairs, gs: jax_batch_scan(
        st["jax_fn"], noises, T, st["alphas"], jnp.asarray(seeds), pairs, gs))
    for pairs, gs in ((CFG_COND_PAIRS, 3.0), (NOCFG_COND_PAIRS, 1.0)):
        want = np.asarray(jax_run(jnp.asarray(st["noise"]), jnp.asarray(pairs),
                                  jnp.float32(gs)))
        got = generate_trajectory_batch_scan(
            st["port_fn"], torch.from_numpy(st["noise"]), T, st["alphas"], seeds,
            pairs, gs, step_noise=step_noise,
        )
        assert tuple(got.shape) == (2, T + 1, 16, 16, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)


def test_store_dtype_bf16_casts_only_stored_states():
    st = _setup()
    noises = torch.from_numpy(st["noise"])
    f32 = generate_trajectory_batch_scan(
        st["port_fn"], noises, T, st["alphas"], [5, 6], CFG_COND_PAIRS, 3.0)
    bf16 = generate_trajectory_batch_scan(
        st["port_fn"], noises, T, st["alphas"], [5, 6], CFG_COND_PAIRS, 3.0,
        store_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and bf16.shape == f32.shape
    # The carry stays float32, so every stored state is the float32 one rounded.
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    assert torch.equal(f32[:, -1], f32[:, -2])  # duplicated no-op t=0 state


def test_default_step_noise_depends_only_on_seed_and_t():
    pair = draw_step_noise([7, 9], T, (4, 4, 1), "cpu")
    alone = draw_step_noise([9], T, (4, 4, 1), "cpu")
    assert pair.shape == (T - 1, 2, 4, 4, 1)
    assert torch.equal(pair[:, 1], alone[:, 0])
    assert not torch.equal(pair[:, 0], pair[:, 1])
    assert not torch.equal(pair[0], pair[1])


@pytest.mark.parametrize("gs", [None, 3.0], ids=["nocfg", "cfg"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["unfused", "fused"])
def test_scan_matches_jax_under_either_use_pallas(use_pallas, gs):
    """The port's one tail (the fused entry) against both of JAX's: the jnp
    combine then ``engine_update``, and the Pallas kernel in interpret mode."""
    st = _setup()
    step_noise = _jax_step_noise([SEED], st["noise"].shape)[:, 0]
    got = generate_trajectory_scan(
        st["port_fn"], torch.from_numpy(st["noise"]), T, st["alphas"], SEED,
        guidance_scale=gs, step_noise=torch.from_numpy(step_noise),
    )
    want = np.asarray(jax_scan(
        st["jax_fn"], jnp.asarray(st["noise"]), T, st["alphas"], SEED,
        guidance_scale=gs, use_pallas=use_pallas,
    ))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("pairs, gs", [(CFG_COND_PAIRS, 3.0), (NOCFG_COND_PAIRS, 1.0)],
                         ids=["cfg", "nocfg"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["unfused", "fused"])
def test_batch_scan_matches_jax_under_either_use_pallas(use_pallas, pairs, gs):
    st = _setup()
    seeds = np.array([42, 43], dtype=np.int32)
    want = np.asarray(jax_batch_scan(
        st["jax_fn"], jnp.asarray(st["noise"]), T, st["alphas"], jnp.asarray(seeds),
        jnp.asarray(pairs), jnp.float32(gs), use_pallas=use_pallas,
    ))
    got = generate_trajectory_batch_scan(
        st["port_fn"], torch.from_numpy(st["noise"]), T, st["alphas"], seeds, pairs, gs,
        step_noise=torch.from_numpy(_jax_step_noise(seeds, (16, 16, 1))),
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
