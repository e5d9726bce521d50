"""Port parity for the whole slice: the sweep engine vs the JAX sweep with
all three random draws injected from JAX, and JAX-written checkpoints
loading into the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.models import make_init_fn
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training.checkpoints import save_checkpoint
from distillation_trajectories_tpu.training.state import make_optimizer
from distillation_trajectories_tpu.trajectories import (
    sweep_compare_trajectories as jax_sweep_compare_trajectories,
)
from distillation_trajectories_tpu.trajectories.engine import (
    _sweep_inputs as jax_sweep_inputs,
)
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import load_unet_variables, make_unet
from distillation_trajectories_torch.training.checkpoints import (
    available_epochs,
    latest_epoch,
    load_checkpoint,
    variables_from_checkpoint,
)
from distillation_trajectories_torch.trajectories import (
    SweepDraws,
    compare_trajectories,
    generate_trajectory,
    sweep_compare_trajectories,
)

torch.set_num_threads(2)

KW = dict(dataset="MNIST", image_size=16, channels=1, batch_size=8,
          sample_steps=10, timesteps=10, epochs=1, compute_dtype="float32")


def _jax_models(cfg):
    """tests/test_trajectories.py::_models: teacher sf 0.2, student sf 0.1."""
    teacher = jax_make_unet(cfg, size_factor=0.2)
    student = jax_make_unet(cfg, size_factor=0.1)
    init = lambda m, k: make_init_fn(m, cfg, force_jit=True)(jax.random.PRNGKey(k))
    return teacher, init(teacher, 0), student, init(student, 1)


def _port_model(cfg, size_factor, variables):
    model = make_unet(cfg, size_factor=size_factor, device="cpu")
    return load_unet_variables(model, jax.tree_util.tree_map(np.asarray, variables))


def _jax_draws(cfg, num_samples, base_seed):
    """The JAX sweep's three draws: starting noises, per-step noise and
    the per-sample Wasserstein subsample uniforms."""
    noises, seeds, _ = jax_sweep_inputs(cfg, num_samples, base_seed)
    shape = (cfg.image_size, cfg.image_size, cfg.channels)
    step_noise = np.stack([
        np.stack([
            np.asarray(jax.random.normal(
                jax.random.fold_in(jax.random.PRNGKey(int(s)), t), shape))
            for s in np.asarray(seeds)
        ])
        for t in range(cfg.timesteps - 1, 0, -1)
    ])
    keys = jax.random.split(jax.random.PRNGKey(base_seed), num_samples)
    uniforms = np.stack([
        np.asarray(jax.random.uniform(k, (cfg.timesteps + 1, int(np.prod(shape)))))
        for k in keys
    ])
    return SweepDraws(*(torch.from_numpy(np.array(a)) for a in (noises, step_noise, uniforms)))


def test_sweep_matches_jax_sweep(tmp_path):
    jcfg = JaxConfig(base_dir=str(tmp_path), **KW)
    tcfg = Config(base_dir=str(tmp_path), device="cpu", **KW)
    teacher, t_vars, student, s_vars = _jax_models(jcfg)
    want = jax_sweep_compare_trajectories(
        teacher, t_vars, {0.1: (student, s_vars)}, jcfg,
        guidance_scales=(1.0, 3.0), num_samples=2, base_seed=42, verbose=False,
    )
    got = sweep_compare_trajectories(
        _port_model(tcfg, 0.2, t_vars), {0.1: _port_model(tcfg, 0.1, s_vars)}, tcfg,
        guidance_scales=(1.0, 3.0), num_samples=2, base_seed=42,
        draws=_jax_draws(jcfg, 2, 42), verbose=False,
    )
    assert set(got) == {0.1}
    assert set(got[0.1]) == {"teacher_metrics", "student_metrics"}
    for role in ("teacher_metrics", "student_metrics"):
        assert set(got[0.1][role]) == {1.0, 3.0}
        for gs in (1.0, 3.0):
            g, w = got[0.1][role][gs], want[0.1][role][gs]
            assert set(g) == set(w)
            for k in w:
                assert isinstance(g[k], float), k
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                           err_msg=f"{role} gs={gs} {k}")
    # Same values under both keys, in independent dicts.
    assert got[0.1]["teacher_metrics"][3.0] is not got[0.1]["student_metrics"][3.0]
    assert got[0.1]["teacher_metrics"][1.0]["endpoint_distance"] != (
        got[0.1]["teacher_metrics"][3.0]["endpoint_distance"])


def test_checkpoint_written_by_jax_loads_with_same_forward(tmp_path):
    jcfg = JaxConfig(base_dir=str(tmp_path), **KW)
    tcfg = Config(base_dir=str(tmp_path), device="cpu", **KW)
    jmodel = jax_make_unet(jcfg, size_factor=0.1)
    variables = make_init_fn(jmodel, jcfg, force_jit=True)(jax.random.PRNGKey(4))
    params = variables["params"]
    ema = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    directory = str(tmp_path / "ckpt")
    save_checkpoint(directory, 1, params, variables["batch_stats"])
    save_checkpoint(directory, 3, params, variables["batch_stats"],
                    opt_state=make_optimizer(jcfg).init(params), ema_params=ema,
                    extra={"note": "x"})
    assert available_epochs(directory) == [1, 3] and latest_epoch(directory) == 3

    payload = load_checkpoint(directory)
    assert payload["epoch"] == 3 and payload["extra"] == {"note": "x"}
    leaf = payload["ema_params"]["enc1"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        leaf, np.asarray(ema["enc1"]["conv1"]["kernel"], dtype=np.float32))

    model = make_unet(tcfg, size_factor=0.1, device="cpu")
    load_unet_variables(model, variables_from_checkpoint(payload)).eval()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = np.array([2.0, 7.0], np.float32)
    cond = np.array([[0.0], [1.0]], np.float32)
    apply = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))
    want = np.asarray(apply(variables, x, t, cond, np.ones_like(cond)))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, t, cond, np.ones_like(cond))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_generate_trajectory_and_compare_contract():
    tcfg = Config(device="cpu", **KW)
    teacher = make_unet(tcfg, size_factor=0.2, device="cpu", seed=0)
    student = make_unet(tcfg, size_factor=0.1, device="cpu", seed=1)
    noise = torch.randn((1, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    traj = generate_trajectory(teacher, noise, 10, seed=3, config=tcfg)
    assert traj.shape == (11, 1, 16, 16, 1)
    assert torch.equal(traj[-1], traj[-2])
    out = compare_trajectories(teacher, student, tcfg, guidance_scales=[1.0, 3.0],
                               size_factor=0.1, num_samples=2)
    assert set(out) == {"teacher_metrics", "student_metrics"}
    for gs in (1.0, 3.0):
        for k in ("endpoint_distance", "path_length_similarity",
                  "mean_directional_consistency", "mean_wasserstein"):
            assert np.isfinite(out["teacher_metrics"][gs][k]), k


@pytest.mark.parametrize(
    "override",
    [dict(mesh_shape=(2, 1)), dict(spatial_shape=(1, 2)),
     dict(mesh_shape=(1, 2)), dict(spatial_shape=(2, 1))],
)
def test_unported_options_raise(override):
    tcfg = dataclasses.replace(Config(device="cpu", **KW), **override)
    model = make_unet(tcfg, size_factor=0.1, device="cpu")
    with pytest.raises(NotImplementedError):
        sweep_compare_trajectories(model, {0.1: model}, tcfg, num_samples=1)
    with pytest.raises(NotImplementedError):
        generate_trajectory(model, torch.zeros((1, 16, 16, 1)), 10, config=tcfg)
