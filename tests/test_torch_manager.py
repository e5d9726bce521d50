"""Port parity: the engine's paired and single-model trajectory functions
and the disk-backed ``TrajectoryManager`` against the JAX package, with
JAX's starting noise, per-step noise and Wasserstein keys injected.
Trajectories at rtol 2e-5 / atol 1e-5, averaged metrics at rtol 1e-4."""

import os

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.models import make_init_fn
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.trajectories import TrajectoryManager as JaxManager
from distillation_trajectories_tpu.trajectories import (
    make_batch_trajectory_fn as jax_make_batch_trajectory_fn,
)
from distillation_trajectories_tpu.trajectories import (
    make_paired_trajectory_fn as jax_make_paired_trajectory_fn,
)
from distillation_trajectories_torch.diffusion.sampling import seeded_normal
from distillation_trajectories_torch.trajectories import (
    TrajectoryManager,
    generate_trajectories_with_disk_storage,
    make_batch_trajectory_fn,
    make_paired_trajectory_fn,
)
from torch_parity import configs, port_model

torch.set_num_threads(2)

T = 6
SHAPE = (16, 16, 1)
TRAJ_TOL = dict(rtol=2e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Teacher sf 0.2 and student sf 0.1 in both packages, same weights."""
    jcfg, tcfg = configs(tmp_path_factory.mktemp("models"), timesteps=T, sample_steps=T)
    out = {}
    for name, sf, seed in (("teacher", 0.2, 0), ("student", 0.1, 1)):
        jmodel = jax_make_unet(jcfg, size_factor=sf)
        variables = make_init_fn(jmodel, jcfg, force_jit=True)(jax.random.PRNGKey(seed))
        out[name] = (jmodel, variables, port_model(tcfg, sf, variables))
    return out


def _jax_noises(seeds):
    return np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(s), SHAPE)) for s in seeds])


def _jax_step_noise(seeds):
    """``fold_in(PRNGKey(seed), t)`` draws of the JAX chains' ``[1, H, W, C]``
    states, as ``[T-1, S, H, W, C]`` (row ``j`` is step ``T-1-j``)."""
    return np.stack([
        np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(s), t), (1, *SHAPE)))[0] for s in seeds])
        for t in range(T - 1, 0, -1)
    ])


@pytest.mark.parametrize("gs", [1.0, 3.0])
def test_paired_and_batch_fns_match_jax(models, gs):
    jcfg, tcfg = configs(timesteps=T, sample_steps=T)
    (jt, tv, pt), (js, sv, ps) = models["teacher"], models["student"]
    seeds = np.array([3, 11])
    noises = _jax_noises(seeds)
    step_noise = torch.from_numpy(_jax_step_noise(seeds))

    want_t, want_s = jax_make_paired_trajectory_fn(jt, tv, js, sv, T, jcfg, use_cfg=True)(
        noises, seeds, np.float32(gs))
    got_t, got_s = make_paired_trajectory_fn(pt, ps, T, tcfg, use_cfg=True, device="cpu")(
        noises, seeds, gs, step_noise=step_noise)
    assert got_t.shape == (2, T + 1, *SHAPE) and got_s.shape == got_t.shape
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TRAJ_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TRAJ_TOL)

    # The single-model function, no-CFG lane (one cond-0 mask-0 forward).
    want = jax_make_batch_trajectory_fn(jt, tv, T, jcfg, use_cfg=False)(
        noises, seeds, np.float32(gs))
    got = make_batch_trajectory_fn(pt, T, tcfg, use_cfg=False, device="cpu")(
        noises, seeds, gs, step_noise=step_noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRAJ_TOL)


def test_default_step_noise_is_paired_per_seed(models):
    """Without injected noise, a sample's chain does not depend on the
    batch it rides in: its step noise is drawn from its own seed."""
    _, tcfg = configs(timesteps=T, sample_steps=T)
    pt, ps = models["teacher"][2], models["student"][2]
    fn = make_paired_trajectory_fn(pt, ps, T, tcfg, use_cfg=True, device="cpu")
    noises = torch.randn((3, *SHAPE), generator=torch.Generator().manual_seed(0))
    both_t, both_s = fn(noises, [5, 6, 7], 3.0)
    one_t, one_s = fn(noises[1:2], [6], 3.0)
    np.testing.assert_allclose(one_t[0].numpy(), both_t[1].numpy(), **TRAJ_TOL)
    np.testing.assert_allclose(one_s[0].numpy(), both_s[1].numpy(), **TRAJ_TOL)


def test_manager_files_and_metrics_match_jax(models, tmp_path):
    jcfg, _ = configs(tmp_path / "jax", timesteps=T, sample_steps=T)
    _, tcfg = configs(tmp_path / "port", timesteps=T, sample_steps=T)
    (jt, tv, pt), (js, sv, ps) = models["teacher"], models["student"]
    n = 3
    want_paths = JaxManager(jt, js, jcfg, size_factor=0.1, teacher_variables=tv,
                            student_variables=sv).generate_and_save_trajectories(n)
    manager = TrajectoryManager(pt, ps, tcfg, size_factor=0.1, device="cpu")
    got_paths = manager.generate_and_save_trajectories(
        n, chunk_size=2, noises=_jax_noises(range(n)),
        step_noise=torch.from_numpy(_jax_step_noise(range(n))))
    assert [os.path.basename(p) for p in got_paths] == [os.path.basename(p) for p in want_paths]
    for got_path, want_path in zip(got_paths, want_paths):
        with np.load(got_path) as g, np.load(want_path) as w:
            assert sorted(g.files) == sorted(w.files) == ["size_factor", "student", "teacher",
                                                          "timesteps"]
            for k in ("teacher", "student"):
                assert g[k].dtype == np.float32
                np.testing.assert_allclose(g[k], w[k], **TRAJ_TOL)
            np.testing.assert_array_equal(g["timesteps"], w["timesteps"])
            assert float(g["size_factor"]) == float(w["size_factor"]) == 0.1

    # The 16x16x1 states have fewer pixels than the Wasserstein subsample,
    # so no keys are drawn here (the next test covers them).
    got = manager.compute_trajectory_metrics_batch()
    want = JaxManager(jt, js, jcfg, size_factor=0.1).compute_trajectory_metrics_batch()
    _assert_metrics_close(got, want)
    assert manager.load_trajectories(indices=[1])[0][0].shape == (T + 1, *SHAPE)
    assert generate_trajectories_with_disk_storage(pt, ps, tcfg, size_factor=0.1, num_samples=n,
                                                   device="cpu").load_trajectories()


def _assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, list):
            assert len(got[k]) == len(w), k
            np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                       np.asarray(w, dtype=np.float64),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        else:
            assert isinstance(got[k], float), k
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)


def test_manager_metrics_match_jax_with_wasserstein_keys(tmp_path):
    """Stored 32x32x3 pairs (3,072 pixels, above the 1,000-pixel
    Wasserstein subsample), scored by both managers; the port is handed
    JAX's per-pair keys ``uniform(PRNGKey(i), (T+1, D))``."""
    jcfg, _ = configs(tmp_path / "jax")
    _, tcfg = configs(tmp_path / "port")
    rng = np.random.default_rng(0)
    n_steps, shape = 7, (32, 32, 3)
    for cfg in (jcfg, tcfg):
        os.makedirs(cfg.trajectory_dir, exist_ok=True)
    for i in range(3):
        t = np.cumsum(rng.normal(0, 0.3, (n_steps, *shape)), axis=0).astype(np.float32)
        s = (t + rng.normal(0, 0.05, t.shape)).astype(np.float32)
        for cfg in (jcfg, tcfg):
            np.savez_compressed(os.path.join(cfg.trajectory_dir,
                                             f"trajectory_size_0.5_sample_{i}.npz"),
                                teacher=t, student=s, timesteps=np.arange(n_steps),
                                size_factor=0.5)
    want = JaxManager(None, None, jcfg, size_factor=0.5).compute_trajectory_metrics_batch()
    d = int(np.prod(shape))
    uniforms = [np.array(jax.random.uniform(jax.random.PRNGKey(i), (n_steps, d)))
                for i in range(3)]
    got = TrajectoryManager(None, None, tcfg, size_factor=0.5, device="cpu"
                            ).compute_trajectory_metrics_batch(uniforms=uniforms)
    _assert_metrics_close(got, want)
    assert len(got["wasserstein_distances_per_timestep"][0]) == n_steps
    assert TrajectoryManager(None, None, tcfg, size_factor=0.9, device="cpu"
                             ).compute_trajectory_metrics_batch() == {}


def test_single_pairs_and_non_finite_skip(models, tmp_path):
    """A non-finite pair is skipped and the others written; one pair by
    seed (default draws) or from its starting sample equals the stored
    one."""
    _, tcfg = configs(tmp_path, timesteps=T, sample_steps=T)
    manager = TrajectoryManager(models["teacher"][2], models["student"][2], tcfg,
                                size_factor=0.1, device="cpu")
    noises = seeded_normal([(i, 0) for i in range(3)], SHAPE, "cpu")
    noises[1, 0, 0, 0] = float("nan")
    paths = manager.generate_and_save_trajectories(3, noises=noises)
    assert [os.path.basename(p) for p in paths] == [
        "trajectory_size_0.1_sample_0.npz", "trajectory_size_0.1_sample_2.npz"]
    stored_t, stored_s = manager.load_trajectories(indices=[2])[0]
    for got in (manager.generate_trajectory(seed=2),
                manager.generate_trajectory_from_sample(noises[2].numpy(), seed=2)):
        np.testing.assert_allclose(got[0], stored_t, **TRAJ_TOL)
        np.testing.assert_allclose(got[1], stored_s, **TRAJ_TOL)
