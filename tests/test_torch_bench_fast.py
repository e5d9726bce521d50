"""The port's composed fast-lane bench (``distillation_trajectories_torch/scripts/bench_fast.py``)
through ``main`` on the CPU (sf 0.05, 16x16x1, batch 2, teacher T=4, student
T=2, float32, JAX's draws): the four arms, ``--w_sweep 1.0,3.0`` and
``--fid_samples 4`` to a record with the JAX record's keys; the bf16
student's ``endpoint_mse_vs_teacher`` and, with the bf16 arm alone (so that
it is the arm swept), the w-sweep's MSEs and spreads are JAX's, computed
here from the same checkpoints and draws, at 1e-4.  The int8 arms are held
as JAX's own test holds them (``tests/test_progressive.py:208-250``:
finite, every arm timed, here in both lanes: ``eager_seconds``)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion.sampling import generate_trajectory_scan as jax_scan
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import make_eval_model_fn as jax_eval_fn
from distillation_trajectories_tpu.training.progressive import make_guided_eval_fn as jax_guided
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.scripts import bench_fast
from distillation_trajectories_torch.training import save_checkpoint
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    JaxBenchDraws,
    jax_variables,
    tmp_path,
)

torch.set_num_threads(2)

# The JAX record's keys (scripts/bench_fast.py:246-257, 263, 312-319; the
# contract of tests/test_progressive.py:238-246).
JAX_KEYS = ("metric", "teacher_traj_per_s", "best_arm", "best_traj_per_s", "best_speedup",
            "arms", "preflight", "ts_iso", "w_sweep_best_arm", "fid_features",
            "fid_teacher_vs_best", "fid_teacher_self_floor")
ARMS = ("teacher_cfg_bf16", "student_bf16", "student_int8", "student_int8_static",
        "student_int8_static_mixed")


@pytest.fixture()
def setup(tmp_path, monkeypatch):
    """A seeded teacher and guided student (``progressive_cfg/steps_2``);
    JAX's draws; their JAX model functions."""
    monkeypatch.setattr(bench_fast, "BenchDraws", JaxBenchDraws)
    cfg = Config(base_dir=str(tmp_path), dataset="MNIST", image_size=16, channels=1,
                 device="cpu").create_directories()
    teacher = make_unet(cfg, size_factor=0.05, seed=2)
    student = make_unet(cfg, size_factor=0.05, seed=3)
    save_checkpoint(cfg.teacher_models_dir, 1, teacher)
    save_checkpoint(os.path.join(cfg.models_dir, "progressive_cfg", "steps_2"), 1, student)
    jcfg = JaxConfig(dataset="MNIST", image_size=16, channels=1, compute_dtype="float32")
    jmodel = jax_make_unet(jcfg, size_factor=0.05)
    flags = ["--device", "cpu", "--base_dir", str(tmp_path), "--dataset", "MNIST",
             "--image_size", "16", "--channels", "1", "--size_factor", "0.05", "--batch", "2",
             "--iters", "1", "--teacher_steps", "4", "--student_steps", "2", "--compute_dtype", "float32",
             "--w_sweep", "1.0,3.0"]
    return flags, cfg, jcfg, jmodel, jax_variables(teacher), jax_variables(student)


def _end(jcfg, fn, noise, steps, seed, guidance_scale=None):
    alphas = jax_params(steps, jcfg)["alphas"]
    return np.asarray(jax_scan(fn, noise, steps, alphas, seed,
                               guidance_scale=guidance_scale)[-1])


def test_record_and_bf16_endpoint_match_jax(setup):
    flags, cfg, jcfg, jmodel, tvars, svars = setup
    rec = bench_fast.main(flags + ["--fid_samples", "4"])
    assert json.load(open(os.path.join(cfg.results_dir, "bench_fast_torch.json"))) == rec
    for key in JAX_KEYS:
        assert key in rec, key
    assert set(rec["arms"]) == set(ARMS) and rec["best_arm"].startswith("student_")
    for name, arm in rec["arms"].items():
        assert arm["traj_per_s"] > 0 and len(arm["seconds"]) == 1, name
        assert len(arm["eager_seconds"]) == 1 and arm["eager_seconds"][0] > 0, name
        if name.startswith("student_"):
            assert np.isfinite(arm["endpoint_mse_vs_teacher"]), name
    assert rec["fid_features"] == "seeded-random" and np.isfinite(rec["fid_teacher_vs_best"])

    noise = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16, 1))
    t_end = _end(jcfg, jax_eval_fn(jmodel, tvars), noise, 4, 99, guidance_scale=3.0)
    s_end = _end(jcfg, jax_guided(jmodel, svars, 3.0), noise, 2, 99)
    np.testing.assert_allclose(rec["arms"]["student_bf16"]["endpoint_mse_vs_teacher"],
                               np.mean((s_end - t_end) ** 2), rtol=1e-4)


def test_w_sweep_of_the_bf16_arm_matches_jax(setup):
    flags, _, jcfg, jmodel, tvars, svars = setup
    rec = bench_fast.main(flags + ["--arms", "bf16", "--fid_samples", "0"])
    assert rec["best_arm"] == "student_bf16" and "fid_teacher_vs_best" not in rec
    q_noise = jax.random.normal(jax.random.PRNGKey(7), (2, 16, 16, 1))
    for wv in (1.0, 3.0):
        te = _end(jcfg, jax_eval_fn(jmodel, tvars), q_noise, 4, 11, guidance_scale=wv)
        se = _end(jcfg, jax_guided(jmodel, svars, wv), q_noise, 2, 11)
        got = rec["w_sweep_best_arm"][str(wv)]
        np.testing.assert_allclose(got["endpoint_mse"], np.mean((te - se) ** 2), rtol=1e-4)
        np.testing.assert_allclose(got["teacher_std"], te.std(), rtol=1e-4)
        np.testing.assert_allclose(got["student_std"], se.std(), rtol=1e-4)
