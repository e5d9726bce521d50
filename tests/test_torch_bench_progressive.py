"""The port's progressive bench (``distillation_trajectories_torch/scripts/bench_progressive.py``)
on the CPU (sf 0.05, 16x16x1, batch 2, T=4 -> 2, float32): one port round
of 2 batches trains the plain and the guided student through ``main``;
``--measure_only`` then reads each back through ``main`` on JAX's draws, to
a record with the JAX record's keys whose quality columns (endpoint MSE,
means and spreads, the guided w-sweep) are JAX's, computed here from the
same checkpoints and draws, at 1e-4, and whose timed calls carry the
eager body's seconds beside them."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion.sampling import generate_trajectory_scan as jax_scan
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import load_checkpoint as jax_load
from distillation_trajectories_tpu.training import make_eval_model_fn as jax_eval_fn
from distillation_trajectories_tpu.training import variables_from_checkpoint as jax_vars
from distillation_trajectories_tpu.training.progressive import make_guided_eval_fn as jax_guided
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.scripts import bench_progressive
from distillation_trajectories_torch.training import save_checkpoint
from torch_parity import JaxBenchDraws

torch.set_num_threads(2)

# The JAX record's keys (scripts/bench_progressive.py:184-195, 253-258, 294).
JAX_KEYS = ("preflight", "teacher_steps", "final_steps", "rounds", "epochs_per_round",
            "train_seconds", "guidance_range", "guidance", "throughput", "quality")
QUALITY_KEYS = ("endpoint_mse", "teacher_mean", "teacher_std", "student_mean", "student_std")


def _flags(root):
    return ["--device", "cpu", "--base_dir", str(root), "--dataset", "MNIST", "--image_size", "16",
            "--channels", "1", "--size_factor", "0.05", "--batch", "2", "--timesteps", "4",
            "--iters", "1", "--quality_samples", "2", "--compute_dtype", "float32", "--rounds", "1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A seeded teacher checkpoint, then one plain and one guided round of
    2 batches through the bench's training mode."""
    root = tmp_path_factory.mktemp("prog")
    cfg = Config(base_dir=str(root), dataset="MNIST", image_size=16, channels=1,
                 device="cpu").create_directories()
    save_checkpoint(cfg.teacher_models_dir, 1, make_unet(cfg, size_factor=0.05, seed=2))
    for extra in ([], ["--guidance_range", "1,5"]):
        rec = bench_progressive.main(_flags(root) + ["--epochs", "1", "--limit_batches", "2"]
                                     + extra)
        assert rec["final_steps"] == 2 and rec["train_seconds"] > 0
    yield root, cfg
    shutil.rmtree(root, ignore_errors=True)


def _jax_chain(root, family, steps, noise, seed, w=None, guided=False):
    jcfg = JaxConfig(base_dir=str(root), dataset="MNIST", image_size=16, channels=1,
                     compute_dtype="float32")
    path = jcfg.teacher_models_dir if family is None else \
        os.path.join(jcfg.models_dir, family, f"steps_{steps}")
    model = jax_make_unet(jcfg, size_factor=0.05)
    variables = jax_vars(jax_load(path))
    fn = jax_guided(model, variables, w) if guided else jax_eval_fn(model, variables)
    return np.asarray(jax_scan(fn, noise, steps, jax_params(steps, jcfg)["alphas"], seed,
                               guidance_scale=None if guided else w)[-1])


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_measure_only_record_matches_jax(trained, guided, monkeypatch, capsys):
    root, cfg = trained
    monkeypatch.setattr(bench_progressive, "BenchDraws", JaxBenchDraws)
    extra = ["--guidance_range", "1,5", "--w_sweep", "1.0,3.0"] if guided else []
    rec = bench_progressive.main(_flags(root) + ["--measure_only"] + extra)
    sfx = "_cfg" if guided else ""
    path = os.path.join(cfg.results_dir, f"bench_progressive_torch{sfx}.json")
    assert json.load(open(path)) == rec
    for key in JAX_KEYS:
        assert key in rec, key
    assert set(rec["throughput"]) == {"4", "2"} and rec["train_seconds"] == 0.0
    for entry in rec["throughput"].values():
        assert entry["traj_per_s"] > 0 and len(entry["call_seconds"]) == 1
        assert len(entry["eager_seconds"]) == 1 and entry["eager_seconds"][0] > 0
    for name in (f"teacher_T4{sfx}.png", f"student_T2{sfx}.png"):
        assert os.path.getsize(os.path.join(cfg.results_dir, "progressive_torch", name)) > 0

    family = "progressive_cfg" if guided else "progressive"
    noise = jax.random.normal(jax.random.PRNGKey(7), (2, 16, 16, 1))
    w = 3.0 if guided else None
    t_end = _jax_chain(root, None, 4, noise, 11, w=w)
    s_end = _jax_chain(root, family, 2, noise, 11, w=w, guided=guided)
    want = {"endpoint_mse": float(np.mean((t_end - s_end) ** 2)),
            "teacher_mean": float(t_end.mean()), "teacher_std": float(t_end.std()),
            "student_mean": float(s_end.mean()), "student_std": float(s_end.std())}
    for key in QUALITY_KEYS:
        np.testing.assert_allclose(rec["quality"][key], want[key], rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    if guided:
        assert set(rec["quality"]["w_sweep"]) == {"1.0", "3.0"}
        for wv in (1.0, 3.0):
            # JAX's bench jits its sweep with w traced, so its teacher runs
            # the CFG chain at every w, 1.0 included (a jnp scale is no
            # Python float to its sampler).
            te = _jax_chain(root, None, 4, noise, 11, w=jnp.float32(wv))
            se = _jax_chain(root, family, 2, noise, 11, w=wv, guided=True)
            got = rec["quality"]["w_sweep"][str(wv)]
            np.testing.assert_allclose(got["endpoint_mse"], np.mean((te - se) ** 2), rtol=1e-4)
            np.testing.assert_allclose(got["teacher_std"], te.std(), rtol=1e-4)
            np.testing.assert_allclose(got["student_std"], se.std(), rtol=1e-4)
    else:
        assert "w_sweep" not in rec["quality"]


def test_fid_columns_are_stamped(trained):
    root, _ = trained
    rec = bench_progressive.main(_flags(root) + ["--measure_only", "--fid_samples", "4"])
    q = rec["quality"]
    assert q["fid_features"] == "seeded-random"
    assert np.isfinite(q["fid_teacher_vs_student"]) and np.isfinite(q["fid_teacher_self_floor"])
