"""The port's int8 A/B/n bench (``distillation_trajectories_torch/scripts/bench_quant.py``)
through ``main`` on the CPU (sf 0.05, 16x16x1, batch 2, T=4, float32, JAX's
draws): the record has the JAX record's keys, the ``float`` and ``fold``
arms' endpoints are JAX's (the plain and the fold-only chain, computed here
from the same weights and draws) at rtol 1e-4 / atol 1e-6, each arm's
``endpoint_rel_l2`` is that of its endpoint, ``fold``'s is above 0 as
JAX's is, and the int8 arms stay as near float as JAX's own test
holds them (``endpoint_rel_l2 < 0.05``, ``tests/test_quantized.py:193-212``:
dynamic scales flip codes at rounding ties, so no closer hold is owed);
every arm carries its eager body's seconds (``eager_seconds``)."""

import json

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion.sampling import generate_trajectory_scan as jax_scan
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.models.quantized import make_quantized_eval_fn as jax_quant_fn
from distillation_trajectories_tpu.training import make_eval_model_fn as jax_eval_fn
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.scripts import bench_quant
from distillation_trajectories_torch.training import save_checkpoint
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    JaxBenchDraws,
    jax_variables,
    tmp_path,
)

torch.set_num_threads(2)

# The JAX record's keys (scripts/bench_quant.py:257-275).
JAX_KEYS = ("metric", "float_traj_per_s", "int8_traj_per_s", "int8_mode", "speedup",
            "endpoint_rel_l2", "arms", "mixed_blocks", "weights", "timesteps", "guidance",
            "iters", "preflight", "ts_iso")


def _flags(tmp_path):
    return ["--device", "cpu", "--batch", "2", "--timesteps", "4", "--iters", "1",
            "--size_factor", "0.05", "--image_size", "16", "--channels", "1",
            "--compute_dtype", "float32", "--base_dir", str(tmp_path)]


@pytest.fixture()
def jax_draws(monkeypatch):
    monkeypatch.setattr(bench_quant, "BenchDraws", JaxBenchDraws)


def _jax_endpoints(model):
    """JAX's seed-0 endpoints of the plain and the fold-only chain."""
    jcfg = JaxConfig(dataset="MNIST", image_size=16, channels=1, compute_dtype="float32")
    jmodel = jax_make_unet(jcfg, size_factor=0.05)
    variables = jax_variables(model)
    noise = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16, 1))
    alphas = jax_params(4, jcfg)["alphas"]
    fns = {"float": jax_eval_fn(jmodel, variables),
           "fold": jax_quant_fn(jmodel, variables, nbits=None)}
    return {arm: np.asarray(jax_scan(fn, noise, 4, alphas, 0, guidance_scale=3.0)[-1])
            for arm, fn in fns.items()}


def test_record_and_fold_endpoint_match_jax(tmp_path, jax_draws, capsys, monkeypatch):
    out = tmp_path / "bench_quant.json"
    ends = {}
    run = bench_quant.run
    monkeypatch.setattr(bench_quant, "run", lambda args: run(args, endpoints=ends))
    bench_quant.main(_flags(tmp_path) + ["--out", str(out)])
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    for key in JAX_KEYS:
        assert key in rec, key
    assert rec["weights"] == "random-init" and rec["preflight"]["status"] == "skipped"
    assert set(rec["arms"]) == set(bench_quant.ALL_ARMS)
    assert rec["mixed_blocks"] == ["dec1", "enc1", "enc2"]  # the Blocks at 8x8 or more of 16x16
    assert rec["int8_mode"].startswith("int8") and rec["endpoint_rel_l2"] < 0.05

    model = make_unet(Config(dataset="MNIST", image_size=16, channels=1, compute_dtype="float32",
                             device="cpu"), size_factor=0.05, seed=0)
    want = _jax_endpoints(model)
    assert set(ends) == set(bench_quant.ALL_ARMS)
    for arm in ("float", "fold"):
        np.testing.assert_allclose(ends[arm].numpy(), want[arm], rtol=1e-4, atol=1e-6,
                                   err_msg=arm)
    f_end = ends["float"]
    for arm in bench_quant.ALL_ARMS[1:]:
        rel = float((ends[arm] - f_end).norm() / (f_end.norm() + 1e-12))
        assert rec["arms"][arm]["endpoint_rel_l2"] == rel, arm
    # Folding moves float32 rounding only (both holds above pass for the
    # plain forward too), so the fold arm is told from float by a gap that
    # is not 0 but of JAX's order: exactly 0 is the plain forward again.
    jax_rel = float(np.linalg.norm(want["fold"] - want["float"]) / np.linalg.norm(want["float"]))
    got = rec["arms"]["fold"]["endpoint_rel_l2"]
    assert 0 < jax_rel < 1e-5 and 0 < got < 1e-5, (got, jax_rel)

    census = {a: rec["arms"][a]["census"] for a in ("int8", "int8_static", "int8_static_mixed")}
    n = census["int8"]["convs"]
    assert census["int8"] == census["int8_static"] == {"convs": n, "int8_convs": n - 1}  # final
    assert census["int8_static_mixed"]["convs"] == n
    assert 0 < census["int8_static_mixed"]["int8_convs"] < n - 1
    for arm in ("int8", "int8_static", "int8_static_mixed"):
        assert rec["arms"][arm]["endpoint_rel_l2"] < 0.05, arm
        assert rec["arms"][arm]["traj_per_s"] > 0 and len(rec["arms"][arm]["seconds"]) == 1
    for arm, entry in rec["arms"].items():
        assert len(entry["eager_seconds"]) == 1 and entry["eager_seconds"][0] > 0, arm


def test_use_checkpoint_loads_the_teacher_or_says_why_not(tmp_path, jax_draws, monkeypatch):
    monkeypatch.setattr(bench_quant, "project_root", str(tmp_path))
    flags = _flags(tmp_path) + ["--use_checkpoint", "--arms", "int8", "--no_census",
                                "--out", str(tmp_path / "q.json")]
    rec = bench_quant.main(flags)
    assert rec["weights"].startswith("random-init (checkpoint load failed")
    assert set(rec["arms"]) == {"float", "int8"} and "census" not in rec["arms"]["int8"]
    cfg = Config(base_dir=str(tmp_path), dataset="MNIST", image_size=16, channels=1,
                 device="cpu").create_directories()
    save_checkpoint(cfg.teacher_models_dir, 1, make_unet(cfg, size_factor=0.05, seed=4))
    rec = bench_quant.main(flags + ["--record_tag", "pytest"])
    assert rec["weights"] == "teacher-checkpoint"
    assert json.loads((tmp_path / "BENCH_QUANT_torch_pytest.json").read_text()) == rec
