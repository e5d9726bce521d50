"""The data-sharded sampler and sweep (``trajectories/engine.py`` under
``Config.mesh_shape``) on a 2-rank ``gloo`` world.

* The CFG chain of an sf-0.1 U-Net with its batch rows over ``(2, 1)``
  (each rank its rows of the global draws, the trajectory gathered) is
  held to JAX's ``generate_trajectory_scan`` on its virtual ``(8, 1)``
  mesh and to the port's unsharded chain at rtol 2e-4 / atol 1e-5
  (``tests/test_sharding.py:82``).
* ``sweep_compare_trajectories_multi`` on ``(2, 1)``, with one job the
  data axis divides (4 samples, injected draws, 32x32x1 states so the
  Wasserstein subsample uniforms are sharded too) and one it does not
  (3 samples: it runs unsharded, as in JAX), returns on every rank the
  unsharded sweep's metrics at rtol 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.diffusion import generate_trajectory_scan as jax_scan
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.parallel import make_mesh as jax_make_mesh
from distillation_trajectories_tpu.parallel import shard_batch as jax_shard_batch
from distillation_trajectories_tpu.training import make_eval_model_fn as jax_eval_fn
from distillation_trajectories_torch.diffusion import generate_trajectory_scan, get_diffusion_params
from distillation_trajectories_torch.parallel.launch import spawn_ranks
from distillation_trajectories_torch.trajectories import SweepDraws, sweep_compare_trajectories_multi
from distillation_trajectories_torch.training import make_eval_model_fn

import torch_dist
from torch_parity import configs, jax_step_noise, port_model

T = 10


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = configs()
    jvars = {sf: jax_init_unet(jax_make_unet(jcfg, size_factor=sf), jcfg,
                               jax.random.PRNGKey(i)) for i, sf in enumerate((0.1, 1.0))}
    sds = {sf: port_model(tcfg, sf, v).state_dict() for sf, v in jvars.items()}
    noise = np.random.default_rng(1).standard_normal((8, 16, 16, 1)).astype(np.float32)
    step_noise = jax_step_noise([0], T, noise.shape)[:, 0].astype(np.float32)
    rng = np.random.default_rng(2)
    d = 32 * 32
    draws = SweepDraws(*(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((4, 32, 32, 1)), rng.standard_normal((5, 4, 32, 32, 1)),
        rng.uniform(size=(4, 7, d)))))
    out = spawn_ranks(2, torch_dist.sharded_sweep, (sds, noise, step_noise, draws),
                      backend="gloo", timeout=300)
    return dict(jcfg=jcfg, tcfg=tcfg, jvars=jvars, sds=sds, noise=noise,
                step_noise=step_noise, draws=draws, out=out)


def test_sharded_chain_matches_jax_on_its_mesh_and_the_unsharded_chain(world):
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    noise = world["noise"]
    jfn = jax_eval_fn(jax_make_unet(jcfg, size_factor=0.1), world["jvars"][0.1])
    alphas = jax_params(T, jcfg)["alphas"]
    jtraj = jax.jit(lambda n: jax_scan(jfn, n, T, alphas, 0, guidance_scale=3.0))(
        jax_shard_batch(noise, jax_make_mesh((8, 1))))
    model = torch_dist.model_from(tcfg, 0.1, world["sds"][0.1])
    plain = generate_trajectory_scan(make_eval_model_fn(model), torch.from_numpy(noise), T,
                                     get_diffusion_params(T, tcfg)["alphas"], 0,
                                     guidance_scale=3.0,
                                     step_noise=torch.from_numpy(world["step_noise"]))
    for out in world["out"]:
        traj = out["traj"]
        assert traj.shape == (T + 1, 8, 16, 16, 1)
        np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(traj.numpy(), plain.numpy(), rtol=2e-4, atol=1e-5)


def test_sharded_sweep_metrics_match_the_unsharded_sweep(world, capsys):
    import dataclasses

    tcfg = dataclasses.replace(world["tcfg"], image_size=32)
    teacher, student = (torch_dist.model_from(tcfg, sf, world["sds"][sf]) for sf in (1.0, 0.1))
    want = sweep_compare_trajectories_multi(teacher, [
        {"students": {0.1: student}, "guidance_scales": (1.0, 3.0), "num_samples": 4,
         "base_seed": 42, "timesteps": 6, "draws": world["draws"]},
        {"students": {0.1: student}, "guidance_scales": (3.0,), "num_samples": 3,
         "base_seed": 7, "timesteps": 6},
    ], tcfg, verbose=False)
    for out in world["out"]:
        got = out["results"]
        assert [set(job) for job in got] == [set(job) for job in want]
        for gjob, wjob in zip(got, want):
            for sf in wjob:
                for role in ("teacher_metrics", "student_metrics"):
                    for gs, metrics in wjob[sf][role].items():
                        assert set(gjob[sf][role][gs]) == set(metrics)
                        for k, v in metrics.items():
                            np.testing.assert_allclose(gjob[sf][role][gs][k], v, rtol=1e-4,
                                                       err_msg=f"{sf} {gs} {k}")
