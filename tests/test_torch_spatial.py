"""Spatial partitioning (``parallel/spatial.py``) on ``gloo`` worlds of 2
and 4 ranks, against the port's unsharded forward and JAX's spatially
partitioned forward on the same mesh shape (``tests/test_spatial.py``).

* The eval forward of an sf-0.1 U-Net on ``(1, 2)``, ``(2, 2)`` and, at
  48x48, ``(1, 4)``: 3 rows a shard at the 12-row level, so its 2x2 pool
  windows straddle shards and the level rule (rows stay split only while
  ``h % s == 0`` and ``h // s >= 2``) decides what is gathered; held at
  rtol/atol 2e-5 (``tests/test_spatial.py:62``).
* ``generate_trajectory`` and masked inpainting under
  ``Config.spatial_shape=(1, 2)`` against the unsharded runs at 2e-4
  (``tests/test_spatial.py:171-222``), and the height guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.parallel import make_spatial_eval_fn as jax_spatial_fn
from distillation_trajectories_tpu.parallel import make_spatial_mesh as jax_spatial_mesh
from distillation_trajectories_tpu.parallel import shard_batch_spatial as jax_shard_spatial
from distillation_trajectories_torch.editing import apply_masked_inpainting
from distillation_trajectories_torch.parallel.launch import spawn_ranks
from distillation_trajectories_torch.trajectories import generate_trajectory
from distillation_trajectories_torch.training import make_eval_model_fn

import torch_dist
from torch_parity import configs, port_model


def _case(shape, size, batch, seed, cond):
    x = np.random.default_rng(seed).standard_normal((batch, size, size, 1)).astype(np.float32)
    t = np.full((batch,), 3.0 + seed, np.float32)
    c = np.ones((batch, 1), np.float32) if cond else None
    return shape, x, t, c


CASES = {2: [_case((1, 2), 16, 4, 0, True)],
         4: [_case((2, 2), 16, 4, 2, False), _case((1, 4), 48, 2, 3, True)]}


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = configs()
    jmodel = jax_make_unet(jcfg, size_factor=0.1)
    variables = jax_init_unet(jmodel, jcfg, jax.random.PRNGKey(0))
    model = port_model(tcfg, 0.1, variables)
    sd = model.state_dict()
    x = np.random.default_rng(4).standard_normal((4, 16, 16, 1)).astype(np.float32)
    image = np.random.default_rng(5).uniform(size=(16, 16, 1)).astype(np.float32)
    out = {n: spawn_ranks(n, torch_dist.spatial_forwards,
                          (cases, sd, (x, image) if n == 2 else None),
                          backend="gloo", timeout=300)
           for n, cases in CASES.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, variables=variables, model=model,
                x=x, image=image, out=out)


@pytest.mark.parametrize("world_size, i", [(2, 0), (4, 0), (4, 1)],
                         ids=["1x2", "2x2", "1x4-48px"])
def test_spatial_forward_matches_unsharded_and_jax(world, world_size, i):
    shape, x, t, c = CASES[world_size][i]
    tc = None if c is None else torch.from_numpy(c)
    with torch.no_grad():
        ref = make_eval_model_fn(world["model"])(torch.from_numpy(x), torch.from_numpy(t), tc, tc)
    jc = None if c is None else jnp.asarray(c)
    mesh = jax_spatial_mesh(shape)
    jout = jax.jit(jax_spatial_fn(world["jmodel"], world["variables"], mesh))(
        jax_shard_spatial(x, mesh), jnp.asarray(t), jc, jc)
    for rank_out in world["out"][world_size]:
        got = rank_out["forwards"][i].numpy()
        assert got.shape == x.shape
        np.testing.assert_allclose(got, ref.numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(jout), rtol=2e-5, atol=2e-5)


def test_spatial_guard_names_the_height(world):
    for outs in world["out"].values():
        for out in outs:
            assert "image height 15 not divisible by spatial axis" in out["guard"]


def test_generate_trajectory_and_inpainting_under_spatial_shape(world):
    tcfg, model = world["tcfg"], world["model"]
    ref = generate_trajectory(model, torch.from_numpy(world["x"]), 10, seed=3,
                              guidance_scale=2.0, config=tcfg)
    inpainted = apply_masked_inpainting(model, tcfg, world["image"], seed=2,
                                        record_trajectory=False)["inpainted_image"]
    for out in world["out"][2]:
        np.testing.assert_allclose(out["traj"].numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(np.asarray(out["inpainted"]), np.asarray(inpainted),
                                   rtol=2e-4, atol=2e-4)
