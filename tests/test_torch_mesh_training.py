"""Training on the ``(data, model)`` mesh: ``train_teacher`` and
``distill_diffusion_model`` with ``Config.mesh_shape`` (2, 1) and (1, 2) on
a 2-rank ``gloo`` world and (2, 2) on a 4-rank one, held to the unsharded
port run at JAX's ``_assert_spmd_parity`` tolerances
(``tests/test_sweep_parallel.py:29-56``): per-epoch losses at rtol 1e-4,
parameters at rtol 2e-2 / atol 5e-4 (BatchNorm statistics are not held,
as JAX's test does not hold them: Adam's noise on the conv biases that
feed a BatchNorm, whose true gradient is 0, moves their means).  The step draws are JAX's
(``torch_parity.JaxDraws``' key stream; the initial weights are the port's
seeded init, to spare a JAX init of the sf-1.0 U-Net), recorded in this
process and replayed in the ranks, which import no JAX;
``tests/test_torch_trainers.py`` holds the unsharded port trainers to
JAX's.  The (2, 2) teacher writes a sharded
checkpoint, which this one process reads back whole.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_torch.models import make_unet, variables_from_unet_state_dict
from distillation_trajectories_torch.parallel.launch import spawn_ranks
from distillation_trajectories_torch.training import load_checkpoint, train_teacher
from distillation_trajectories_torch.training.students import distill_diffusion_model

import torch_dist
from torch_parity import JaxDraws, configs

KW = dict(limit_batches_per_epoch=2, num_samples_to_generate=0)
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}


class _JaxStepDraws(JaxDraws):
    """JAX's key stream for the steps; the port's seeded init (the init
    still takes its key, so the steps' keys are the trainers')."""

    def init_unet(self, config, size_factor):
        self._next()
        return make_unet(config, size_factor=size_factor, device="cpu", seed=1)


def _losses(path):
    with open(path) as f:
        return [rec["avg_loss"] for rec in map(json.loads, f) if "avg_loss" in rec]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_training")
    jcfg, tcfg = configs(root / "plain", **KW)
    plain = {}
    rec = torch_dist.Recording(_JaxStepDraws(jcfg, 0, "cpu"))
    state = train_teacher(tcfg, seed=0, draws=lambda seed, device: rec)
    plain["teacher"] = (_losses(os.path.join(tcfg.results_dir, "teacher_metrics.jsonl")),
                        state.model.state_dict(), rec.calls)
    teacher_sd = make_unet(tcfg, size_factor=0.5, device="cpu", seed=7).state_dict()
    rec = torch_dist.Recording(_JaxStepDraws(jcfg, 250, "cpu"))
    student = distill_diffusion_model(torch_dist.model_from(tcfg, 0.5, teacher_sd), tcfg,
                                      size_factor=0.25, seed=0, draws=lambda seed, device: rec)
    plain["distill"] = (_losses(os.path.join(tcfg.results_dir,
                                             "distill_metrics_size_0.25.jsonl")),
                        student.state_dict(), rec.calls)
    got = {}
    for world, shapes in MESHES.items():
        todo = [(kind, shape, str(root / f"{kind}_{shape[0]}x{shape[1]}"),
                 dict(KW, checkpoint_sharded=world == 4 and kind == "teacher"),
                 plain[kind][2], teacher_sd)
                for shape in shapes for kind in ("teacher", "distill")]
        out = spawn_ranks(world, torch_dist.mesh_training, (todo,), backend="gloo", timeout=400)
        for i, (kind, shape, base_dir, *_rest) in enumerate(todo):
            got[(kind, shape)] = dict(out[0][i], base_dir=base_dir,
                                      ranks=[o[i]["local_shapes"] for o in out])
    yield plain, got
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("shape", [s for shapes in MESHES.values() for s in shapes],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["teacher", "distill"])
def test_mesh_training_matches_unsharded(runs, kind, shape):
    plain, got = runs
    losses, state, _ = plain[kind]
    run = got[(kind, shape)]
    assert len(run["losses"]) == 1
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-4)
    assert list(run["state"]) == list(state)
    params = {k for k, _ in make_unet(configs()[1], size_factor=0.25).named_parameters()}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(run["state"][k], v), k
        elif k in params:  # the parameters, as JAX's _assert_spmd_parity
            np.testing.assert_allclose(run["state"][k].numpy(), v.numpy(), rtol=2e-2, atol=5e-4,
                                       err_msg=k)
    # The model axis holds half of every sharded leaf on each rank.
    name = "enc1.conv1.weight"
    want = state[name].shape[0] // shape[1]
    assert all(local[name][0] == want for local in run["ranks"])


def test_sharded_checkpoint_of_a_4_rank_mesh_loads_in_one_process(runs):
    _, got = runs
    run = got[("teacher", (2, 2))]
    teacher_dir = os.path.join(run["base_dir"], "output", "models", "teacher")
    assert os.path.isdir(os.path.join(teacher_dir, "model_epoch_1.dcp"))
    payload = load_checkpoint(teacher_dir, 1)
    want = variables_from_unet_state_dict(run["state"])
    for col in ("params", "batch_stats"):
        for a, b in zip(jax.tree_util.tree_leaves(payload[col]),
                        jax.tree_util.tree_leaves(want[col])):
            np.testing.assert_array_equal(a, b)
    assert int(payload["opt_state"]["0"]["count"]) == 2
