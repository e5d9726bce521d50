"""The progressive round's epoch lane on the CPU
(``training/progressive.py::make_progressive_epoch_fn``, the counterpart of
JAX's jitted step, ``training/progressive.py:148``):

- for the plain, guided and ``teacher_guided`` forms, the epoch lane over
  an uploaded image set against ``make_progressive_distill_step`` in the
  per-batch loop over the same loader (sf 0.1, 16x16x1, batch 8, teacher
  T=10 → S=5, dropout 0.3, the port's draws, two epochs of 4 batches):
  losses, weights, BatchNorm statistics, Adam state and the draw
  generator's end state equal (``torch.equal``), since on the CPU both
  lanes run the same operations;
- ``progressive_distill`` runs every round through the epoch lane on one
  device, uploading the image set once a call, and through the per-batch
  loop on a mesh (a spy on ``run_train_epoch``'s ``use_scan``); both
  lanes return the same model.

``tests/test_torch_progressive.py`` holds the lane's rounds to JAX's loop;
``tests/test_torch_cuda.py`` holds the captured round to the eager one on
the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distillation_trajectories_torch.data.datasets import DataLoader
from distillation_trajectories_torch.diffusion import get_diffusion_params
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.training import progressive
from distillation_trajectories_torch.training.loop import run_train_epoch, upload_dataset
from distillation_trajectories_torch.training.state import TorchDraws, create_train_state
from torch_parity import configs, tmp_path  # noqa: F401  (tmp_path: outputs removed)

torch.set_num_threads(2)
T, S, B, N, EPOCHS = 10, 5, 8, 32, 2
FORMS = {"plain": (None, False), "guided": ((1.0, 5.0), False),
         "teacher_guided": ((1.0, 5.0), True)}


def _round(form, lane):
    """``EPOCHS`` epochs of one progressive round from seeded weights and
    draws through ``run_train_epoch``: the epoch lane when ``lane ==
    "scan"``, else the per-batch loop of the step."""
    guidance_range, teacher_guided = FORMS[form]
    cfg = configs(timesteps=T, dropout=0.3)[1]
    images = np.random.default_rng(0).uniform(-1, 1, (N, 16, 16, 1)).astype(np.float32)
    loader = DataLoader(images, np.zeros(N, np.int32), B, shuffle=True, seed=3)
    dpt, dps = get_diffusion_params(T), get_diffusion_params(S)
    make = (progressive.make_progressive_epoch_fn if lane == "scan"
            else progressive.make_progressive_distill_step)
    fn = make(make_unet(cfg, size_factor=0.1, seed=9), dpt["alphas"], dps["alphas"], T, dpt,
              guidance_range=guidance_range, teacher_guided=teacher_guided)
    state = create_train_state(make_unet(cfg, size_factor=0.1, seed=0), cfg, TorchDraws(4, "cpu"))
    dataset = upload_dataset(loader, "cpu")
    losses = []
    for _ in range(EPOCHS):
        state, epoch_losses, n = run_train_epoch(
            state, train_step=fn, loader=loader, config=cfg, device="cpu", progress_desc="",
            log_label="", log_every=0, use_scan=lane == "scan", epoch_fn=fn,
            dataset_dev=dataset, reduce_loss=False)
        assert n == N // B
        losses.append(epoch_losses)
    return np.concatenate(losses), state


def _assert_same_training(got, want):
    """Equal weights, BatchNorm statistics and Adam state."""
    for (name, a), (_, b) in zip(got.model.state_dict().items(), want.model.state_dict().items()):
        assert torch.equal(a, b), name
    params = dict(want.model.named_parameters())
    for name, p in got.model.named_parameters():
        mine, theirs = got.optimizer.state[p], want.optimizer.state[params[name]]
        assert set(mine) == set(theirs) == {"step", "exp_avg", "exp_avg_sq"}, name
        for k in mine:
            assert torch.equal(mine[k], theirs[k]), (name, k)


@pytest.mark.parametrize("form", list(FORMS))
def test_epoch_lane_equals_per_batch_loop(form):
    (scan_losses, scan), (loop_losses, loop) = (_round(form, lane) for lane in ("scan", "loop"))
    assert scan_losses.shape == (EPOCHS * N // B,) and np.isfinite(scan_losses).all()
    np.testing.assert_array_equal(scan_losses, loop_losses)
    assert scan.step == loop.step == EPOCHS * N // B
    assert torch.equal(scan.draws.generator.get_state(), loop.draws.generator.get_state())
    _assert_same_training(scan, loop)


class _MeshWithoutDataAxis:
    """A stand-in mesh with no data or model axis: every collective of the
    per-batch step is then a no-op, so the loop runs as on one device."""

    mesh_dim_names = ()


def _distill(tmp_path, monkeypatch, on_mesh):
    """Two rounds of 2 epochs (10 → 5 → 2 steps) of ``progressive_distill``
    with ``run_train_epoch``'s lanes and the uploads recorded."""
    cfg = configs(tmp_path, timesteps=T, dropout=0.3, limit_batches_per_epoch=2)[1]
    lanes, uploads = [], []
    real_epoch, real_upload = progressive.run_train_epoch, progressive.upload_dataset

    def epoch(state, **kw):
        lanes.append(kw["use_scan"])
        return real_epoch(state, **kw)

    def upload(loader, device):
        uploads.append(loader.seed)
        return real_upload(loader, device)

    monkeypatch.setattr(progressive, "run_train_epoch", epoch)
    monkeypatch.setattr(progressive, "upload_dataset", upload)
    if on_mesh:
        make_state = progressive.create_train_state
        monkeypatch.setattr(progressive, "create_train_state", lambda *a, **k: dataclasses.replace(
            make_state(*a, **k), mesh=_MeshWithoutDataAxis()))
    model, steps = progressive.progressive_distill(
        cfg, make_unet(cfg, size_factor=0.1, seed=5), rounds=2, seed=1, epochs_per_round=2)
    assert steps == 2
    return model, lanes, uploads


def test_progressive_distill_lane_follows_the_device(tmp_path, monkeypatch):
    model, lanes, uploads = _distill(tmp_path / "one", monkeypatch, on_mesh=False)
    assert lanes == [True] * 4 and uploads == [1]  # round 1's loader (seed 1): once a call
    monkeypatch.undo()
    mesh_model, mesh_lanes, mesh_uploads = _distill(tmp_path / "mesh", monkeypatch, on_mesh=True)
    assert mesh_lanes == [False] * 4 and mesh_uploads == []
    for (name, a), (_, b) in zip(model.state_dict().items(), mesh_model.state_dict().items()):
        assert torch.equal(a, b), name
