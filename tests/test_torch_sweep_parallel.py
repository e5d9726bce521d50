"""``parallel/sweep.py::distill_students_parallel`` and
``train_students(sweep_parallel=True)``: every student trains at once,
student *i* on ``devices[i % n]``, and each is bit for bit what the
sequential ``distill_diffusion_model`` gives it on the CPU (the same draws
from ``seed + int(sf * 1000)``, batches, per-epoch losses, checkpoints
and end-of-training grids), as JAX's ``tests/test_sweep_parallel.py``
holds its sweep to the sequential trainer.  Dropout is on, so the masks'
draw order is checked too.
"""

import json
import os

import torch

from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.parallel import distill_students_parallel
from distillation_trajectories_torch.training import save_checkpoint, train_students
from distillation_trajectories_torch.training.checkpoints import load_checkpoint
from distillation_trajectories_torch.training.students import distill_diffusion_model

from torch_parity import configs, tmp_path  # tmp_path: each test's outputs removed when it ends

KW = dict(epochs=2, limit_batches_per_epoch=2, num_samples_to_generate=4, samples_grid_size=2,
          dropout=0.3)
SIZES = [0.1, 0.25]


def _avg_losses(path, sf=None):
    with open(path) as f:
        return [r["avg_loss"] for r in map(json.loads, f)
                if "avg_loss" in r and (sf is None or r["size_factor"] == sf)]


def test_parallel_students_equal_the_sequential_trainer(tmp_path):
    _, par = configs(tmp_path / "par", **KW)
    _, seq = configs(tmp_path / "seq", **KW)
    teacher = make_unet(par, size_factor=0.5, device="cpu", seed=7).eval()
    got = distill_students_parallel(par, teacher, SIZES, seed=0, devices=["cpu", "cpu"])
    assert set(got) == set(SIZES)
    for sf in SIZES:
        want = distill_diffusion_model(teacher, seq, size_factor=sf, seed=0)
        for (k, v), w in zip(got[sf].state_dict().items(), want.state_dict().values()):
            assert torch.equal(v, w), (sf, k)
        assert _avg_losses(os.path.join(par.results_dir, "sweep_parallel_metrics.jsonl"), sf) == \
            _avg_losses(os.path.join(seq.results_dir, f"distill_metrics_size_{sf}.jsonl"))
        for cfg in (par, seq):
            assert load_checkpoint(cfg.student_dir(sf), 2)["epoch"] == 2
        grid = f"student_samples_size_{sf}_epoch_2.png"
        with open(os.path.join(par.results_dir, grid), "rb") as a, \
                open(os.path.join(seq.results_dir, grid), "rb") as b:
            assert a.read() == b.read()


def test_train_students_sweep_parallel_ignores_the_mesh_with_jax_warning(tmp_path, capsys):
    _, cfg = configs(tmp_path, epochs=1, limit_batches_per_epoch=1, num_samples_to_generate=0,
                     mesh_shape=(2, 1))
    save_checkpoint(cfg.teacher_models_dir, 1, make_unet(cfg, size_factor=1.0, device="cpu"))
    out = train_students(cfg, custom_size_factors=SIZES, seed=0, sweep_parallel=True)
    assert set(out) == set(SIZES)
    assert "sweep_parallel uses per-device student placement and ignores " \
           "mesh_shape=(2, 1)" in capsys.readouterr().out
    assert len(_avg_losses(os.path.join(cfg.results_dir, "sweep_parallel_metrics.jsonl"))) == 2
