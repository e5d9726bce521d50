"""``train_students`` with the default ``Config`` on both sides, on size
factors {0.01, 0.05, 0.1}: the JAX package trains 0.01 and 0.05 as one
vmapped group and 0.1 alone through its epoch scan; the port trains them
through its student group and its epoch lane.  The JAX key stream is
replayed into the port (``torch_parity.JaxDraws``), dropout 0.  The same
files, metrics records with per-epoch losses at rtol 1e-4 for the first
epoch and 1e-3 for later ones (``torch_parity.check_losses``), and sample
grids of the same PNG shape."""

import json
import os

import numpy as np
import torch
from PIL import Image

from distillation_trajectories_tpu.data import datasets as jax_datasets
from distillation_trajectories_tpu.training import students as jax_students
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.training import save_checkpoint
from distillation_trajectories_torch.training import students as port_students
from torch_parity import JaxDraws, check_losses, configs, file_set

torch.set_num_threads(2)
SFS = [0.01, 0.05, 0.1]


def _records(cfg, sf):
    with open(os.path.join(cfg.results_dir, f"distill_metrics_size_{sf}.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_students_default_lanes_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [])
    monkeypatch.delenv("DTT_PRECOMPILE", raising=False)  # JAX groups only with it on
    kw = dict(epochs=2, limit_batches_per_epoch=2, num_samples_to_generate=4, samples_grid_size=2)
    jcfg, tcfg = configs(tmp_path / "jax", **kw)[0], configs(tmp_path / "port", **kw)[1]
    teacher = make_unet(tcfg, 1.0, device="cpu", seed=7)  # both read the port's checkpoint
    for cfg in (jcfg, tcfg):
        save_checkpoint(cfg.teacher_models_dir, 1, teacher)
    jax_groups, port_groups = [], []
    jax_group, port_group = jax_students._distill_group_vmapped, port_students._distill_group
    monkeypatch.setattr(jax_students, "_distill_group_vmapped",
                        lambda *a, **k: jax_groups.append(list(a[3])) or jax_group(*a, **k))
    monkeypatch.setattr(port_students, "_distill_group",
                        lambda *a, **k: port_groups.append(list(a[2])) or port_group(*a, **k))

    jax_students.train_students(jcfg, custom_size_factors=SFS, seed=0)
    out = port_students.train_students(tcfg, custom_size_factors=SFS, seed=0,
                                       draws=JaxDraws.factory(jcfg))
    assert jax_groups == port_groups == [[0.01, 0.05]]
    assert sorted(out) == SFS
    for sf in SFS:
        got, want = _records(tcfg, sf), _records(jcfg, sf)
        check_losses([r["avg_loss"] for r in got], [r["avg_loss"] for r in want])
        assert [list(r) for r in got] == [list(r) for r in want]
        assert [(r["epoch"], r["size_factor"]) for r in got] == \
            [(r["epoch"], r["size_factor"]) for r in want]
        name = f"student_samples_size_{sf}_epoch_2.png"
        pixels = np.asarray(Image.open(os.path.join(tcfg.results_dir, name)))
        grid = np.asarray(Image.open(os.path.join(jcfg.results_dir, name)))
        assert pixels.dtype == grid.dtype == np.uint8 and pixels.shape == grid.shape
    assert file_set(tcfg.output_dir) == file_set(jcfg.output_dir)
