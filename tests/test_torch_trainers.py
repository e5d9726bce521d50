"""Port parity for the whole training slice: ``train_teacher``,
``continue_training`` and ``train_students`` (with a same-architecture
pair) on the CPU against the JAX trainers in their per-batch loop
(``epoch_scan=False``, ``DTT_PRECOMPILE=0``), with the JAX key stream
replayed into the port (``torch_parity.JaxDraws``) and dropout 0: the
same checkpoint and result files, the same metrics records, sample-grid
PNGs, and per-epoch losses — the first epoch at rtol 1e-4, later epochs at
rtol 1e-3.  Adam's first steps move every weight by about ±lr whatever the
size of its gradient, so the gradients' rounding noise reaches the loss:
the port's own epoch-2 teacher loss moves by up to 2.5e-4 of itself
between runs on 1, 3 and 8 CPU threads, and differs from JAX's by as much.
"""

import dataclasses
import importlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from distillation_trajectories_tpu.data import datasets as jax_datasets
from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import checkpoints as jax_ckpt
from distillation_trajectories_tpu.training import students as jax_students
from distillation_trajectories_tpu.training import teacher as jax_teacher
from distillation_trajectories_tpu.utils.viz import make_grid as jax_make_grid
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.training import students as port_students
from distillation_trajectories_torch.training import teacher as port_teacher
from distillation_trajectories_torch.utils.viz import save_image_grid
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    JaxDraws,
    configs,
    tmp_path,
)

# The packages export the function under the module's name.
jax_continue = importlib.import_module("distillation_trajectories_tpu.training.continue_training")
port_continue = importlib.import_module("distillation_trajectories_torch.training.continue_training")

torch.set_num_threads(2)
KW = dict(epochs=2, limit_batches_per_epoch=2, num_samples_to_generate=4,
          samples_grid_size=2, epoch_scan=False)


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """(JAX config, port config) in separate output trees; the JAX package
    reads no dataset outside them and runs its plain per-batch loop."""
    monkeypatch.setenv("DTT_PRECOMPILE", "0")
    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [])
    return configs(tmp_path / "jax", **KW)[0], configs(tmp_path / "port", **KW)[1]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_losses(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)


def _check_records(got_path, want_path):
    got, want = _records(got_path), _records(want_path)
    assert len(got) == len(want) == KW["epochs"]
    _check_losses([r["avg_loss"] for r in got], [r["avg_loss"] for r in want])
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k == "avg_loss":
                continue
            elif k not in ("time", "seconds"):
                assert g[k] == w[k], k


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _check_png(path, want_path):
    """The port's grid PNG has the shape of JAX's grid PNG of the same run
    (both drawn through a ``samples_figure_size`` matplotlib figure)."""
    pixels, want = np.asarray(Image.open(path)), np.asarray(Image.open(want_path))
    assert pixels.dtype == want.dtype == np.uint8 and pixels.shape == want.shape


class _LossRecorder:
    """Wraps a trainer module's ``run_train_epoch`` to keep each epoch's
    full-precision average loss."""

    def __init__(self, monkeypatch, module):
        self.losses, self._run = [], module.run_train_epoch
        monkeypatch.setattr(module, "run_train_epoch", self)

    def __call__(self, *args, **kwargs):
        out = self._run(*args, **kwargs)
        self.losses.append(out[-2])
        return out


def test_grid_png_holds_jax_make_grid_pixels(tmp_path, monkeypatch):
    """Without matplotlib, the raw writer's PNG is JAX's ``make_grid``
    rounded to 8 bits (with it, ``test_torch_viz.py`` holds the figure)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    images = np.random.default_rng(0).uniform(-1.5, 1.5, (5, 6, 7, 1)).astype(np.float32)
    path = str(tmp_path / "grid.png")
    save_image_grid(torch.from_numpy(images), path, nrow=2)
    want = jax_make_grid(np.clip((images + 1.0) / 2.0, 0.0, 1.0), nrow=2)
    want = np.round(np.repeat(want, 3, axis=-1) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), want)


def test_train_teacher_and_continue_training_match_jax(pair, monkeypatch):
    jcfg, tcfg = pair
    jax_teacher.train_teacher(jcfg, seed=0)
    state = port_teacher.train_teacher(tcfg, seed=0, draws=JaxDraws.factory(jcfg))
    assert state.step == 4 and next(state.model.parameters()).device.type == "cpu"
    _check_records(os.path.join(tcfg.results_dir, "teacher_metrics.jsonl"),
                   os.path.join(jcfg.results_dir, "teacher_metrics.jsonl"))
    assert _files(tcfg.output_dir) == _files(jcfg.output_dir)
    assert os.listdir(tcfg.teacher_models_dir) and sorted(os.listdir(tcfg.teacher_models_dir)) == \
        ["model_epoch_1.msgpack", "model_epoch_2.msgpack"]
    _check_png(os.path.join(tcfg.results_dir, "samples_epoch_2.png"),
               os.path.join(jcfg.results_dir, "samples_epoch_2.png"))

    # Resume both from the JAX-written epoch-2 checkpoint, Adam state included.
    shutil.copy(os.path.join(jcfg.teacher_models_dir, "model_epoch_2.msgpack"),
                os.path.join(tcfg.teacher_models_dir, "model_epoch_2.msgpack"))
    want = _LossRecorder(monkeypatch, jax_continue)
    got = _LossRecorder(monkeypatch, port_continue)
    jax_continue.continue_training(jcfg, 2, seed=0)
    state = port_continue.continue_training(tcfg, 2, seed=0, draws=JaxDraws.factory(jcfg))
    assert len(got.losses) == len(want.losses) == 2 and state.step == 4
    _check_losses(got.losses, want.losses)
    assert _files(tcfg.output_dir) == _files(jcfg.output_dir)
    payload = jax_ckpt.load_checkpoint(tcfg.teacher_models_dir, 4)  # JAX reads the port's
    assert payload["epoch"] == 4 and int(payload["opt_state"]["0"]["count"]) == 8


def test_train_students_match_jax(pair):
    jcfg, tcfg = pair
    teacher = jax_make_unet(jcfg, size_factor=1.0)
    variables = jax_init_unet(teacher, jcfg, __import__("jax").random.PRNGKey(7))
    for cfg in (jcfg, tcfg):
        jax_ckpt.save_checkpoint(cfg.teacher_models_dir, 1, variables["params"],
                                 batch_stats=variables["batch_stats"])
    sfs = [0.01, 0.05]  # one architecture: the 16-channel floor
    a, b = (make_unet(tcfg, size_factor=sf, device="cpu") for sf in sfs)
    assert (a.dims, a.time_emb_dim) == (b.dims, b.time_emb_dim)

    jax_students.train_students(jcfg, custom_size_factors=sfs, seed=0)
    out = port_students.train_students(tcfg, custom_size_factors=sfs, seed=0,
                                       draws=JaxDraws.factory(jcfg))
    assert set(out) == set(sfs)
    for sf in sfs:
        name = f"distill_metrics_size_{sf}.jsonl"
        _check_records(os.path.join(tcfg.results_dir, name), os.path.join(jcfg.results_dir, name))
        grid = f"student_samples_size_{sf}_epoch_2.png"
        _check_png(os.path.join(tcfg.results_dir, grid), os.path.join(jcfg.results_dir, grid))
    assert _files(tcfg.output_dir) == _files(jcfg.output_dir)

    # skip_existing loads the finished students instead of training them.
    again = port_students.train_students(tcfg, custom_size_factors=sfs, skip_existing=True)
    for sf in sfs:
        for (k, v), w in zip(again[sf].state_dict().items(), out[sf].state_dict().values()):
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, w.cpu()), k

    # sweep_parallel trains both students at once: bit for bit the sequential ones.
    par_cfg = dataclasses.replace(tcfg, base_dir=tcfg.base_dir + "_par").create_directories()
    jax_ckpt.save_checkpoint(par_cfg.teacher_models_dir, 1, variables["params"],
                             batch_stats=variables["batch_stats"])
    par = port_students.train_students(par_cfg, custom_size_factors=sfs, seed=0,
                                       sweep_parallel=True, draws=JaxDraws.factory(jcfg))
    for sf in sfs:
        for (k, v), w in zip(par[sf].state_dict().items(), out[sf].state_dict().values()):
            assert torch.equal(v, w), k
        grid = f"student_samples_size_{sf}_epoch_2.png"
        _check_png(os.path.join(par_cfg.results_dir, grid), os.path.join(jcfg.results_dir, grid))
        assert os.path.exists(os.path.join(par_cfg.student_dir(sf), "model_epoch_2.msgpack"))
