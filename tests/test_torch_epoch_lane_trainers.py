"""Port parity for the trainers' default lane: ``train_teacher``, then
``continue_training``, with the default ``Config`` on both sides (the JAX
package's epoch scan against the port's epoch lane), the JAX key stream
replayed into the port (``torch_parity.JaxDraws``) and dropout 0: the same
checkpoint files and metrics records, per-epoch losses at rtol 1e-4 for the
first epoch and 1e-3 for later ones (``torch_parity.check_losses``).  No
sample grids: ``test_torch_trainers.py`` holds them on the per-batch lane.
"""

import importlib
import json
import os
import shutil

from distillation_trajectories_tpu.data import datasets as jax_datasets
from distillation_trajectories_tpu.training import teacher as jax_teacher
from distillation_trajectories_torch.training import teacher as port_teacher
import torch
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    JaxDraws,
    check_losses,
    configs,
    tmp_path,
)

jax_continue = importlib.import_module("distillation_trajectories_tpu.training.continue_training")
port_continue = importlib.import_module("distillation_trajectories_torch.training.continue_training")

torch.set_num_threads(2)


class _Epochs:
    """Wraps a trainer module's ``run_train_epoch``: each epoch's average
    loss and the lane it took."""

    def __init__(self, monkeypatch, module):
        self.losses, self.lanes, self._run = [], [], module.run_train_epoch
        monkeypatch.setattr(module, "run_train_epoch", self)

    def __call__(self, *args, **kwargs):
        out = self._run(*args, **kwargs)
        self.losses.append(out[-2])
        self.lanes.append("scan" if kwargs.get("use_scan") else "loop")
        return out


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_teacher_and_continue_training_default_lanes_match_jax(tmp_path, monkeypatch):
    """The default Config on both sides: JAX's epoch scan and the port's
    epoch lane (``DTT_PRECOMPILE=0`` only stops JAX compiling ahead)."""
    monkeypatch.setenv("DTT_PRECOMPILE", "0")
    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [])
    kw = dict(epochs=2, limit_batches_per_epoch=2, num_samples_to_generate=0)
    jcfg, tcfg = configs(tmp_path / "jax", **kw)[0], configs(tmp_path / "port", **kw)[1]
    assert jcfg.epoch_scan and tcfg.epoch_scan
    lanes = _Epochs(monkeypatch, port_teacher)
    jax_teacher.train_teacher(jcfg, seed=0)
    state = port_teacher.train_teacher(tcfg, seed=0, draws=JaxDraws.factory(jcfg))
    assert lanes.lanes == ["scan", "scan"] and state.step == 4
    got, want = (_records(os.path.join(c.results_dir, "teacher_metrics.jsonl")) for c in (tcfg, jcfg))
    check_losses([r["avg_loss"] for r in got], [r["avg_loss"] for r in want])
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["steps"] for r in got] == [r["steps"] for r in want] == [2, 2]
    assert sorted(os.listdir(tcfg.teacher_models_dir)) == sorted(os.listdir(jcfg.teacher_models_dir))

    shutil.copy(os.path.join(jcfg.teacher_models_dir, "model_epoch_2.msgpack"),
                os.path.join(tcfg.teacher_models_dir, "model_epoch_2.msgpack"))
    want = _Epochs(monkeypatch, jax_continue)
    got = _Epochs(monkeypatch, port_continue)
    jax_continue.continue_training(jcfg, 2, seed=0)
    state = port_continue.continue_training(tcfg, 2, seed=0, draws=JaxDraws.factory(jcfg))
    assert got.lanes == ["scan", "scan"] and state.step == 4
    check_losses(got.losses, want.losses)
    assert sorted(os.listdir(tcfg.teacher_models_dir)) == sorted(os.listdir(jcfg.teacher_models_dir))


