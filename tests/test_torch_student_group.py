"""The student group (``Config.vmap_students``; ``training/students.py``
``_distill_group`` over ``state.make_multi_distill_epoch_fn``) against the
port's own sequential trainer on the CPU: size factors 0.01 and 0.05 floor
to one U-Net and train as one group step, 0.1 trains alone, with dropout
0.3 and the port's draws.  Per-member losses are held at rtol 1e-5 and
weights at rtol 2e-2 / atol 5e-4, JAX's own tolerances for this contract
(``tests/test_training.py::test_vmapped_group_matches_sequential``): each
member runs the sequential step's arithmetic on its row of the stacked
weights, so on the CPU the two agree far inside them.  Also: the group's
files are the sequential trainer's, stacking round-trips, and the lanes
that must not group do not.  ``test_torch_student_group_jax.py`` holds the
group against the JAX trainer.
"""

import json
import os

import numpy as np
import pytest
import torch

from distillation_trajectories_torch.diffusion import get_diffusion_params
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.training import save_checkpoint
from distillation_trajectories_torch.training import state as port_state
from distillation_trajectories_torch.training import students as port_students
from torch_parity import configs, tmp_path  # tmp_path: each test's outputs removed when it ends

torch.set_num_threads(2)
SFS = [0.01, 0.05, 0.1]


class _Groups:
    """Records the size-factor groups ``train_students`` hands to
    ``_distill_group``."""

    def __init__(self, monkeypatch):
        self.calls, self._run = [], port_students._distill_group
        monkeypatch.setattr(port_students, "_distill_group", self)

    def __call__(self, teacher, config, size_factors, *args, **kwargs):
        self.calls.append(list(size_factors))
        return self._run(teacher, config, size_factors, *args, **kwargs)


def _tree(root, **kw):
    cfg = configs(root, dropout=0.3, **kw)[1]
    save_checkpoint(cfg.teacher_models_dir, 1, make_unet(cfg, 1.0, device="cpu", seed=7))
    return cfg


def _losses(cfg, sf):
    with open(os.path.join(cfg.results_dir, f"distill_metrics_size_{sf}.jsonl")) as f:
        return [json.loads(line)["avg_loss"] for line in f]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_group_matches_sequential_trainer(tmp_path, monkeypatch):
    kw = dict(epochs=2, limit_batches_per_epoch=2, num_samples_to_generate=4, samples_grid_size=2)
    group_cfg, seq_cfg = _tree(tmp_path / "group", **kw), _tree(tmp_path / "seq", vmap_students=False,
                                                                 **kw)
    groups = _Groups(monkeypatch)
    grouped = port_students.train_students(group_cfg, custom_size_factors=SFS, seed=0)
    assert groups.calls == [[0.01, 0.05]]
    seq = port_students.train_students(seq_cfg, custom_size_factors=SFS, seed=0)
    assert groups.calls == [[0.01, 0.05]]  # vmap_students=False trains each alone
    worst = 0.0
    for sf in SFS:
        np.testing.assert_allclose(_losses(group_cfg, sf), _losses(seq_cfg, sf), rtol=1e-5,
                                   err_msg=f"sf={sf}")
        want = seq[sf].state_dict()
        for k, v in grouped[sf].state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=2e-2, atol=5e-4, msg=f"sf={sf} {k}")
            worst = max(worst, float((v.double() - want[k].double()).abs().max()))
    print(f"worst state difference group against sequential: {worst}")
    assert _files(group_cfg.output_dir) == _files(seq_cfg.output_dir)
    for sf in SFS:
        with open(os.path.join(group_cfg.results_dir, f"distill_metrics_size_{sf}.jsonl")) as f:
            assert [sorted(json.loads(line)) for line in f] == \
                [["avg_loss", "epoch", "event", "seconds", "size_factor", "time"]] * 2


@pytest.mark.parametrize("override, env", [
    (dict(vmap_students=False), "1"),
    (dict(epoch_scan=False), "1"),
    (dict(), "0"),
    (dict(), "1"),
])
def test_lanes_that_group(tmp_path, monkeypatch, override, env):
    """The group needs the epoch lane and ``vmap_students``."""
    monkeypatch.setenv("DTT_EPOCH_SCAN", env)
    cfg = _tree(tmp_path, epochs=1, limit_batches_per_epoch=1, num_samples_to_generate=0,
                **override)
    groups = _Groups(monkeypatch)
    out = port_students.train_students(cfg, custom_size_factors=SFS, seed=0)
    assert sorted(out) == SFS
    grouped = not override and env == "1"
    assert groups.calls == ([[0.01, 0.05]] if grouped else [])


def test_architecture_groups():
    cfg = configs()[1]
    assert port_students._architecture_groups(cfg, [0.01, 0.1, 0.05, 0.2, 0.02]) == \
        [[0.01, 0.05, 0.02]]
    assert port_students._architecture_groups(cfg, [0.1, 0.2]) == []


def test_stack_and_unstack_round_trip():
    cfg = configs()[1]
    states = []
    images = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 16, 16, 1))
                              .astype(np.float32))
    for sf, seed in ((0.01, 1), (0.05, 2)):
        state = port_state.create_train_state(make_unet(cfg, sf, device="cpu", seed=seed), cfg,
                                              port_state.TorchDraws(seed, "cpu"))
        port_state.make_teacher_train_step(get_diffusion_params(10), 10)(state, images)
        states.append(state)
    want = [({k: v.clone() for k, v in s.model.state_dict().items()},
             {n: {k: v.clone() for k, v in s.optimizer.state[p].items()}
              for n, p in s.model.named_parameters()}) for s in states]
    stacked = port_state.stack_train_states(states)
    assert stacked.params["enc1.conv1.weight"].shape[0] == 2 and stacked.step == 1
    for name, p in stacked.params.items():
        member = states[0].model.get_parameter(name)
        assert p[0].stride() == member.stride(), name  # rows keep the members' layout
    for s in states:  # scribble over the members, then read them back from the stack
        with torch.no_grad():
            for v in s.model.state_dict().values():
                v.zero_()
        s.optimizer.state.clear()
    for i in range(2):
        member = port_state.unstack_train_state(stacked, i)
        for k, v in member.model.state_dict().items():
            assert torch.equal(v, want[i][0][k]), k
        for n, p in member.model.named_parameters():
            for k, v in member.optimizer.state[p].items():
                assert torch.equal(v, want[i][1][n][k]), (n, k)
