"""Port parity for the epoch lane (``training/state.py``'s
``make_teacher_epoch_fn`` / ``make_distill_epoch_fn`` and
``loop.run_train_epoch(use_scan=True)``) on the CPU, at the sizes of JAX
``tests/test_training.py::test_epoch_scan_matches_batch_loop`` (sf 0.2
teacher, sf 0.1 student, 20 images, batch 4, 2 epochs):

* against the JAX epoch functions on the same weights, images, batch
  order and key stream (``torch_parity.JaxDraws``; dropout 0, since JAX's
  masks cannot be replayed), each epoch's mean loss, the first at rtol
  1e-4 and the second at rtol 1e-3 (``torch_parity.check_losses``; within
  an epoch the per-step gap grows from 1e-7 at the first step, as Adam's
  first steps lift rounding noise into the weights);
* against the port's own per-batch loop (dropout 0.3, the port's draws):
  equal losses, weights, BatchNorm statistics and EMA (``torch.equal``),
  since on the CPU both lanes run the same operations;
* ``epoch_scan_enabled`` under ``DTT_EPOCH_SCAN=0`` and with a mesh, and
  ``train_teacher`` taking the per-batch loop when asked.

``test_torch_epoch_lane_trainers.py`` runs the trainers on the default lane
against JAX's.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.data.datasets import DataLoader as JaxLoader
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import state as jax_state
from distillation_trajectories_torch.data.datasets import DataLoader
from distillation_trajectories_torch.diffusion import get_diffusion_params
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.training import loop as port_loop
from distillation_trajectories_torch.training import state as port_state
from distillation_trajectories_torch.training import teacher as port_teacher
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    JaxDraws,
    check_losses,
    configs,
    numpy_tree,
    port_model,
    tmp_path,
)

torch.set_num_threads(2)
N, B, EPOCHS, T = 20, 4, 2, 10


def _data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N, 16, 16, 1)).astype(np.float32), np.zeros(N, np.int32))


def _jax_epochs(epoch_fn, state, images, labels, seed, key_seed):
    loader, key, out = JaxLoader(images, labels, B, shuffle=True, seed=seed), \
        jax.random.PRNGKey(key_seed), []
    for _ in range(EPOCHS):
        state, key, losses = epoch_fn(state, jnp.asarray(images), loader.epoch_indices(), key)
        out.append(np.asarray(losses))
    return out


def _port_epochs(state, epoch_fn, images, labels, seed, cfg, lane):
    """``EPOCHS`` epochs through ``run_train_epoch``: the epoch lane when
    ``lane == "scan"``, else the per-batch loop of ``epoch_fn``'s step."""
    loader, out = DataLoader(images, labels, B, shuffle=True, seed=seed), []
    for _ in range(EPOCHS):
        state, losses, n = port_loop.run_train_epoch(
            state, train_step=epoch_fn if lane == "loop" else None, loader=loader, config=cfg,
            device="cpu", progress_desc="", log_label="", log_every=0, use_scan=lane == "scan",
            epoch_fn=epoch_fn, dataset_dev=torch.from_numpy(images), reduce_loss=False)
        assert n == N // B
        out.append(losses)
    return out


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    teacher, student = jax_make_unet(jcfg, 0.2), jax_make_unet(jcfg, 0.1)
    return (jcfg, tcfg, (teacher, numpy_tree(jax_init_unet(teacher, jcfg, jax.random.PRNGKey(0)))),
            (student, numpy_tree(jax_init_unet(student, jcfg, jax.random.PRNGKey(1)))))


@pytest.mark.parametrize("family", ["teacher", "distill"])
def test_epoch_fns_match_jax(models, family):
    jcfg, tcfg, (jteacher, tvars), (jstudent, svars) = models
    images, labels = _data()
    tx = jax_state.make_optimizer(jcfg)
    if family == "teacher":
        jax_fn = jax_state.make_teacher_epoch_fn(jteacher, tx, jax_params(T, jcfg), T)
        port_fn = port_state.make_teacher_epoch_fn(get_diffusion_params(T, tcfg), T)
        jmodel, jvars, sf, seed, key_seed = jteacher, tvars, 0.2, 3, 9
    else:
        jax_fn = jax_state.make_distill_epoch_fn(jteacher, tvars, jstudent, tx,
                                                 jax_params(T, jcfg), T, T // 2)
        port_fn = port_state.make_distill_epoch_fn(port_model(tcfg, 0.2, tvars),
                                                   get_diffusion_params(T, tcfg), T, T // 2)
        jmodel, jvars, sf, seed, key_seed = jstudent, svars, 0.1, 7, 5
    want = _jax_epochs(jax_fn, jax_state.create_train_state(jmodel, jvars, tx), images, labels,
                       seed, key_seed)
    state = port_state.create_train_state(port_model(tcfg, sf, jvars), tcfg,
                                          JaxDraws(jcfg, key_seed, "cpu"))
    got = _port_epochs(state, port_fn, images, labels, seed, tcfg, "scan")
    print("per-step losses, port:", got, "JAX:", want)
    check_losses([np.mean(g) for g in got], [np.mean(w) for w in want])
    assert state.step == EPOCHS * (N // B)


def _own_run(tcfg, family, lane):
    images, labels = _data()
    dp = get_diffusion_params(T, tcfg)
    if family == "teacher":
        model, factory = make_unet(tcfg, 0.2, device="cpu", seed=3), (
            port_state.make_teacher_epoch_fn if lane == "scan" else port_state.make_teacher_train_step)
        fn = factory(dp, T, ema_rate=0.999)
    else:
        model = make_unet(tcfg, 0.1, device="cpu", seed=4)
        factory = port_state.make_distill_epoch_fn if lane == "scan" else \
            port_state.make_distill_train_step
        fn = factory(make_unet(tcfg, 0.2, device="cpu", seed=3), dp, T, T // 2)
    state = port_state.create_train_state(model, tcfg, port_state.TorchDraws(11, "cpu"),
                                          use_ema=family == "teacher")
    return _port_epochs(state, fn, images, labels, 7, tcfg, lane), state


@pytest.mark.parametrize("family", ["teacher", "distill"])
def test_epoch_lane_equals_per_batch_loop(family):
    tcfg = configs(dropout=0.3)[1]
    (scan, s_state), (loop, l_state) = _own_run(tcfg, family, "scan"), _own_run(tcfg, family, "loop")
    assert all(np.array_equal(a, b) for a, b in zip(scan, loop))
    assert s_state.step == l_state.step == EPOCHS * (N // B)
    for (k, a), b in zip(s_state.model.state_dict().items(), l_state.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k, a in (s_state.ema or {}).items():
        assert torch.equal(a, l_state.ema[k]), k
    # The draw sources stand at the same place.
    assert torch.equal(s_state.draws.generator.get_state(), l_state.draws.generator.get_state())


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


def test_epoch_scan_enabled(monkeypatch):
    tcfg = configs()[1]
    monkeypatch.delenv("DTT_EPOCH_SCAN", raising=False)
    assert port_state.epoch_scan_enabled(tcfg, None)
    assert not port_state.epoch_scan_enabled(tcfg, mesh=object())
    monkeypatch.setenv("DTT_EPOCH_SCAN", "0")
    assert not port_state.epoch_scan_enabled(tcfg, None)
    monkeypatch.setenv("DTT_EPOCH_SCAN", "1")
    tcfg.epoch_scan = False
    assert not port_state.epoch_scan_enabled(tcfg, None)
    for cfg, env in ((configs()[0], "1"), (configs()[0], "0")):
        monkeypatch.setenv("DTT_EPOCH_SCAN", env)
        assert jax_state.epoch_scan_enabled(cfg, None) == port_state.epoch_scan_enabled(
            configs()[1], None)


def test_train_teacher_takes_the_per_batch_loop_when_asked(tmp_path, monkeypatch):
    """``DTT_EPOCH_SCAN=0`` and ``epoch_scan=False`` each select the
    per-batch loop; the two lanes write the same records."""
    kw = dict(epochs=1, limit_batches_per_epoch=2, num_samples_to_generate=0, dropout=0.3)
    runs, lanes = {}, _Epochs(monkeypatch, port_teacher)
    for tag, env, scan in (("scan", "1", True), ("env", "0", True), ("cfg", "1", False)):
        monkeypatch.setenv("DTT_EPOCH_SCAN", env)
        tcfg = configs(tmp_path / tag, epoch_scan=scan, **kw)[1]
        lanes.lanes, lanes.losses = [], []
        port_teacher.train_teacher(tcfg, seed=0)
        runs[tag] = (lanes.lanes, lanes.losses)
    assert runs["scan"][0] == ["scan"] and runs["env"][0] == runs["cfg"][0] == ["loop"]
    assert runs["scan"][1] == runs["env"][1] == runs["cfg"][1]


def test_empty_epoch_is_zero_in_both_lanes():
    tcfg = configs(limit_batches_per_epoch=0)[1]
    images, labels = _data()
    for lane in ("scan", "loop"):
        state = port_state.create_train_state(make_unet(tcfg, 0.1, device="cpu"), tcfg,
                                              port_state.TorchDraws(0, "cpu"))
        out = port_loop.run_train_epoch(
            state, train_step=port_state.make_teacher_train_step(get_diffusion_params(T), T),
            loader=DataLoader(images, labels, B), config=tcfg, device="cpu", progress_desc="",
            log_label="", log_every=0, use_scan=lane == "scan",
            epoch_fn=port_state.make_teacher_epoch_fn(get_diffusion_params(T), T),
            dataset_dev=torch.from_numpy(images))
        assert out[1:] == (0.0, 0) and state.step == 0
