"""Port parity: checkpoints in both directions — a file the port writes
loads in the JAX package (weights, BatchNorm statistics, Adam state, EMA)
and a JAX-written file resumes in the port with its optimizer state — and
the async writer's error and snapshot contracts."""

import os
import time

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import checkpoints as jax_ckpt
from distillation_trajectories_tpu.training import state as jax_state
from distillation_trajectories_torch.models import (
    load_optax_adam_state,
    load_unet_variables,
    make_unet,
    optax_adam_state,
    unet_state_dict_from_variables,
)
from distillation_trajectories_torch.training import checkpoints
from distillation_trajectories_torch.training.state import create_train_state
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    as_torch,
    configs,
    numpy_tree,
    port_model,
    tmp_path,
)

torch.set_num_threads(2)


def _trained_port_state(tcfg, steps=2):
    """A port sf-0.1 model after ``steps`` Adam steps, with EMA weights."""
    model = make_unet(tcfg, size_factor=0.1, device="cpu", seed=5)
    state = create_train_state(model, tcfg, draws=None, use_ema=True)
    x = torch.randn((4, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    for _ in range(steps):
        model.train()
        loss = model(x, torch.tensor([1, 2, 3, 4]), torch.ones(4, 1), torch.ones(4, 1)).square().mean()
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
    state.ema = {k: p.detach() * 0.5 for k, p in model.named_parameters()}
    return model.eval(), state


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_layout_matches_a_jax_written_checkpoint(tmp_path):
    """The port's payload has the JAX payload's trees, leaf for leaf (shape
    and dtype), Adam's optax layout included."""
    jcfg, tcfg = configs()
    jmodel = jax_make_unet(jcfg, size_factor=0.1)
    variables = jax_init_unet(jmodel, jcfg, jax.random.PRNGKey(0))
    tx = jax_state.make_optimizer(jcfg)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 1, variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]),
                             ema_params=variables["params"], extra={"note": "x"})
    model, state = _trained_port_state(tcfg, steps=0)
    checkpoints.save_checkpoint(str(tmp_path / "port"), 1, model, state.optimizer,
                                ema=state.ema, extra={"note": "x"})
    want = checkpoints.load_checkpoint(str(tmp_path / "jax"))
    got = checkpoints.load_checkpoint(str(tmp_path / "port"))
    assert set(got) == set(want) == {"epoch", "params", "batch_stats", "opt_state",
                                     "ema_params", "extra"}
    assert got["opt_state"]["1"] == want["opt_state"]["1"] == {}
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for path, w in _leaves(want).items():
        g = _leaves(got)[path]
        assert np.shape(g) == np.shape(w) and np.asarray(g).dtype == np.asarray(w).dtype, path
    assert int(got["opt_state"]["0"]["count"]) == 0


def test_jax_reads_a_port_checkpoint(tmp_path):
    jcfg, tcfg = configs()
    model, state = _trained_port_state(tcfg)
    directory = str(tmp_path / "ckpt")
    path = checkpoints.save_checkpoint(directory, 3, model, state.optimizer, ema=state.ema,
                                       extra={"note": "x"})
    assert path == os.path.join(directory, "model_epoch_3.msgpack")
    assert not os.path.exists(path + ".tmp")
    payload = jax_ckpt.load_checkpoint(directory)
    assert payload["epoch"] == 3 and payload["extra"] == {"note": "x"}
    jmodel = jax_make_unet(jcfg, size_factor=0.1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 16, 16, 1)).astype(np.float32)
    t = np.array([0.0, 4.0, 9.0], np.float32)
    cond = np.array([[0.0], [1.0], [1.0]], np.float32)
    mask = np.array([[0.0], [1.0], [1.0]], np.float32)
    want = jmodel.apply(jax_ckpt.variables_from_checkpoint(payload), x, t, cond, mask, train=False)
    with torch.no_grad():
        got = model(*(as_torch(a) for a in (x, t, cond, mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # The Adam state restores into optax's structure with the port's moments.
    variables = jax_init_unet(jmodel, jcfg, jax.random.PRNGKey(0))
    target = jax_state.create_train_state(jmodel, variables, jax_state.make_optimizer(jcfg))
    opt = serialization.from_state_dict(target.opt_state, payload["opt_state"])
    assert int(opt[0].count) == 2
    mu = unet_state_dict_from_variables({"params": numpy_tree(opt[0].mu)})
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(mu[name].numpy(), state.optimizer.state[p]["exp_avg"].numpy())
    ema = unet_state_dict_from_variables({"params": payload["ema_params"]})
    for name, value in state.ema.items():
        np.testing.assert_array_equal(ema[name].numpy(), value.numpy())


def test_port_resumes_a_jax_checkpoint_with_its_optimizer_state(tmp_path):
    """Adam state from a JAX file: one more equal-gradient step in the port
    lands where optax's does (tolerances of test_torch_train_step's Adam
    test)."""
    jcfg, tcfg = configs()
    jmodel = jax_make_unet(jcfg, size_factor=0.1)
    variables = numpy_tree(jax_init_unet(jmodel, jcfg, jax.random.PRNGKey(0)))
    tx = jax_state.make_optimizer(jcfg)
    rng = np.random.default_rng(1)
    grad = lambda: jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 1e-3, variables["params"])
    params, opt = variables["params"], tx.init(variables["params"])
    updates, opt = tx.update(grad(), opt, params)
    params = numpy_tree(optax.apply_updates(params, updates))
    directory = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(directory, 1, params, batch_stats=variables["batch_stats"],
                             opt_state=opt)

    payload = checkpoints.load_checkpoint(directory, 1)
    model = port_model(tcfg, 0.1, checkpoints.variables_from_checkpoint(payload))
    state = create_train_state(model, tcfg, draws=None)
    load_optax_adam_state(model, state.optimizer, payload["opt_state"])
    g2 = grad()
    updates, opt = tx.update(g2, opt, params)
    params = numpy_tree(optax.apply_updates(params, updates))
    torch_g2 = unet_state_dict_from_variables({"params": g2})
    for name, p in model.named_parameters():
        p.grad = torch_g2[name].to(p)
    state.optimizer.step()
    want = unet_state_dict_from_variables({"params": params})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=2e-9,
                                   err_msg=name)
    assert int(optax_adam_state(model.named_parameters(), state.optimizer.state)["0"]["count"]) == 2


def test_async_writer_snapshots_before_the_next_update(tmp_path):
    _, tcfg = configs()
    model, state = _trained_port_state(tcfg)
    expected = {k: v.clone() for k, v in model.state_dict().items()}
    writer = checkpoints.AsyncCheckpointWriter()
    directory = str(tmp_path / "async")
    writer.save(directory, 1, model, state.optimizer)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)  # the next step updates in place at once
    writer.close()
    restored = make_unet(tcfg, size_factor=0.1, device="cpu")
    load_unet_variables(restored, checkpoints.variables_from_checkpoint(
        checkpoints.load_checkpoint(directory, 1)))
    for k, v in restored.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, expected[k]), k


def test_async_writer_surfaces_failures(tmp_path):
    _, tcfg = configs()
    model, _ = _trained_port_state(tcfg, steps=0)
    blocked = tmp_path / "blocked"
    blocked.write_text("a file, not a directory")
    writer = checkpoints.AsyncCheckpointWriter()
    writer.save(str(blocked), 1, model)
    for _ in range(200):  # let the background write fail
        if writer._futures[0].done():
            break
        time.sleep(0.05)
    with pytest.raises(OSError):
        writer.save(str(tmp_path / "ok"), 2, model)  # the earlier failure surfaces
    writer.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        writer.close()
    assert writer._pool._shutdown
    healthy = checkpoints.AsyncCheckpointWriter()
    healthy.save(str(tmp_path / "healthy"), 1, model)
    healthy.save(str(tmp_path / "healthy"), 2, model)
    healthy.close()
    assert checkpoints.available_epochs(str(tmp_path / "healthy")) == [1, 2]
