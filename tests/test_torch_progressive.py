"""The port's progressive step-halving distillation against the JAX
package's on the CPU (sf 0.1, 16x16x1, batch 8, teacher T=8 → S=4,
float32, dropout 0), the port's seeded weights carried into JAX and JAX's
key stream replayed into the port (``torch_parity.JaxDraws``):

- ``_engine_c`` against JAX's;
- the train step, plain, guided and ``teacher_guided``, against
  ``make_progressive_distill_step(...)(t_vars)`` over two steps, the second
  from JAX's weights after the first: losses at rtol 1e-5, gradients at rtol 1e-4 with an atol of 5e-5 of each tensor's
  largest |g| (conv biases that feed a BatchNorm, whose true gradient is
  zero, below 1e-6 in both), BatchNorm statistics at rtol 1e-5.  JAX's
  gradients are read from Adam's first moment (``mu = 0.1·g`` after one
  step, ``0.1·g₂ + 0.9·mu₁`` after two);
- ``make_guided_eval_fn``: a direct ``cond=w`` call, not the (0, 0) path;
- one round of ``progressive_distill`` end to end, plain and guided (2
  batches, 1 epoch; the port's round on its epoch lane, JAX's on its
  per-batch loop of the jitted step, so the lane's batch order is JAX's):
  the epoch's loss at rtol 1e-4, the ``steps_4``
  checkpoint read by JAX's ``load_checkpoint`` equal to the returned model;
- the ``train_progressive`` CLI on the CPU, and the lanes that raise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.data import datasets as jax_datasets
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import checkpoints as jax_ckpt
from distillation_trajectories_tpu.training import progressive as jax_progressive
from distillation_trajectories_tpu.training import state as jax_state
from distillation_trajectories_torch.diffusion import get_diffusion_params
from distillation_trajectories_torch.models import (
    load_unet_variables,
    make_unet,
    unet_state_dict_from_variables,
    variables_from_unet_state_dict,
)
from distillation_trajectories_torch.scripts import train_progressive
from distillation_trajectories_torch.training import progressive, save_checkpoint
from distillation_trajectories_torch.training.checkpoints import available_epochs, load_checkpoint
from distillation_trajectories_torch.training.state import create_train_state
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    JaxDraws,
    as_torch,
    configs,
    numpy_tree,
    progressive_draws,
    tmp_path,
)

torch.set_num_threads(2)
T, S, B = 8, 4, 8
SHAPE = (B, 16, 16, 1)
FORMS = {"plain": (None, False), "guided": ((1.0, 5.0), False),
         "teacher_guided": ((1.0, 5.0), True)}


def _seeded(tcfg, seed):
    """A port sf-0.1 U-Net and the same weights as JAX variables."""
    model = make_unet(tcfg, size_factor=0.1, seed=seed)
    return model, variables_from_unet_state_dict(model.state_dict())


def _images(seed):
    return np.random.default_rng(seed).uniform(-1, 1, SHAPE).astype(np.float32)


def test_engine_c_matches_jax():
    """``c1`` (a quotient, no cancellation) at rtol 1e-6.  ``c2`` is the
    difference of two terms of 0.05–0.13 whose float32 rounding survives
    the cancellation, so a relative hold on it measures nothing: each
    package's ``c2`` is held to a float64 evaluation from the same float32
    alphas within 4·eps_f32 of the larger term, and the two packages to
    each other within twice that."""
    a = get_diffusion_params(T)["alphas"]
    t = np.arange(2, T)
    (g1, g2) = (x.numpy() for x in progressive._engine_c(
        torch.from_numpy(a[t]), torch.from_numpy(a[t - 1])))
    (w1, w2) = (np.asarray(x) for x in jax_progressive._engine_c(
        jnp.asarray(a[t]), jnp.asarray(a[t - 1])))
    np.testing.assert_allclose(g1, w1, rtol=1e-6)

    at, ap = a[t].astype(np.float64), a[t - 1].astype(np.float64)
    first, second = np.sqrt(1.0 - ap), np.sqrt(ap / at) * np.sqrt(1.0 - at)
    exact = first - second
    atol = 4 * np.finfo(np.float32).eps * np.maximum(np.abs(first), np.abs(second))
    for name, c2 in (("port", g2), ("jax", w2)):
        assert np.all(np.abs(c2 - exact) <= atol), (name, np.abs(c2 - exact) / atol)
    assert np.all(np.abs(g2 - w2) <= 2 * atol), np.abs(g2 - w2) / atol


def _check_grads(model, jax_grads):
    want = unet_state_dict_from_variables({"params": numpy_tree(jax_grads)})
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        if k.endswith(("conv1.bias", "conv2.bias")):  # feeds a BatchNorm
            assert float(g.abs().max()) < 1e-6 and float(want[k].abs().max()) < 1e-6, k
        else:
            atol = max(1e-7, 5e-5 * float(want[k].abs().max()))
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=atol, err_msg=k)


@pytest.mark.parametrize("form", list(FORMS))
def test_progressive_step_matches_jax(form):
    guidance_range, teacher_guided = FORMS[form]
    jcfg, tcfg = configs(timesteps=T)
    teacher, tvars = _seeded(tcfg, 9)
    student, svars = _seeded(tcfg, 0)
    dpt, dps = jax_params(T, jcfg), jax_params(S, jcfg)
    jmodel = jax_make_unet(jcfg, size_factor=0.1)
    tx = jax_state.make_optimizer(jcfg)
    jstep = jax_progressive.make_progressive_distill_step(
        jmodel, jmodel, tx, dpt["alphas"], dps["alphas"], T, dpt,
        guidance_range=guidance_range, teacher_guided=teacher_guided)(tvars)
    jstate = jax_state.create_train_state(jmodel, jax.tree_util.tree_map(jnp.copy, svars), tx)

    tpt, tps = get_diffusion_params(T), get_diffusion_params(S)
    step = progressive.make_progressive_distill_step(
        teacher, tpt["alphas"], tps["alphas"], T, tpt,
        guidance_range=guidance_range, teacher_guided=teacher_guided)
    state = create_train_state(student, tcfg, draws=None)

    key, mu = jax.random.PRNGKey(3), None
    for i in range(2):
        key, sk = jax.random.split(key)
        images = _images(i)
        jstate, want_loss = jstep(jstate, images, sk)
        state, loss = step(state, as_torch(images), progressive_draws(sk, SHAPE, S, guidance_range))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, err_msg=f"step {i}")
        new_mu = jax.tree_util.tree_map(np.array, jstate.opt_state[0].mu)  # copies: donated next
        if mu is None:
            grads = jax.tree_util.tree_map(lambda m: m / np.float32(0.1), new_mu)
        else:
            grads = jax.tree_util.tree_map(
                lambda m, p: (m - np.float32(0.9) * p) / np.float32(0.1), new_mu, mu)
        _check_grads(student, grads)
        mu = new_mu
        if i == 0:
            got = variables_from_unet_state_dict(student.state_dict())["batch_stats"]
            for (path, w), g in zip(
                    jax.tree_util.tree_leaves_with_path(numpy_tree(jstate.batch_stats)),
                    jax.tree_util.tree_leaves(got)):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(path))
            # Adam's first step moves every weight by about ±lr whatever the
            # size of its gradient, so the two frameworks' rounding noise
            # reaches the next loss at ~1e-4: step 2 starts from JAX's weights.
            load_unet_variables(student, numpy_tree({"params": jstate.params,
                                                     "batch_stats": jstate.batch_stats}))
    assert state.step == 2


def test_guided_eval_fn_feeds_w():
    _, tcfg = configs(timesteps=T)
    model, _ = _seeded(tcfg, 1)
    x = torch.randn((2, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    t = torch.tensor([3.0, 5.0])
    zeros = torch.zeros((2, 1))
    got = progressive.make_guided_eval_fn(model, 2.5)(x, t, zeros, zeros)
    with torch.no_grad():
        want = model.eval()(x, t, torch.full((2, 1), 2.5), torch.ones((2, 1)))
        plain = model(x, t, zeros, zeros)
    assert torch.equal(got, want) and not torch.allclose(got, plain)
    # The int8 forward (held to JAX's in test_torch_quantized.py) feeds w too.
    got8 = progressive.make_guided_eval_fn(model, 2.5, quant="int8")(x, t, zeros, zeros)
    assert float((got8 - want).norm() / want.norm()) < 0.15


class _LossRecorder:
    """Wraps a package's progressive step maker so every step it makes
    records its loss: JAX's ``make_progressive_distill_step``, and the
    port's ``make_progressive_epoch_fn``, the lane a round runs on one
    device (each epoch's per-step losses)."""

    def __init__(self, monkeypatch, module, name="make_progressive_distill_step"):
        self.losses, self._make = [], getattr(module, name)
        monkeypatch.setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        made = self._make(*args, **kwargs)
        if isinstance(made, type):  # JAX's: a factory of the teacher variables
            return lambda t_vars: self._wrap(made(t_vars))
        return self._wrap(made)

    def _wrap(self, step):
        def recorded(*args):
            state, loss = step(*args)
            self.losses.extend(np.atleast_1d(np.asarray(loss)).tolist())
            return state, loss
        recorded.captured = getattr(step, "captured", None)  # the port's round releases it
        return recorded


@pytest.mark.parametrize("guidance_range", [None, (1.0, 3.0)], ids=["plain", "guided"])
def test_progressive_round_matches_jax(tmp_path, monkeypatch, guidance_range):
    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [])
    kw = dict(timesteps=T, limit_batches_per_epoch=2)
    jcfg, tcfg = configs(tmp_path / "jax", **kw)[0], configs(tmp_path / "port", **kw)[1]
    teacher, tvars = _seeded(tcfg, 5)
    want = _LossRecorder(monkeypatch, jax_progressive)
    got = _LossRecorder(monkeypatch, progressive, "make_progressive_epoch_fn")
    jax_progressive.progressive_distill(jcfg, jax_make_unet(jcfg, size_factor=0.1), tvars,
                                        rounds=1, seed=0, epochs_per_round=1,
                                        guidance_range=guidance_range)
    model, steps = progressive.progressive_distill(
        tcfg, teacher, rounds=1, seed=0, epochs_per_round=1, guidance_range=guidance_range,
        draws=JaxDraws.factory(jcfg))
    assert steps == S and model is not teacher
    assert len(got.losses) == len(want.losses) == 2
    np.testing.assert_allclose(np.mean(got.losses), np.mean(want.losses), rtol=1e-4)

    family = "progressive" if guidance_range is None else "progressive_cfg"
    ckpt_dir = os.path.join(tcfg.models_dir, family, f"steps_{S}")
    assert available_epochs(ckpt_dir) == [1]
    payload = jax_ckpt.load_checkpoint(ckpt_dir)  # JAX reads the port's checkpoint
    assert payload["epoch"] == 1 and int(payload["opt_state"]["0"]["count"]) == 2
    trained = variables_from_unet_state_dict(model.state_dict())
    for tree in ("params", "batch_stats"):
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(trained[tree]),
                                jax.tree_util.tree_leaves(payload[tree])):
            assert np.array_equal(g, w), (tree, path)
    # The teacher is untouched.
    for k, v in make_unet(tcfg, size_factor=0.1, seed=5).state_dict().items():
        assert torch.equal(v, teacher.state_dict()[k]), k


def test_train_progressive_cli_on_the_cpu(tmp_path, capsys):
    _, tcfg = configs(tmp_path, channels=3)
    save_checkpoint(tcfg.teacher_models_dir, 1, make_unet(tcfg, size_factor=1.0, seed=2))
    flags = ["--dataset", "MNIST", "--image_size", "16", "--batch_size", "4", "--timesteps", "8",
             "--epochs", "1", "--limit_batches", "1", "--base_dir", str(tmp_path), "--device", "cpu"]
    model, steps = train_progressive.main(flags + ["--rounds", "3"])
    assert steps == 2 and "2 steps cannot halve further" in capsys.readouterr().out
    models = os.path.join(tmp_path, "output", "models")
    for n in (4, 2):
        assert available_epochs(os.path.join(models, "progressive", f"steps_{n}")) == [1]
    _, steps = train_progressive.main(flags + ["--rounds", "1", "--guidance_range", "1,3"])
    assert steps == 4
    assert available_epochs(os.path.join(models, "progressive_cfg", "steps_4")) == [1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_progressive.main(flags[:-2])


def test_checkpoint_sharded_raises(tmp_path):
    """``Config.checkpoint_sharded`` sends the progressive rounds'
    checkpoints through the sharded lane: ``model_epoch_1.dcp``, read back
    as the round's student with its Adam state."""
    _, tcfg = configs(tmp_path, checkpoint_sharded=True, limit_batches_per_epoch=1,
                      timesteps=T)
    model, steps = progressive.progressive_distill(tcfg, _seeded(tcfg, 0)[0])
    ckpt_dir = os.path.join(tcfg.models_dir, "progressive", f"steps_{steps}")
    assert os.path.isdir(os.path.join(ckpt_dir, "model_epoch_1.dcp"))
    assert available_epochs(ckpt_dir) == [1]
    payload = load_checkpoint(ckpt_dir, 1)
    want = variables_from_unet_state_dict(model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(payload["params"]),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_array_equal(a, b)
    assert int(payload["opt_state"]["0"]["count"]) == 1
