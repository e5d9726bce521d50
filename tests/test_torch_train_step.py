"""Port parity: one teacher step and one distillation step against the JAX
steps on the same weights, batch and draws (losses, then gradients, then
BatchNorm statistics), Adam from equal gradients against optax, and EMA.

Conv biases that feed a BatchNorm have a true gradient of zero: both
frameworks give rounding noise there, so those are held to |g| < 1e-6 in
both rather than to each other, and params after an Adam step (which turns
that noise into steps of up to ±lr) are not compared.  Other gradients are
held at rtol 1e-4 with an atol of 5e-5 of the tensor's largest |g| (at
least 1e-7): the gap to JAX is 1e-6 to 1.3e-5 of that largest value, two
to three times the port's own difference between 1 and 8 CPU threads, so
an absolute 1e-7 alone would fail only on rounding in small elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion.process import q_sample as jax_q_sample
from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import state as jax_state
from distillation_trajectories_torch.diffusion import get_diffusion_params
from distillation_trajectories_torch.models import (
    optax_adam_state,
    unet_state_dict_from_variables,
    variables_from_unet_state_dict,
)
from distillation_trajectories_torch.training.state import (
    TorchDraws,
    create_train_state,
    make_distill_train_step,
    make_eval_model_fn,
    make_teacher_train_step,
)
from torch_parity import as_torch, configs, distill_draws, numpy_tree, port_model, teacher_draws

torch.set_num_threads(2)
T, B = 10, 8
SHAPE = (B, 16, 16, 1)


def _images(seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, SHAPE).astype(np.float32)


def _jax_model(jcfg, size_factor, seed):
    model = jax_make_unet(jcfg, size_factor=size_factor)
    return model, numpy_tree(jax_init_unet(model, jcfg, jax.random.PRNGKey(seed)))


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


def _check_batch_stats(model, jax_batch_stats):
    got = variables_from_unet_state_dict(model.state_dict())["batch_stats"]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(numpy_tree(jax_batch_stats)),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(path))


def test_teacher_step_matches_jax():
    jcfg, tcfg = configs()
    jmodel, variables = _jax_model(jcfg, 0.1, 0)
    dp, images, key = jax_params(T), _images(), jax.random.PRNGKey(1)
    ones, zeros = jnp.ones((B, 1)), jnp.zeros((B, 1))
    kt, kn1, kn2, kd1, kd2 = jax.random.split(key, 5)
    t = jax.random.randint(kt, (B,), 0, T)

    def loss_fn(params):  # the body of JAX state.py:169-179
        bs = variables["batch_stats"]
        x1, n1 = jax_q_sample(images, t, dp, kn1)
        p1, bs = jax_state._train_apply(jmodel, params, bs, x1, t, ones, ones, kd1)
        x2, n2 = jax_q_sample(images, t, dp, kn2)
        p2, bs = jax_state._train_apply(jmodel, params, bs, x2, t, zeros, zeros, kd2)
        return (jnp.mean((p1 - n1) ** 2) + jnp.mean((p2 - n2) ** 2)) / 2.0, bs

    _, grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tx = jax_state.make_optimizer(jcfg)
    jstep = jax_state.make_teacher_train_step(jmodel, tx, dp, T)
    new_state, want_loss = jstep(jax_state.create_train_state(jmodel, variables, tx), images, key)

    model = port_model(tcfg, 0.1, variables)
    state = create_train_state(model, tcfg, draws=None)
    step = make_teacher_train_step(get_diffusion_params(T), T)
    state, loss = step(state, as_torch(images), teacher_draws(key, SHAPE, T))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _check_grads(model, grads)
    _check_batch_stats(model, new_state.batch_stats)
    assert state.step == 1


def test_distill_step_matches_jax():
    jcfg, tcfg = configs()
    teacher, tvars = _jax_model(jcfg, 0.2, 0)
    student, svars = _jax_model(jcfg, 0.1, 1)
    S = T // 2  # t_student = floor(t * S / T) is exercised
    dp, images, key = jax_params(T), _images(1), jax.random.PRNGKey(2)
    ones, zeros = jnp.ones((B, 1)), jnp.zeros((B, 1))
    kt, kn, kd1, kd2 = jax.random.split(key, 4)
    t_teacher = jax.random.randint(kt, (B,), 0, T)
    t_student = jnp.floor(t_teacher * (S / T)).astype(jnp.int32)

    def loss_fn(params):  # the body of JAX state.py:341-363
        teacher_fn = jax_state.make_eval_model_fn(teacher, tvars)
        x_noisy, _ = jax_q_sample(images, t_teacher, dp, kn)
        tc = teacher_fn(x_noisy, t_teacher, ones, ones)
        tu = teacher_fn(x_noisy, t_teacher, zeros, zeros)
        bs = svars["batch_stats"]
        sc, bs = jax_state._train_apply(student, params, bs, x_noisy, t_student, ones, ones, kd1)
        su, bs = jax_state._train_apply(student, params, bs, x_noisy, t_student, zeros, zeros, kd2)
        return (jnp.mean((sc - tc) ** 2) + jnp.mean((su - tu) ** 2)) / 2.0, bs

    _, grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(svars["params"])
    tx = jax_state.make_optimizer(jcfg)
    jstep = jax_state.make_distill_train_step(teacher, tvars, student, tx, dp, T, S)
    new_state, want_loss = jstep(jax_state.create_train_state(student, svars, tx), images, key)

    model = port_model(tcfg, 0.1, svars)
    state = create_train_state(model, tcfg, draws=None)
    step = make_distill_train_step(port_model(tcfg, 0.2, tvars), get_diffusion_params(T), T, S)
    state, loss = step(state, as_torch(images), distill_draws(key, SHAPE, T))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _check_grads(model, grads)
    _check_batch_stats(model, new_state.batch_stats)


def test_adam_from_equal_gradients_matches_optax():
    """torch.optim.Adam against optax.adam over two steps of the same
    gradients.  torch computes the bias correction in float64 and optax in
    float32, so an update differs by up to ~1e-5 of itself (≤ lr·1e-5
    absolute): params are held at rtol 1e-6 with an atol of 2e-9."""
    jcfg, tcfg = configs()
    _, variables = _jax_model(jcfg, 0.1, 0)
    rng = np.random.default_rng(0)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.integers(-6, 0)).astype(np.float32),
        variables["params"]) for _ in range(2)]
    tx = jax_state.make_optimizer(jcfg)
    params, opt = variables["params"], tx.init(variables["params"])
    model = port_model(tcfg, 0.1, variables)
    state = create_train_state(model, tcfg, draws=None)
    for g in grads:
        updates, opt = tx.update(g, opt, params)
        params = numpy_tree(optax.apply_updates(params, updates))
        torch_g = unet_state_dict_from_variables({"params": g})
        for name, p in model.named_parameters():
            p.grad = torch_g[name].to(p)
        state.optimizer.step()
    want = unet_state_dict_from_variables({"params": params})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=2e-9,
                                   err_msg=name)
    got = optax_adam_state(model.named_parameters(), state.optimizer.state)
    assert int(got["0"]["count"]) == int(opt[0].count) == 2 and got["1"] == {}
    for moment in ("mu", "nu"):
        for (path, w), g in zip(
                jax.tree_util.tree_leaves_with_path(numpy_tree(getattr(opt[0], moment))),
                jax.tree_util.tree_leaves(got["0"][moment])):
            # torch's lerp and optax's weighted sum round apart where the
            # two steps' gradients cancel: atol 1e-6 of the largest moment.
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=f"{moment} {path}")


def test_ema_and_default_draws():
    _, tcfg = configs(dropout=0.3)
    images = as_torch(_images(2))
    step = make_teacher_train_step(get_diffusion_params(T), T, ema_rate=0.9)

    def run(seed):
        draws = TorchDraws(seed, "cpu")
        state = create_train_state(draws.init_unet(tcfg, 0.1), tcfg, draws, use_ema=True)
        p0 = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        state, loss = step(state, images)
        return state, p0, float(loss)

    state, p0, loss = run(3)
    for k, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema[k], 0.9 * p0[k] + 0.1 * p.detach(),
                                   rtol=1e-5, atol=1e-7)
    assert run(3)[2] == loss and run(4)[2] != loss  # seeded, replayable draws
    x, t = images[:2], torch.tensor([1, 5])
    ema_out = make_eval_model_fn(state.model, state.ema)(x, t)
    own_out = make_eval_model_fn(state.model)(x, t)
    assert ema_out.shape == own_out.shape and not torch.equal(ema_out, own_out)
