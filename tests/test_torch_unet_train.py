"""Port parity: the U-Net's train mode (flax BatchNorm statistics, two
chained forwards) against flax ``apply(train=True,
mutable=["batch_stats"])``, dropout semantics, and the exact port → JAX →
port variable round trip."""

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.models import make_init_fn
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_torch.models import (
    make_unet,
    unet_state_dict_from_variables,
    variables_from_unet_state_dict,
)
from distillation_trajectories_torch.models.unet import BatchNorm2d
from torch_parity import as_torch, configs, numpy_tree, port_model

torch.set_num_threads(2)

VARIANTS = {
    "sf0.1": (0.1, {}),
    "sf1.0": (1.0, {}),  # 16x16 reaches a 1x1 bottleneck
    "sf0.1-fullres-group": (0.1, dict(full_res_head=True, norm="group")),
}


_SETUPS = {}


def _setup(name):
    """(flax model, numpy variables, port Config, size factor), once per
    variant and module."""
    if name not in _SETUPS:
        size_factor, kw = VARIANTS[name]
        jcfg, tcfg = configs(**kw)
        jmodel = jax_make_unet(jcfg, size_factor=size_factor)
        variables = make_init_fn(jmodel, jcfg, force_jit=True)(jax.random.PRNGKey(1))
        _SETUPS[name] = (jmodel, numpy_tree(variables), tcfg, size_factor)
    return _SETUPS[name]


def _inputs(seed, b=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 16, 16, 1)).astype(np.float32)
    t = rng.integers(0, 10, b).astype(np.int32)
    cond = (np.arange(b) % 2).astype(np.float32)[:, None]
    mask = np.ones((b, 1), np.float32)
    return x, t, cond, mask


@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_forward_and_batch_stats_match_flax(name):
    jmodel, variables, tcfg, size_factor = _setup(name)
    apply = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=True, mutable=["batch_stats"]))
    model = port_model(tcfg, size_factor, variables).train()
    jvars = dict(variables)
    for seed in (0, 1):  # two chained forwards, as in a train step
        inputs = _inputs(seed)
        want, mutated = apply(jvars, *inputs)
        jvars = {**jvars, **numpy_tree(mutated)}
        got = model(*(as_torch(a) for a in inputs))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    state = variables_from_unet_state_dict(model.state_dict())
    assert jax.tree_util.tree_structure(state["batch_stats"]) == \
        jax.tree_util.tree_structure(jvars.get("batch_stats", {}))
    # rtol 1e-5; the atol covers running means near zero, whose error is
    # the forward's rounding (~1e-7 of activations of order 1).
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jvars.get("batch_stats", {})),
                            jax.tree_util.tree_leaves(state["batch_stats"])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(path))
    if VARIANTS[name][1].get("norm") != "group":
        assert state["batch_stats"]  # the statistics did move and were compared
        assert not np.allclose(state["batch_stats"]["enc1"]["norm1"]["var"], 1.0)


def test_running_var_is_biased_where_torch_is_not():
    """The trap flax and torch differ on: torch's BatchNorm2d updates
    running_var with the unbiased batch variance, flax (and the port) with
    the biased one; both normalize with the biased one."""
    x = torch.randn(2, 3, 2, 1, generator=torch.Generator().manual_seed(0))
    ours, theirs = BatchNorm2d(3).train(), torch.nn.BatchNorm2d(3).train()
    torch.testing.assert_close(ours(x), theirs(x))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(theirs.running_var, 0.9 + 0.1 * var * 4 / 3)
    torch.testing.assert_close(ours.running_mean, theirs.running_mean)
    assert int(ours.num_batches_tracked) == 1


def test_dropout_semantics():
    _, tcfg = configs(dropout=0.5)
    _, no_drop_cfg = configs(dropout=0.0)
    model = make_unet(tcfg, size_factor=0.1, device="cpu", seed=2)
    plain = make_unet(no_drop_cfg, size_factor=0.1, device="cpu", seed=2)
    inputs = [as_torch(a) for a in _inputs(3)]
    gen = lambda: torch.Generator().manual_seed(4)
    # Eval mode: no dropout, the output of a model built with rate 0.
    with torch.no_grad():
        torch.testing.assert_close(model.eval()(*inputs, generator=gen()),
                                   plain.eval()(*inputs), rtol=0, atol=0)
    model.train()
    h = torch.ones(8, 16, 4, 4)
    out = model._dropout(h, torch.Generator().manual_seed(0))
    assert set(out.unique().tolist()) == {0.0, 2.0}  # kept units scaled by 1/(1-p)
    assert 0.35 < (out == 0).float().mean() < 0.65
    assert torch.equal(out, model._dropout(h, torch.Generator().manual_seed(0)))
    # The generator replays a whole train forward's masks.
    first = model(*inputs, generator=gen())
    assert torch.equal(first, model(*inputs, generator=gen()))
    assert not torch.equal(first, model(*inputs, generator=torch.Generator().manual_seed(5)))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variables_round_trip_exactly(name):
    _, variables, tcfg, size_factor = _setup(name)
    state = unet_state_dict_from_variables(variables)
    back = variables_from_unet_state_dict(state)
    flat = lambda tree: dict(jax.tree_util.tree_leaves_with_path(tree))
    want = flat({"params": variables["params"], "batch_stats": variables.get("batch_stats", {})})
    got = flat(back)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    again = unet_state_dict_from_variables(back)
    assert set(again) == set(state)
    for k, v in state.items():
        assert torch.equal(again[k], v), k


def test_bf16_train_forward_runs_near_float32():
    _, f32_cfg = configs()
    _, bf16_cfg = configs(compute_dtype="bfloat16")
    inputs = [as_torch(a) for a in _inputs(5)]
    outs = []
    for cfg in (f32_cfg, bf16_cfg):
        model = make_unet(cfg, size_factor=0.1, device="cpu", seed=7).train()
        out = model(*inputs)
        out.square().mean().backward()
        outs.append(out.detach())
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
        assert model.enc1.norm1.running_var.dtype == torch.float32
    err = (outs[1] - outs[0]).abs().max() / outs[0].abs().max()
    assert err < 5e-2
