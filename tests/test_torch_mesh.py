"""The port's ``(data, model)`` mesh (``parallel/mesh.py``,
``parallel/collectives.py``, ``parallel/distributed.py``) against JAX's
``parallel/mesh.py``.

Pure checks first: ``param_spec`` shards the same leaves as JAX's for the
sf-1.0 and sf-0.1 U-Nets at model axes 1, 2 and 4; the mesh guards; and
``initialize_distributed`` without a launcher.  Then one 2-rank ``gloo``
world (``tests/torch_dist.py::mesh_basics``): the guards with ranks, batch
rows and their gather, column parallelism and data-axis BatchNorm against
the unsharded layers (loss and gradients to float rounding: rtol 1e-5),
``gather_state_dict`` of a sharded U-Net, which is the reference state
dict exactly and converts to the JAX variables it came from, and train
steps with dropout on (the masks' draws under sharding).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.parallel import param_spec as jax_param_spec
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.models.convert import _flax_leaf, variables_from_unet_state_dict
from distillation_trajectories_torch.parallel import (
    initialize_distributed,
    mesh_from_config,
    param_spec,
)
from distillation_trajectories_torch.parallel.launch import spawn_ranks

import torch_dist
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    configs,
    port_model,
    tmp_path,
)


def _jax_vars(jcfg, sf, seed=0):
    return jax_init_unet(jax_make_unet(jcfg, size_factor=sf), jcfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("sf", [1.0, 0.1])
def test_param_spec_shards_the_leaves_jax_shards(sf, m):
    jcfg, tcfg = configs()
    shapes = jax.eval_shape(lambda: _jax_vars(jcfg, sf))
    model = make_unet(tcfg, size_factor=sf, device="cpu")
    seen = 0
    for name, t in model.state_dict().items():
        leaf = _flax_leaf(name, t)
        if leaf is None:
            continue
        col, path, _ = leaf
        jleaf = shapes[col]
        for k in path:
            jleaf = jleaf[k]
        jax_sharded = jax_param_spec(jleaf, m) != P()
        assert param_spec(t, m).is_shard() == jax_sharded, (name, m)
        seen += 1
    assert seen == len(jax.tree_util.tree_leaves(shapes))


def test_mesh_from_config_validation(tmp_path):
    _, tcfg = configs(tmp_path)
    assert mesh_from_config(tcfg) is None
    tcfg.mesh_shape = (16, 2)
    with pytest.raises(ValueError, match="devices.*torchrun --nproc_per_node=32"):
        mesh_from_config(tcfg)
    tcfg.mesh_shape = (3, 1)
    with pytest.raises(ValueError, match="needs 3 devices"):
        mesh_from_config(tcfg)


def test_initialize_distributed_noop_without_env(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def ranks():
    jcfg, tcfg = configs()
    sd01 = port_model(tcfg, 0.1, _jax_vars(jcfg, 0.1, seed=4)).state_dict()
    return spawn_ranks(2, torch_dist.mesh_basics, (sd01,), backend="gloo", timeout=300), sd01


def test_mesh_guards_on_two_ranks(ranks):
    for out in ranks[0]:
        assert "needs 4 devices" in out["errors"][(4, 1)]
        assert "torchrun --nproc_per_node=4" in out["errors"][(4, 1)]
        assert "not divisible by data axis 2" in out["errors"][(2, 1)]
        assert out["sizes"] == {(2, 1): (2, 1), (1, 2): (1, 2)}
        assert out["global"] == (1, 2)


def test_batch_rows_and_their_gather(ranks):
    x = np.arange(24.0).reshape(4, 6)
    for r, out in enumerate(ranks[0]):
        assert out["rows"] == x[2 * r:2 * r + 2].tolist()
        assert out["round_trip"] is True
        assert out["gather_bf16"] == [0.5, 0.5, 1.5, 1.5]


def _rows(t, r, m=2):
    k = t.shape[0] // m
    return t[r * k:(r + 1) * k]


def test_column_parallel_matches_dense_gradients(ranks):
    """Each model rank's gradient is its slice of the unsharded gradient:
    the gather's backward keeps the slice (no m-fold sum) and the input's
    gradient is summed over the axis."""
    for r, out in enumerate(ranks[0]):
        col, dense = out["column"], out["dense_grads"]
        np.testing.assert_allclose(*col["loss"], rtol=1e-6)
        assert col["xgrad"] < 1e-5
        assert col["local_shapes"]["0.weight"] == (3, 4, 3, 3)  # 6 outputs over 2 ranks
        assert col["local_shapes"]["3.weight"] == (3, 6, 1, 1)  # 3 outputs: replicated
        for k, g in col["grads"].items():
            want = _rows(dense[k], r) if g.shape != dense[k].shape else dense[k]
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)


def test_data_axis_batchnorm_matches_dense(ranks):
    """BatchNorm over the data axis normalizes with the whole batch's
    statistics: the averaged gradients and the running statistics are the
    unsharded ones."""
    for out in ranks[0]:
        bn = out["data_bn"]
        for k, g in bn["grads"].items():
            torch.testing.assert_close(g, out["dense_grads"][k], rtol=1e-5, atol=1e-6)
        for k, v in bn["running"].items():
            torch.testing.assert_close(v, bn["dense_running"][k], rtol=1e-5, atol=1e-6)


def test_gather_state_dict_is_the_reference_state_dict(ranks):
    outs, sd01 = ranks
    jcfg, tcfg = configs()
    dense = port_model(tcfg, 0.1, _jax_vars(jcfg, 0.1, seed=4))
    for out in outs:
        assert out["unet_local"]["enc1.conv1.weight"][0] * 2 == sd01["enc1.conv1.weight"].shape[0]
        gathered = out["unet_gathered"]
        assert list(gathered) == list(sd01)
        for k, v in sd01.items():
            assert torch.equal(gathered[k], v), k
        make_unet(tcfg, size_factor=0.1, device="cpu").load_state_dict(gathered, strict=True)
        want = jax.tree_util.tree_map(np.asarray, _jax_vars(jcfg, 0.1, seed=4))
        got = variables_from_unet_state_dict(gathered)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
        x, t = out["unet_eval_input"]
        with torch.no_grad():
            ref = dense.eval()(x, t, torch.ones(2, 1), torch.ones(2, 1))
        torch.testing.assert_close(out["unet_eval"], ref, rtol=1e-5, atol=1e-5)


def test_dropout_masks_are_the_unsharded_steps(ranks):
    """With dropout on and the port's own draws, two teacher steps on
    (2, 1) and (1, 2) are the unsharded steps: the masks are drawn for the
    global batch in the activation's memory layout and each rank keeps its
    rows (losses rtol 1e-5; parameters at JAX's ``_assert_spmd_parity``
    tolerance, rtol 2e-2 / atol 5e-4)."""
    want_losses, want = torch_dist.dropout_steps()
    params = {k for k, _ in make_unet(configs()[1], size_factor=0.25).named_parameters()}
    for out in ranks[0]:
        for shape, (losses, state) in out["dropout_steps"].items():
            np.testing.assert_allclose(losses, want_losses, rtol=1e-5, err_msg=str(shape))
            for k in params:
                np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), rtol=2e-2,
                                           atol=5e-4, err_msg=f"{shape} {k}")
