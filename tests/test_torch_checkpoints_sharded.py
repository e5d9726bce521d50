"""The sharded checkpoint lane (``training/checkpoints.py``:
``save_checkpoint_sharded``, ``load_checkpoint_sharded``,
``available_epochs_sharded``, ``sharded_checkpoint_path``,
``abstract_target``), the port of JAX's orbax lane in PyTorch's own
format (``torch.distributed.checkpoint``, ``model_epoch_{e}.dcp``).

In one process: a round trip equal to the msgpack payload of the same
model bit for bit; ``available_epochs`` and ``load_checkpoint`` taking
either format; partial directories never listed; a JAX ``.orbax``
directory answered with its route into the port; and JAX's orbax save →
load of the same variables equal to the port's sharded save → load
(through ``models/convert.py``).  On a 2-rank ``gloo`` world, a model
sharded over ``(1, 2)`` with Adam state and EMA: each rank reads its own
shards back through ``abstract_target``, and this one process reads the
whole tree, equal to the ranks' gathered state.
"""

import os

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import checkpoints as jax_ckpt
from distillation_trajectories_torch.models import make_unet, variables_from_unet_state_dict
from distillation_trajectories_torch.models.convert import params_tree_from_named
from distillation_trajectories_torch.parallel.launch import spawn_ranks
from distillation_trajectories_torch.training import (
    available_epochs,
    available_epochs_sharded,
    latest_epoch,
    load_checkpoint,
    load_checkpoint_sharded,
    save_checkpoint,
    save_checkpoint_sharded,
    sharded_checkpoint_path,
)
from distillation_trajectories_torch.training.state import TorchDraws, create_train_state

import torch_dist
from torch_parity import (  # tmp_path: each test's outputs removed when it ends
    configs,
    port_model,
    tmp_path,
)


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _trained(tcfg):
    """An sf-0.1 U-Net after one Adam step, with an EMA."""
    model = make_unet(tcfg, size_factor=0.1, device="cpu", seed=3)
    state = create_train_state(model, tcfg, TorchDraws(0, "cpu"), use_ema=True)
    loss = (model.train()(torch.ones((2, 16, 16, 1)), torch.tensor([1.0, 2.0])) ** 2).mean()
    loss.backward()
    state.optimizer.step()
    state.ema = {k: v * 0.25 for k, v in state.ema.items()}
    return state


def test_round_trip_equals_the_msgpack_payload(tmp_path):
    _, tcfg = configs()
    state = _trained(tcfg)
    d = str(tmp_path / "teacher")
    path = save_checkpoint_sharded(d, 3, state.model, optimizer=state.optimizer, ema=state.ema,
                                   extra={"note": "spmd"})
    assert path == os.path.abspath(sharded_checkpoint_path(d, 3))
    assert path.endswith("model_epoch_3.dcp") and os.path.exists(path + ".meta.json")
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    got = load_checkpoint_sharded(d)
    save_checkpoint(str(tmp_path / "msgpack"), 3, state.model, optimizer=state.optimizer,
                    ema=state.ema, extra={"note": "spmd"})
    want = load_checkpoint(str(tmp_path / "msgpack"), 3)
    assert set(got) == set(want) == {"epoch", "params", "batch_stats", "opt_state",
                                     "ema_params", "extra"}
    assert got["epoch"] == 3 and got["extra"] == {"note": "spmd"}
    for key in ("params", "batch_stats", "opt_state", "ema_params"):
        _leaves_equal(got[key], want[key])


def test_readers_take_either_format(tmp_path):
    _, tcfg = configs()
    model = make_unet(tcfg, size_factor=0.1, device="cpu")
    d = str(tmp_path)
    save_checkpoint(d, 1, model)
    save_checkpoint_sharded(d, 2, model)
    assert available_epochs(d) == [1, 2] and latest_epoch(d) == 2
    assert available_epochs_sharded(d) == [2]
    assert load_checkpoint(d)["epoch"] == 2  # the sharded directory
    assert load_checkpoint(d, 1)["epoch"] == 1  # the msgpack file
    _leaves_equal(load_checkpoint(d)["params"], load_checkpoint(d, 1)["params"])


def test_partial_directories_are_never_listed(tmp_path):
    _, tcfg = configs()
    d = str(tmp_path)
    save_checkpoint_sharded(d, 1, make_unet(tcfg, size_factor=0.1, device="cpu"))
    os.makedirs(os.path.join(d, "model_epoch_5.dcp.tmp"))  # a write cut short
    open(os.path.join(d, "model_epoch_5.dcp.tmp", "__0_0.distcp"), "wb").close()
    os.makedirs(os.path.join(d, "model_epoch_6.dcp"))  # no .metadata
    assert available_epochs(d) == available_epochs_sharded(d) == [1]
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d, 6)


def test_a_jax_orbax_directory_names_its_route(tmp_path):
    os.makedirs(tmp_path / "model_epoch_3.orbax")
    for epoch in (None, 3):
        with pytest.raises(FileNotFoundError,
                           match="export_reference_checkpoint.*import_reference_checkpoint"):
            load_checkpoint(str(tmp_path), epoch)


def test_jax_orbax_round_trip_equals_the_ports(tmp_path):
    jcfg, tcfg = configs()
    variables = jax_init_unet(jax_make_unet(jcfg, size_factor=0.1), jcfg, jax.random.PRNGKey(2))
    jax_ckpt.save_checkpoint_sharded(str(tmp_path / "jax"), 1, variables["params"],
                                     batch_stats=variables["batch_stats"])
    want = jax_ckpt.load_checkpoint_sharded(str(tmp_path / "jax"), 1)
    save_checkpoint_sharded(str(tmp_path / "port"), 1, port_model(tcfg, 0.1, variables))
    got = load_checkpoint_sharded(str(tmp_path / "port"), 1)
    for key in ("params", "batch_stats"):
        _leaves_equal(got[key], want[key])
    assert got["epoch"] == want["epoch"] == 1


def test_ranks_write_their_shards_and_one_process_reads_the_whole(tmp_path):
    _, tcfg = configs()
    sd = make_unet(tcfg, size_factor=0.25, device="cpu", seed=5).state_dict()
    d = str(tmp_path / "ranks")
    out = spawn_ranks(2, torch_dist.sharded_checkpoint, (d, sd), backend="gloo", timeout=300)
    assert all(o["local_equal"] and o["epochs"] == [3] for o in out)
    ranks = out[0]
    payload = load_checkpoint_sharded(d)
    assert payload["epoch"] == 3 and payload["extra"] == {"note": "ranks"}
    want = variables_from_unet_state_dict(ranks["state"])
    _leaves_equal(payload["params"], want["params"])
    _leaves_equal(payload["batch_stats"], want["batch_stats"])
    adam = payload["opt_state"]["0"]
    _leaves_equal(adam["mu"], params_tree_from_named({k: v["exp_avg"] for k, v in ranks["adam"].items()}))
    _leaves_equal(adam["nu"], params_tree_from_named({k: v["exp_avg_sq"]
                                                      for k, v in ranks["adam"].items()}))
    assert int(adam["count"]) == 1
    _leaves_equal(payload["ema_params"], params_tree_from_named(ranks["ema"]))
