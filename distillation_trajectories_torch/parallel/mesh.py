"""The ``(data, model)`` mesh and its placements (port of
``distillation_trajectories_tpu/parallel/mesh.py``).

JAX builds a ``Mesh`` of devices and lets GSPMD partition each jitted
step; here a :class:`torch.distributed.device_mesh.DeviceMesh` names the
process subgroups of the two axes, and the partitioned step is written out
(:mod:`.collectives`):

* ``data``: each rank trains on (or samples) its rows of the global batch;
  BatchNorm statistics and gradients are reduced over the axis;
* ``model``: each rank holds the output-channel slice of every weight that
  :func:`param_spec` shards, computes those channels from the whole input
  and all-gathers the activation (column parallelism).

Random draws are made once for the global batch on every rank and each
rank keeps its rows, so a sharded run is the unsharded run, repartitioned.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def require_ranks(shape: Tuple[int, int], what: str = "mesh") -> None:
    """Raise ``ValueError`` unless the process group has exactly the ranks
    ``shape`` needs (a lone process counts as one rank)."""
    n = int(shape[0]) * int(shape[1])
    if n != world_size():
        raise ValueError(
            f"{what} {tuple(shape)} needs {n} devices (ranks), the process group has "
            f"{world_size()}: launch with torchrun --nproc_per_node={n}"
        )


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    device_type: Optional[str] = None,
    dim_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
):
    """A two-axis ``DeviceMesh`` over every rank of the process group
    (``shape=None``: all ranks on the data axis).  Every rank must call it,
    in the same order.  A one-rank mesh in a process without a process
    group joins a one-rank group held in memory."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (world_size(), 1) if shape is None else tuple(int(s) for s in shape)
    require_ranks(shape)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=tuple(dim_names))


def mesh_from_config(config):
    """The mesh ``Config.mesh_shape`` declares, or ``None`` for ``(1, 1)``.

    Raises ``ValueError`` when the process group has another number of
    ranks than the shape needs, or when ``batch_size`` does not divide over
    the data axis."""
    shape = tuple(config.mesh_shape)
    if shape == (1, 1):
        return None
    require_ranks(shape, "mesh_shape")
    if config.batch_size % shape[0] != 0:
        raise ValueError(
            f"batch_size {config.batch_size} not divisible by data axis "
            f"{shape[0]} of mesh_shape {shape}"
        )
    return make_mesh(shape, device_type=torch.device(config.device).type)


def axis_size(mesh, axis: str) -> int:
    """Ranks on ``axis`` (1 without a mesh or without that axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def batch_sharding(mesh):
    """Placements of a batch on the mesh: rows over the first (data) axis,
    replicated over the second."""
    return (Shard(0), Replicate())


def replicated(mesh):
    return (Replicate(), Replicate())


def param_spec(leaf: torch.Tensor, model_size: int):
    """Placement of one parameter or statistic on the model axis: its
    output-channel dim sharded when that dim divides the axis, else
    replicated.

    JAX shards the trailing dim of HWIO kernels, ``(in, out)`` dense
    kernels and per-channel vectors; in torch's OIHW convolutions,
    ``[out, in]`` linears and vectors that is dim 0."""
    if model_size <= 1 or leaf.ndim == 0:
        return Replicate()
    if leaf.shape[0] % model_size == 0 and leaf.shape[0] >= model_size:
        return Shard(0)
    return Replicate()


def shard_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Partition ``model`` in place for ``mesh``; see
    :func:`.collectives.shard_module`.  A DiT raises (``ValueError``): the
    mesh lane shards the U-Net only."""
    from ..models.dit import require_unet
    from .collectives import shard_module

    require_unet(model, "the mesh lane")
    return shard_module(model, mesh)


def shard_train_state(state, mesh):
    """Shard a :class:`..training.state.TrainState`: its model's sharded
    leaves, the matching slices of its Adam moments and EMA, and a new
    optimizer over the local parameters.  ``state.mesh`` becomes ``mesh``.
    A DiT's state raises (``ValueError``), as :func:`shard_params` does."""
    from ..models.dit import require_unet
    from .collectives import shard_train_state as _shard

    require_unet(state.model, "the mesh lane")
    return _shard(state, mesh)


def _rows(n: int, mesh, axis: str = DATA_AXIS) -> slice:
    d = axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"{n} rows do not divide over the {axis} axis of {d} ranks")
    b = n // d
    r = axis_rank(mesh, axis)
    return slice(r * b, (r + 1) * b)


def shard_batch(batch, mesh, dim: int = 0, axis: str = DATA_AXIS) -> torch.Tensor:
    """This rank's rows of a global batch (a tensor or numpy array), along
    ``dim``, over ``axis``."""
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.asarray(batch))
    idx = [slice(None)] * batch.ndim
    idx[dim] = _rows(batch.shape[dim], mesh, axis)
    return batch[tuple(idx)]


def gather_batch(local: torch.Tensor, mesh, dim: int = 0, axis: str = DATA_AXIS) -> torch.Tensor:
    """The global batch from every rank's rows (inverse of
    :func:`shard_batch`), on every rank."""
    from .collectives import all_gather_cat

    if axis_size(mesh, axis) == 1:
        return local
    return all_gather_cat(local, axis_group(mesh, axis), dim=dim)
