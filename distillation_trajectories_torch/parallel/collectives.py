"""The collectives GSPMD inserts in the JAX package, written out for
``torch.distributed`` process groups.

* :func:`all_gather_cat` and :func:`all_reduce_` over a group, on CPU or
  CUDA tensors and on either backend: two ranks that share one card run
  gloo, whose ``all_gather`` and ``all_reduce`` take CUDA tensors in the
  PyTorch the port runs on (2.11 on the H100 machine; PyTorch's backend
  table lists only ``broadcast`` and ``all_reduce``).  Point-to-point
  ``send``/``recv`` is not used.  Gloo moves bf16 and fp16 as float32
  (exact both ways).
* Column parallelism on the model axis: a sharded convolution or linear
  computes this rank's output channels from the whole input and
  all-gathers them.  The all-gather's backward keeps this rank's slice of
  the gradient (what follows it is replicated over the axis, so a summing
  reduce-scatter would give m times the gradient); the input's gradient is
  partial on each rank and is all-reduced over the axis.
* BatchNorm over the data axis: the batch mean and the biased variance
  from all-reduced sums (two passes), differentiably, then flax's rule
  (``models/unet.py::BatchNorm2d``).  Per-channel parameters and statistics
  sharded over the model axis are gathered for the whole activation.
* The mean of gradients over the data axis, and :func:`gather_state_dict`,
  which turns a sharded model back into the reference state dict.
"""

from __future__ import annotations

import itertools
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.unet import BatchNorm2d
from .mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size, param_spec

_LOW = (torch.bfloat16, torch.float16)


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as it travels: contiguous, and float32 on gloo for bf16/fp16."""
    if t.dtype in _LOW and dist.get_backend(group) == "gloo":
        return t.float()
    return t.contiguous()


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (``t`` contiguous); returns ``t``."""
    if _group_size(group) == 1:
        return t
    wire = _wire(t, group)
    dist.all_reduce(wire, group=group)
    if wire is not t:
        t.copy_(wire)
    return t


def _channels_last(x: torch.Tensor) -> bool:
    return x.ndim == 4 and x.shape[1] > 1 and x.stride(1) == 1


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order, on every rank, in ``x``'s memory format (a channels-last
    activation stays channels-last: what is drawn or computed on it next
    meets the unsharded layout)."""
    n = _group_size(group)
    if n == 1:
        return x
    wire = _wire(x, group)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=dim).to(x.dtype)
    return out.contiguous(memory_format=torch.channels_last) if _channels_last(x) else out


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.n, ctx.rank, ctx.dim = _group_size(group), dist.get_rank(group), dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=ctx.dim)[ctx.rank], None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the gradient over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    if _group_size(group) == 1:
        return x
    if x.requires_grad:
        return _GatherFromGroup.apply(x, group, dim)
    return all_gather_cat(x, group, dim)


class ColumnParallelConv2d(nn.Conv2d):
    """A convolution holding this model rank's output channels."""

    def forward(self, x):
        y = super().forward(_CopyToGroup.apply(x, self.model_group))
        return gather_from_group(y, self.model_group, 1)


class ColumnParallelLinear(nn.Linear):
    """A linear layer holding this model rank's output features."""

    def forward(self, x):
        y = super().forward(_CopyToGroup.apply(x, self.model_group))
        return gather_from_group(y, self.model_group, y.ndim - 1)


class MeshBatchNorm2d(BatchNorm2d):
    """The port's BatchNorm with statistics over the data axis
    (``data_group``) and parameters and statistics sharded over the model
    axis (``model_group``; None: not sharded), gathered for the whole
    activation."""

    data_group = None
    model_group = None

    def _full(self, t):
        return t if self.model_group is None else gather_from_group(t, self.model_group, 0)

    def _local(self, full: torch.Tensor) -> torch.Tensor:
        if self.model_group is None:
            return full
        k = full.shape[0] // _group_size(self.model_group)
        r = dist.get_rank(self.model_group)
        return full[r * k:(r + 1) * k]

    def batch_stats(self, x: torch.Tensor):
        w, b = self._full(self.weight), self._full(self.bias)
        d = _group_size(self.data_group)
        if d == 1:
            c = x.shape[1]
            mean = x.new_zeros((c,), dtype=torch.float32)
            var = x.new_zeros((c,), dtype=torch.float32)
            y = F.batch_norm(x, mean, var, w, b, True, 1.0, self.eps)
            n = x.numel() // c
            return y, mean, var * ((n - 1) / n)
        xf = x.float()
        n = xf.numel() // xf.shape[1] * d
        mean = _AllReduceSum.apply(xf.sum((0, 2, 3)), self.data_group) / n
        centred = xf - mean[None, :, None, None]
        var = _AllReduceSum.apply((centred * centred).sum((0, 2, 3)), self.data_group) / n
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * w[None, :, None, None] + b[None, :, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()

    def update_running(self, mean, var) -> None:
        super().update_running(self._local(mean), self._local(var))

    def forward(self, x):
        if self.training:
            return super().forward(x)
        return F.batch_norm(x, self._full(self.running_mean), self._full(self.running_var),
                            self._full(self.weight), self._full(self.bias), False, 0.0, self.eps)


def _rows_of(t: torch.Tensor, rank: int, m: int) -> torch.Tensor:
    k = t.shape[0] // m
    return t.detach()[rank * k:(rank + 1) * k].clone()


_COLUMN = {nn.Conv2d: ColumnParallelConv2d, nn.Linear: ColumnParallelLinear}


def shard_module(model: nn.Module, mesh) -> nn.Module:
    """Partition ``model`` in place for ``mesh``: each convolution, linear
    and norm whose output channels :func:`.mesh.param_spec` shards keeps
    this rank's slice of its parameters and statistics and computes as
    above; BatchNorm reduces its statistics over the data axis; dropout
    draws its masks for the global batch (``model.batch_shard``).  GroupNorm
    (per sample: nothing to reduce) stays replicated.  ``model.mesh``
    records the mesh.  Parameter names stay the reference's."""
    m, d = axis_size(mesh, MODEL_AXIS), axis_size(mesh, DATA_AXIS)
    mg = axis_group(mesh, MODEL_AXIS) if m > 1 else None
    mr = axis_rank(mesh, MODEL_AXIS)
    for module in model.modules():
        sharded = mg is not None and hasattr(module, "weight") and module.weight is not None \
            and param_spec(module.weight, m).is_shard()
        if type(module) in _COLUMN:
            if not sharded:
                continue
            module.__class__ = _COLUMN[type(module)]
        elif isinstance(module, BatchNorm2d):
            module.__class__ = MeshBatchNorm2d
            module.data_group = axis_group(mesh, DATA_AXIS) if d > 1 else None
        else:
            continue
        if not sharded:
            continue
        module.model_group = mg
        for name, t in itertools.chain(module.named_parameters(recurse=False),
                                       module.named_buffers(recurse=False)):
            if t.ndim == 0:
                continue
            local = _rows_of(t, mr, m)
            if isinstance(t, nn.Parameter):
                setattr(module, name, nn.Parameter(local, requires_grad=t.requires_grad))
            else:
                setattr(module, name, local)
    if hasattr(model, "batch_shard"):
        model.batch_shard = (axis_rank(mesh, DATA_AXIS), d) if d > 1 else None
    model.mesh = mesh
    return model


def sharded_state_names(model: nn.Module) -> Dict[str, object]:
    """State-dict names of the entries sharded over the model axis, each
    with its group."""
    out = {}
    for mname, module in model.named_modules():
        group = getattr(module, "model_group", None)
        if group is None:
            continue
        for name, t in itertools.chain(module.named_parameters(recurse=False),
                                       module.named_buffers(recurse=False)):
            if t.ndim:
                out[f"{mname}.{name}" if mname else name] = group
    return out


def gather_named(model: nn.Module, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Full tensors from ``{state-dict name: local tensor}`` of ``model``
    (its parameters, statistics, Adam moments or EMA), on every rank."""
    groups = sharded_state_names(model)
    return {k: all_gather_cat(v.detach(), groups[k], 0) if k in groups else v.detach().clone()
            for k, v in named.items()}


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The reference state dict of a sharded model (what the unsharded
    U-Net holds), on every rank; it loads ``strict=True`` into the
    unsharded U-Net."""
    return gather_named(model, model.state_dict())


def gather_optimizer_state(model: nn.Module, optimizer) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{parameter name: Adam state}`` with full moments, on every rank."""
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        out[name] = {k: v if k == "step" else gather_named(model, {name: v})[name]
                     for k, v in st.items()}
    return out


def shard_train_state(state, mesh):
    """See :func:`.mesh.shard_train_state`."""
    model = state.model
    before = dict(model.named_parameters())
    adam = {name: state.optimizer.state.get(p) for name, p in before.items()}
    full_shapes = {name: p.shape for name, p in before.items()}
    shard_module(model, mesh)
    m, mr = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    local_shapes = {name: p.shape for name, p in model.named_parameters()}

    def local(name, t):
        sharded = local_shapes[name] != full_shapes[name]
        return _rows_of(t, mr, m) if sharded and t.shape == full_shapes[name] else t

    opt = type(state.optimizer)(model.parameters(), **state.optimizer.defaults)
    for name, p in model.named_parameters():
        if adam[name]:
            opt.state[p] = {k: local(name, v) for k, v in adam[name].items()}
    if state.ema is not None:
        state.ema = {k: local(k, v) for k, v in state.ema.items()}
    state.optimizer = opt
    state.mesh = mesh
    return state


def mean_gradients(model: nn.Module, group) -> None:
    """Average every parameter's ``.grad`` over ``group`` in place (one
    all-reduce of the flattened gradients)."""
    n = _group_size(group)
    if n == 1:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group).div_(n)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
