r"""Spatial (image-height) partitioning of the eval forward (port of
``distillation_trajectories_tpu/parallel/spatial.py``).

For images whose U-Net activations outgrow one card, the rows of every
activation are split over the ``spatial`` axis of a ``(data, spatial)``
mesh, with the batch over ``data``.  JAX lets GSPMD partition the forward
and pins each Block's input and output with a sharding constraint; here a
layout object (:class:`SpatialLayout`, the ``layout`` argument of
``models/unet.py::DiffusionUNet.forward``) re-lays each Block's input by
the same per-level rule and runs the partitioned pieces itself:

* a level's rows stay split over ``spatial`` only while ``h % s == 0`` and
  ``h // s >= 2``; otherwise the level is replicated (all-gathered);
* each 3×3 convolution at a split level takes one halo row from each
  neighbour (an all-gather of every rank's first and last rows) and zeros
  at the image's own top and bottom edges;
* a 2×2 max pool runs on the local rows when the shard holds an even
  number of them, else on the gathered level;
* the ``align_corners=True`` upsample reads the whole lower level and
  computes only this rank's output rows (interpolation matrices in double
  precision, as ``models/unet.py::resize_bilinear_align_corners``);
* eval BatchNorm, ReLU, the time bias, the 1×1 convolutions and the skip
  concatenations are row-local.

The eval functions take and return whole NHWC batches, like JAX's, so the
samplers and editing flows run unchanged: each rank cuts its block from
the input and the output is gathered.  Eval mode only, as in JAX, with
BatchNorm (GroupNorm's statistics span the rows; that norm raises).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from ..models.dit import require_unet
from ..models.unet import DENSE, _align_corners_matrix
from .collectives import all_gather_cat
from .mesh import DATA_AXIS, axis_group, axis_rank, axis_size, make_mesh, shard_batch

SPATIAL_AXIS = "spatial"


def make_spatial_mesh(shape: Optional[Tuple[int, int]] = None, device_type: Optional[str] = None):
    """A ``(data, spatial)`` mesh over every rank of the process group
    (``shape=None``: all ranks on the spatial axis)."""
    from .mesh import world_size

    shape = (1, world_size()) if shape is None else shape
    return make_mesh(shape, device_type=device_type, dim_names=(DATA_AXIS, SPATIAL_AXIS))


def spatial_batch_sharding(mesh):
    """Placements of an NHWC batch: rows of the batch over ``data``, image
    rows over ``spatial``."""
    return (Shard(0), Shard(1))


def shard_batch_spatial(x, mesh) -> torch.Tensor:
    """This rank's block of an NHWC batch (its batch rows and image rows).

    Raises on a batch or height that does not divide over its axis, up
    front."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    d, s = axis_size(mesh, DATA_AXIS), axis_size(mesh, SPATIAL_AXIS)
    if x.ndim != 4:
        raise ValueError(f"expected NHWC batch, got shape {tuple(x.shape)}")
    if x.shape[0] % d != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by data axis {d}")
    if x.shape[1] % s != 0:
        raise ValueError(f"image height {x.shape[1]} not divisible by spatial axis {s}")
    return shard_batch(shard_batch(x, mesh, 0, DATA_AXIS), mesh, 1, SPATIAL_AXIS)


def _split(h: int, s: int) -> bool:
    """Whether a level of height ``h`` keeps its rows split over ``s``
    ranks: only while they divide and each shard holds a 2×2 pool window."""
    return h % s == 0 and h // s >= 2


class _Act:
    """An NCHW activation: this rank's rows of a level of height ``h``
    (``split``) or the whole level."""

    __slots__ = ("t", "h", "split")

    def __init__(self, t: torch.Tensor, h: int, split: bool):
        self.t, self.h, self.split = t, h, split


class SpatialLayout:
    """The U-Net's dataflow on row-split activations (see the module
    docstring); the methods of ``models/unet.py::DenseLayout``."""

    def __init__(self, mesh):
        self.group = axis_group(mesh, SPATIAL_AXIS)
        self.s = axis_size(mesh, SPATIAL_AXIS)
        self.r = axis_rank(mesh, SPATIAL_AXIS)

    def _rows(self, t: torch.Tensor, h: int) -> torch.Tensor:
        k = h // self.s
        return t[:, :, self.r * k:(self.r + 1) * k]

    def _gather(self, a: _Act) -> torch.Tensor:
        return all_gather_cat(a.t, self.group, 2) if a.split else a.t

    def _relay(self, a: _Act) -> _Act:
        want = _split(a.h, self.s)
        if a.split == want:
            return a
        if a.split:
            return _Act(self._gather(a), a.h, False)
        return _Act(self._rows(a.t, a.h), a.h, True)

    def _halo_conv(self, layer: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
        edges = torch.stack([h[:, :, 0], h[:, :, -1]])  # [2, B, C, W]
        every = all_gather_cat(edges[None], self.group, 0)  # [s, 2, B, C, W]
        zero = torch.zeros_like(edges[0])
        top = every[self.r - 1, 1] if self.r > 0 else zero
        bottom = every[self.r + 1, 0] if self.r < self.s - 1 else zero
        padded = torch.cat([top[:, :, None], h, bottom[:, :, None]], dim=2)
        return F.conv2d(padded, layer.weight, layer.bias, layer.stride,
                        (0, layer.padding[1]), layer.dilation, layer.groups)

    def enter(self, h: torch.Tensor) -> _Act:
        """``h``: this rank's rows of the input."""
        return self._relay(_Act(h, h.shape[2] * self.s, True))

    def block(self, block, a: _Act, temb) -> _Act:
        a = self._relay(a)
        if not a.split:
            return _Act(block(a.t, temb), a.h, False)
        return _Act(block._body(a.t, temb, conv3=self._halo_conv), a.h, True)

    def pool(self, a: _Act) -> _Act:
        if a.split and a.t.shape[2] % 2 == 0:
            return _Act(F.max_pool2d(a.t, 2, 2), a.h // 2, True)
        return _Act(F.max_pool2d(self._gather(a), 2, 2), a.h // 2, False)

    def up(self, a: _Act) -> _Act:
        full, h2 = self._gather(a), 2 * a.h
        if not _split(h2, self.s):
            return _Act(DENSE.up(full), h2, False)
        k = h2 // self.s
        rows = _align_corners_matrix(a.h, h2)[self.r * k:(self.r + 1) * k]
        cols = _align_corners_matrix(full.shape[3], 2 * full.shape[3])
        rows, cols = (m.to(full.device, full.dtype) for m in (rows, cols))
        out = torch.einsum("oh,bchw->bcow", rows, full)
        out = torch.einsum("pw,bcow->bcop", cols, out)
        return _Act(out.contiguous(memory_format=torch.channels_last), h2, True)

    def cat(self, a: _Act, b: _Act) -> _Act:
        a, b = self._relay(a), self._relay(b)
        return _Act(torch.cat([a.t, b.t], dim=1), a.h, a.split)

    def pointwise(self, layer, a: _Act) -> _Act:
        return _Act(layer(a.t), a.h, a.split)

    def exit(self, a: _Act) -> torch.Tensor:
        return a.t if a.split else self._rows(a.t, a.h)


def make_spatial_forward(model: nn.Module, mesh):
    """Spatially partitioned eval forward ``fwd(params, x, t, cond=None,
    cond_mask=None) -> ε̂`` on whole NHWC batches, every rank of the mesh
    calling it alike; ``params`` (tensors by name, or None for the
    model's own) come first, as in JAX's args-first boundary.  Puts
    ``model`` in eval mode."""
    require_unet(model, "the spatial lane")
    if any(isinstance(m, nn.GroupNorm) for m in model.modules()):
        raise ValueError("spatial partitioning needs norm='batch': GroupNorm's "
                         "statistics span the image rows")
    model.eval()
    layout = SpatialLayout(mesh)

    def fwd(params, x, t, cond=None, cond_mask=None):
        d, b = axis_size(mesh, DATA_AXIS), x.shape[0]
        block = shard_batch_spatial(x, mesh)
        local = lambda v: None if v is None else shard_batch(v.reshape(b, -1), mesh)
        args = (block, shard_batch(t.reshape(b, -1)[:, 0], mesh))
        kwargs = dict(cond=local(cond), cond_mask=local(cond_mask), layout=layout)
        with torch.no_grad():
            if params is None:
                out = model(*args, **kwargs)
            else:
                out = torch.func.functional_call(model, params, args, kwargs, strict=False)
        out = all_gather_cat(out, layout.group, 1)
        return all_gather_cat(out, axis_group(mesh, DATA_AXIS), 0) if d > 1 else out

    return fwd


def make_spatial_eval_fn(model: nn.Module, mesh, params=None):
    """Drop-in for ``training.make_eval_model_fn``: ``(x, t, cond,
    cond_mask) -> ε̂`` through :func:`make_spatial_forward`."""
    fwd = make_spatial_forward(model, mesh)

    def model_fn(x, t, cond=None, cond_mask=None):
        return fwd(params, x, t, cond, cond_mask)

    return model_fn
