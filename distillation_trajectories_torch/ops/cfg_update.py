"""Fused CFG combine + trajectory-engine update: wrapper, plain version, kernel.

    out = c1·x − c2·(u + g·(c − u)) + σ·n

Port of ``distillation_trajectories_tpu/ops/cfg_update.py``, whose Pallas
``_kernel`` becomes the Triton kernel in :mod:`.cfg_update_triton` (see its
docstring for what bounds it on the H100 and what the design does about
that).  Two entries, one kernel: :func:`cfg_engine_update` takes the four
scalars as floats (one-off callers), :func:`cfg_engine_update_row` as one
``[4]`` float32 row ``(c1, c2, σ, g)`` on the operands' device (the
samplers' chains, one row of their ``[T-1, 4]`` table a step, as the Pallas
kernel takes its scalars through scalar prefetch: nothing crosses from the
host between steps, and a captured chain replays with what the table
holds).  On CPU tensors each runs :func:`cfg_engine_update_reference`; on
CUDA tensors each checks the operands, raises on what the kernel does not
take, and launches the kernel.  There is no fallback from the kernel to the
plain version.

Every step of the engine samplers passes both CFG predictions and the
guidance here, under either value of ``Config.pallas_cfg_update``: the
fused function is JAX's unfused tail too (the combine ``u + g·(c − u)``,
then the update), so on the card the kernel serves both of JAX's tails.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.graphs import host_to_device
from ._loading import on_cpu, triton_half

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def cfg_engine_update_reference(x, uncond, cond, noise, c1, c2, sigma, g):
    """Plain PyTorch version of the kernel: the same f32 math, rounded once
    to the operand dtype.  The scalars are floats, or 0-d float32 tensors
    on the operands' device (a table row unbound: the same values, the
    same bits)."""
    c1, c2, sigma, g = (v if torch.is_tensor(v) else float(v) for v in (c1, c2, sigma, g))
    xf, uf, cf, nf = (a.float() for a in (x, uncond, cond, noise))
    noise_pred = uf + g * (cf - uf)
    return (c1 * xf - c2 * noise_pred + sigma * nf).to(x.dtype)


def cfg_engine_update_row_reference(x, uncond, cond, noise, row):
    """The plain version in the row form (``row``: ``[4]`` float32, ``(c1,
    c2, σ, g)``, on the operands' device)."""
    return cfg_engine_update_reference(x, uncond, cond, noise, *row.unbind())


def _launch(x, uncond, cond, noise, row):
    out = torch.empty_like(x)
    triton_half("cfg_update_triton").launch(x, uncond, cond, noise, out, row)
    return out


def _check_operands(x, uncond, cond, noise) -> None:
    for name, a in (("uncond", uncond), ("cond", cond), ("noise", noise)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if a.dtype != x.dtype:
            raise TypeError(f"{name} is {a.dtype}, x is {x.dtype}")
        if a.shape != x.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, x {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(
            f"cfg_engine_update takes CPU or CUDA tensors, got {x.device}"
        )
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    for name, a in (("x", x), ("uncond", uncond), ("cond", cond), ("noise", noise)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous (NHWC, row-major)")
    if x.numel() >= 2**31:
        raise ValueError(f"{x.numel()} elements exceed the kernel's int32 offsets")


def cfg_engine_update(x, uncond, cond, noise, c1, c2, sigma, g):
    """Fused CFG combine + engine update of ``[B, H, W, C]`` tensors.

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel and count the launch in ``cfg_engine_update.launches``.  The
    scalars are Python or numpy floats; on the card they travel to it as
    one row, copied without a host sync.
    """
    if on_cpu(x, uncond, cond, noise):
        return cfg_engine_update_reference(x, uncond, cond, noise, c1, c2, sigma, g)
    _check_operands(x, uncond, cond, noise)
    row = host_to_device(np.array([c1, c2, sigma, g], dtype=np.float32), x.device)
    out = _launch(x, uncond, cond, noise, row)
    cfg_engine_update.launches += 1
    return out


def cfg_engine_update_row(x, uncond, cond, noise, row):
    """:func:`cfg_engine_update` with its scalars in ``row``, a ``[4]``
    float32 tensor ``(c1, c2, σ, g)`` on the operands' device (a row of a
    chain's table; the kernel reads it there).  Launches count in
    ``cfg_engine_update.launches``."""
    if on_cpu(x, uncond, cond, noise, row):
        return cfg_engine_update_row_reference(x, uncond, cond, noise, row)
    _check_operands(x, uncond, cond, noise)
    if row.device != x.device or row.dtype != torch.float32 or tuple(row.shape) != (4,) \
            or not row.is_contiguous():
        raise ValueError(f"row must be a contiguous [4] float32 tensor on {x.device}, got "
                         f"{row.dtype} {tuple(row.shape)} on {row.device}")
    out = _launch(x, uncond, cond, noise, row)
    cfg_engine_update.launches += 1
    return out


cfg_engine_update.launches = 0
