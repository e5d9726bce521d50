"""Fused CFG combine + trajectory-engine update: wrapper, plain version, kernel.

    out = c1·x − c2·(u + g·(c − u)) + σ·n

Port of ``distillation_trajectories_tpu/ops/cfg_update.py``, whose Pallas
``_kernel`` becomes the Triton kernel in :mod:`.cfg_update_triton` (see its
docstring for what bounds it on the H100 and what the design does about
that).  :func:`cfg_engine_update` is the one entry: on CPU tensors it runs
:func:`cfg_engine_update_reference`; on CUDA tensors it checks the operands,
raises on what the kernel does not take, and launches the kernel.  There is
no fallback from the kernel to the plain version.

Every step of the engine samplers passes both CFG predictions and the
guidance here, under either value of ``Config.pallas_cfg_update``: the
fused function is JAX's unfused tail too (the combine ``u + g·(c − u)``,
then the update), so on the card the kernel serves both of JAX's tails.
"""

from __future__ import annotations

import os

import torch

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_TRITON_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "triton",
)


def cfg_engine_update_reference(x, uncond, cond, noise, c1, c2, sigma, g):
    """Plain PyTorch version of the kernel: the same f32 math, rounded once
    to the operand dtype."""
    c1, c2, sigma, g = (float(v) for v in (c1, c2, sigma, g))
    xf, uf, cf, nf = (a.float() for a in (x, uncond, cond, noise))
    noise_pred = uf + g * (cf - uf)
    return (c1 * xf - c2 * noise_pred + sigma * nf).to(x.dtype)


def _launch(x, uncond, cond, noise, c1, c2, sigma, g):
    # Triton (imported here, never at module import: the CPU test suite
    # imports this module where no triton exists) builds into the repo-local
    # cache on first use.
    os.environ["TRITON_CACHE_DIR"] = _TRITON_CACHE_DIR
    from . import cfg_update_triton

    out = torch.empty_like(x)
    cfg_update_triton.launch(
        x, uncond, cond, noise, out,
        float(c1), float(c2), float(sigma), float(g),
    )
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
    scalars are Python or numpy floats.
    """
    if x.device.type == "cpu" and all(
        a.device.type == "cpu" for a in (uncond, cond, noise)
    ):
        return cfg_engine_update_reference(x, uncond, cond, noise, c1, c2, sigma, g)
    _check_operands(x, uncond, cond, noise)
    out = _launch(x, uncond, cond, noise, c1, c2, sigma, g)
    cfg_engine_update.launches += 1
    return out


cfg_engine_update.launches = 0
