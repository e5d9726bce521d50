"""Fused adaLN passes of the DiT block: wrappers, plain versions, kernel.

    ln_modulate:           h  = LN(x)·(1 + scale[b]) + shift[b]
    gate_add_ln_modulate:  x' = x + gate[b]·y,   h = LN(x')·(1 + scale[b]) + shift[b]

``x`` is the float32 residual stream ``[B, N, D]``, ``y`` a branch's output
(``proj`` or ``fc2``, bf16 under the port's autocast), ``shift``,
``scale`` and ``gate`` ``[B, D]`` adaLN chunks of sample ``b``, LN the
LayerNorm without affine at eps 1e-6.  ``models/dit.py::DiT`` runs its
trunk through these two: the first block's attention input is one
``ln_modulate``; every seam after it, attention to MLP inside a block and
one block's end to the next block's (or the final layer's) normalisation,
is one ``gate_add_ln_modulate``, since the modulations depend on the
conditioning alone and are computed before the trunk.

On CPU tensors each wrapper runs its plain version, the composition the
block always ran, whose roundings the kernel keeps.  On CUDA tensors each
checks its operands, raises on what the kernel does not take (another
device, dtype, shape or a non-unit column stride, a width over 2048, a
tensor that autograd would record: the kernel has no backward) and
launches the Triton kernel of :mod:`.adaln_triton`.  There is no fallback
from the kernel to the plain version.  ``h`` is written in the dtype the
next ``Linear`` reads: the autocast dtype where autocast is on, float32
where it is off.  ``gate_add_ln_modulate`` writes ``x'`` over ``x`` on
every device: the residual stream is updated in place, so a forward holds
one float32 stream and not two at each seam (the DiT-XL/2 cell's reserved
peak, 4.6875 GiB, read 4.75 GiB with ``x'`` a new tensor and 4.54 GiB in
place on the H100).  The ``*_reference`` functions are pure: they return
new tensors, which autograd can record.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._loading import on_cpu, triton_half

LN_EPS = 1e-6
MAX_WIDTH = 2048
_MOD_DTYPES = (torch.float32, torch.bfloat16)


def ln_modulate_reference(x, shift, scale):
    """Plain version: LayerNorm, then ``modulate``, as the published block
    writes them (float32 out of a float32 ``x``)."""
    h = F.layer_norm(x, x.shape[-1:], eps=LN_EPS)
    return h * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)


def gate_add_ln_modulate_reference(x, y, gate, shift, scale):
    """Plain version: ``(x', h)``, the gated residual add and then
    :func:`ln_modulate_reference` of its sum."""
    x = x + gate.unsqueeze(1) * y
    return x, ln_modulate_reference(x, shift, scale)


def _h_dtype() -> torch.dtype:
    return torch.get_autocast_dtype("cuda") if torch.is_autocast_enabled("cuda") \
        else torch.float32


def _check(x, y, mods) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the adaLN kernels take CPU or CUDA tensors, got {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 [B, N, D] tensor, got {x.dtype} "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    b, _, d = x.shape
    if d % 16 or d > MAX_WIDTH:
        raise ValueError(f"the kernel takes widths that are multiples of 16 up to {MAX_WIDTH}, "
                         f"got {d}")
    if b > 65535:
        raise ValueError(f"the kernel's grid takes at most 65,535 samples, got {b}")
    if x.numel() >= 2**31:
        raise ValueError(f"{x.numel()} elements exceed the kernel's int32 offsets")
    if y is not None and (y.device != x.device or y.shape != x.shape
                          or y.dtype != mods["gate"].dtype or not y.is_contiguous()):
        raise ValueError(f"y must be a contiguous {tuple(x.shape)} tensor on {x.device} of gate's "
                         f"dtype {mods['gate'].dtype}, got {y.dtype} {tuple(y.shape)} on "
                         f"{y.device}")
    for name, m in mods.items():
        if m.device != x.device or tuple(m.shape) != (b, d) or m.dtype not in _MOD_DTYPES \
                or m.stride(1) != 1:
            raise ValueError(f"{name} must be a float32 or bfloat16 [{b}, {d}] tensor with unit "
                             f"column stride on {x.device}, got {m.dtype} {tuple(m.shape)} "
                             f"strides {m.stride()} on {m.device}")
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (x, y, *mods.values())):
        raise ValueError("the adaLN kernels have no backward: call them under torch.no_grad()")
    if _h_dtype() not in _MOD_DTYPES:
        raise TypeError(f"the kernel writes h in float32 or bfloat16, autocast asks {_h_dtype()}")


def _launch(x, y, gate, shift, scale):
    h = torch.empty(x.shape, dtype=_h_dtype(), device=x.device)
    triton_half("adaln_triton").launch(x, y, gate, shift, scale, h, LN_EPS)
    return h


def ln_modulate(x, shift, scale):
    """``LN(x)·(1 + scale) + shift`` of a float32 ``[B, N, D]`` ``x`` with
    ``[B, D]`` ``shift`` and ``scale`` (views of the adaLN output taken).
    CUDA tensors launch the kernel and count it in
    ``ln_modulate.launches``."""
    if on_cpu(x, shift, scale):
        return ln_modulate_reference(x, shift, scale)
    _check(x, None, dict(shift=shift, scale=scale))
    h = _launch(x, None, None, shift, scale)
    ln_modulate.launches += 1
    return h


def gate_add_ln_modulate(x, y, gate, shift, scale):
    """``(x', h)``: ``x' = x + gate·y`` (the sum in float32), written over
    ``x`` and returned, and ``h = ln_modulate(x', shift, scale)``.  CUDA
    tensors launch the kernel, which computes both from the same
    registers, and count it in ``gate_add_ln_modulate.launches``; CPU
    tensors add in place and then take :func:`ln_modulate_reference`.
    ``gate`` and ``y`` share a dtype, in which their product is rounded, as
    PyTorch rounds it."""
    if on_cpu(x, y, gate, shift, scale):
        x.add_(gate.unsqueeze(1) * y)
        return x, ln_modulate_reference(x, shift, scale)
    _check(x, y, dict(gate=gate, shift=shift, scale=scale))
    h = _launch(x, y, gate, shift, scale)
    gate_add_ln_modulate.launches += 1
    return x, h


ln_modulate.launches = 0
gate_add_ln_modulate.launches = 0
