"""Fused adaLN passes of the DiT block: wrappers, plain versions, kernels.

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
block always ran, whose roundings the kernels keep; autograd records it.
On CUDA tensors each checks its operands, raises on what the kernels do
not take (another device, dtype, shape or a non-unit column stride, a
width over 2048) and launches the Triton kernel of :mod:`.adaln_triton`.
There is no fallback from a kernel to the plain version.  ``h`` is
written in the dtype the next ``Linear`` reads: the autocast dtype where
autocast is on, float32 where it is off.

Where autograd records the pass (grad enabled and an operand that
requires it), the CUDA wrapper is an ``autograd.Function`` whose backward
is the Triton kernel of :mod:`.adaln_triton`'s ``adaln_backward_kernel``
(:func:`ln_modulate_backward`, :func:`gate_add_ln_modulate_backward`), and
the gated pass writes ``x'`` to a new tensor, which the backward reads:
autograd cannot save a tensor that is written over.  Otherwise
``gate_add_ln_modulate`` writes ``x'`` over ``x`` on every device: the
residual stream is updated in place, so a sampler's forward holds one
float32 stream and not two at each seam (the DiT-XL/2 cell's reserved
peak, 4.6875 GiB, read 4.75 GiB with ``x'`` a new tensor and 4.54 GiB in
place on the H100).  The ``*_reference`` functions are pure: they return
new tensors, which autograd can record; the ``*_backward_reference``
functions are the backward kernels' plain versions, the formulas of
autograd's backward of the reference composition.
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


def _ln_backward_reference(xs, scale, dh):
    """``(∂x, Σ_n ∂h, Σ_n ∂h·n̂)`` in float32 of the LayerNorm-and-modulate
    at ``x = xs``: ``∂n̂ = ∂h·f`` with ``f = 1 + scale`` rounded to scale's
    dtype, ``∂x = r·(∂n̂ − mean(∂n̂) − n̂·mean(∂n̂·n̂))``."""
    xs = xs.float()
    mean = xs.mean(-1, keepdim=True)
    centred = xs - mean
    rstd = torch.rsqrt((centred * centred).mean(-1, keepdim=True) + LN_EPS)
    nhat = centred * rstd
    dh = dh.float()
    dn = dh * (1 + scale).unsqueeze(1).float()
    dx = rstd * (dn - dn.mean(-1, keepdim=True) - nhat * (dn * nhat).mean(-1, keepdim=True))
    return dx, dh.sum(1), (dh * nhat).sum(1)


def ln_modulate_backward_reference(x, shift, scale, dh):
    """Plain version of :func:`ln_modulate_backward`: ``(∂x, ∂shift,
    ∂scale)`` of :func:`ln_modulate_reference` at ``x`` given ``∂h``;
    ``∂x`` float32, the column sums over the tokens rounded to the
    modulations' dtypes, as autograd rounds them."""
    dx, dshift, dscale = _ln_backward_reference(x, scale, dh)
    return dx, dshift.to(shift.dtype), dscale.to(scale.dtype)


def gate_add_ln_modulate_backward_reference(xs, y, gate, shift, scale, dh, dxs=None):
    """Plain version of :func:`gate_add_ln_modulate_backward`: ``(∂x, ∂y,
    ∂gate, ∂shift, ∂scale)`` of :func:`gate_add_ln_modulate_reference`
    given its sum ``xs = x'``, ``∂h`` and ``∂x'`` (``dxs``, None where
    ``x'`` is used nowhere else).  ``∂x = ∂x' + LN's ∂x`` (float32); the
    product's gradient ``g = ∂x`` rounded to y's dtype, ``∂y = g·gate`` and
    each ``g·y`` rounded to it before the sum over the tokens, as autograd
    rounds the bf16 product's backward."""
    dx, dshift, dscale = _ln_backward_reference(xs, scale, dh)
    if dxs is not None:
        dx = dx + dxs
    g = dx.to(y.dtype)
    dgate = (g * y).float().sum(1)
    return dx, g * gate.unsqueeze(1), dgate.to(gate.dtype), dshift.to(shift.dtype), \
        dscale.to(scale.dtype)


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
    if _h_dtype() not in _MOD_DTYPES:
        raise TypeError(f"the kernel writes h in float32 or bfloat16, autocast asks {_h_dtype()}")


def _recorded(*tensors) -> bool:
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


def _launch(x, y, gate, shift, scale, xs=None):
    """The forward kernel: ``h``, and ``x'`` into ``xs`` (``x`` itself
    where None) when gated."""
    h = torch.empty(x.shape, dtype=_h_dtype(), device=x.device)
    triton_half("adaln_triton").launch(x, y, gate, shift, scale, h, LN_EPS,
                                       x if xs is None else xs)
    return h


class _LnModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, scale):
        ctx.save_for_backward(x, shift, scale)
        return _launch(x, None, None, shift, scale)

    @staticmethod
    def backward(ctx, dh):
        return ln_modulate_backward(*ctx.saved_tensors, dh)


class _GateAddLnModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, gate, shift, scale):
        xs = torch.empty_like(x)
        h = _launch(x, y, gate, shift, scale, xs)
        ctx.save_for_backward(xs, y, gate, shift, scale)
        ctx.set_materialize_grads(False)
        return xs, h

    @staticmethod
    def backward(ctx, dxs, dh):
        return gate_add_ln_modulate_backward(*ctx.saved_tensors, dh, dxs)


def ln_modulate(x, shift, scale):
    """``LN(x)·(1 + scale) + shift`` of a float32 ``[B, N, D]`` ``x`` with
    ``[B, D]`` ``shift`` and ``scale`` (views of the adaLN output taken).
    CUDA tensors launch the kernel and count it in
    ``ln_modulate.launches``; where autograd records the pass, its
    backward launches :func:`ln_modulate_backward`."""
    if on_cpu(x, shift, scale):
        return ln_modulate_reference(x, shift, scale)
    _check(x, None, dict(shift=shift, scale=scale))
    if _recorded(x, shift, scale):
        h = _LnModulate.apply(x, shift, scale)
    else:
        h = _launch(x, None, None, shift, scale)
    ln_modulate.launches += 1
    return h


def gate_add_ln_modulate(x, y, gate, shift, scale):
    """``(x', h)``: ``x' = x + gate·y`` (the sum in float32), written over
    ``x`` and returned, and ``h = ln_modulate(x', shift, scale)``.  CUDA
    tensors launch the kernel, which computes both from the same
    registers, and count it in ``gate_add_ln_modulate.launches``; CPU
    tensors add in place and then take :func:`ln_modulate_reference`.
    Where autograd records the pass, ``x'`` is a new tensor on either
    device and, on the card, the backward launches
    :func:`gate_add_ln_modulate_backward`.  ``gate`` and ``y`` share a
    dtype, in which their product is rounded, as PyTorch rounds it."""
    recorded = _recorded(x, y, gate, shift, scale)
    if on_cpu(x, y, gate, shift, scale):
        if recorded:
            return gate_add_ln_modulate_reference(x, y, gate, shift, scale)
        x.add_(gate.unsqueeze(1) * y)
        return x, ln_modulate_reference(x, shift, scale)
    _check(x, y, dict(gate=gate, shift=shift, scale=scale))
    if recorded:
        x, h = _GateAddLnModulate.apply(x, y, gate, shift, scale)
    else:
        h = _launch(x, y, gate, shift, scale)
    gate_add_ln_modulate.launches += 1
    return x, h


def _check_backward(xs, dh, dxs) -> None:
    for name, g, dtype in (("dh", dh, None), ("dxs", dxs, torch.float32)):
        if g is None:
            continue
        if g.shape != xs.shape or g.device != xs.device or (dtype and g.dtype != dtype) \
                or g.dtype not in _MOD_DTYPES:
            raise ValueError(f"{name} must be a {tuple(xs.shape)} float32 or bfloat16 tensor on "
                             f"{xs.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")


def ln_modulate_backward(x, shift, scale, dh):
    """``(∂x, ∂shift, ∂scale)`` of :func:`ln_modulate` at ``x`` given
    ``∂h``, from the Triton backward (:mod:`.adaln_triton`):
    ``∂x`` float32 ``[B, N, D]``, ``∂shift`` and ``∂scale`` ``[B, D]`` in
    their modulations' dtypes (of ``shift`` only its dtype is read).  Counted
    in ``ln_modulate_backward.launches``; CPU tensors take
    :func:`ln_modulate_backward_reference`."""
    if on_cpu(x, scale, dh):
        return ln_modulate_backward_reference(x, shift, scale, dh)
    _check(x, None, dict(scale=scale))
    _check_backward(x, dh, None)
    out = triton_half("adaln_triton").launch_backward(
        x, dh.contiguous(), None, None, None, scale, shift.dtype, LN_EPS)
    ln_modulate_backward.launches += 1
    return out[0], out[3], out[4]


def gate_add_ln_modulate_backward(xs, y, gate, shift, scale, dh, dxs=None):
    """``(∂x, ∂y, ∂gate, ∂shift, ∂scale)`` of :func:`gate_add_ln_modulate`
    given its sum ``xs = x'``, ``∂h`` and ``∂x'`` (None where ``x'`` is used
    nowhere else), from the Triton backward: ``∂x`` float32, ``∂y`` in y's
    dtype, the column sums in their modulations' dtypes.  Counted in
    ``gate_add_ln_modulate_backward.launches``; CPU tensors take
    :func:`gate_add_ln_modulate_backward_reference`."""
    if on_cpu(xs, y, gate, scale, dh):
        return gate_add_ln_modulate_backward_reference(xs, y, gate, shift, scale, dh, dxs)
    _check(xs, y, dict(gate=gate, scale=scale))
    _check_backward(xs, dh, dxs)
    out = triton_half("adaln_triton").launch_backward(
        xs, dh.contiguous(), None if dxs is None else dxs.contiguous(), y, gate, scale,
        shift.dtype, LN_EPS)
    gate_add_ln_modulate_backward.launches += 1
    return out


ln_modulate.launches = 0
gate_add_ln_modulate.launches = 0
ln_modulate_backward.launches = 0
gate_add_ln_modulate_backward.launches = 0
