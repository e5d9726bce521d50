"""Triton kernels of the DiT block's adaLN passes and their backward (Hopper).

Imports ``triton`` at module level, so it is imported only by
``ops.adaln``'s launches on a CUDA tensor, never on the CPU.

Replaces no TPU kernel: the JAX package has no DiT.  It was added because
the block's normalise-modulate-cast and gate-residual passes, each a full
pass of PyTorch's over the ``[B·N, D]`` token rows, took about a third of a
DiT forward's device time on the H100.

    GATED:  x' = x + gate[b]·y   (stored over x, or to a new tensor under autograd; float32)
    always: h  = LN(x')·(1 + scale[b]) + shift[b]   (stored once, in h's dtype)

The arithmetic is the plain composition's under autocast: the statistics,
the normalisation, the modulation and the residual sum in float32, and
``gate·y`` and ``1 + scale`` rounded to their operands' dtype (bf16 under
the port's autocast), as PyTorch's elementwise ops round them.  So ``x'``
equals the plain composition's bit for bit and ``h`` differs only by
float32 reordering before its one rounding.  (Both in float32 instead, on
the H100, moved the DiT cell's ``sweep_metric_gap`` against its bf16
reference from 1e-5 to up to 2.7e-4 of its 4e-4 limit.)

Bound: device-memory bytes.  A row is read once (float32 ``x``, and ``y``
when gated) and written once (``h``, and float32 ``x'`` over ``x`` when
gated: a program's rows are its own, read before they are written).  At
DiT-XL/2's 8,192 rows of 1,152 the ungated pass moves 56.8 MB (16.9 µs at
3.35 TB/s) and the gated one 113.5 MB with bf16 ``y`` and ``h`` (33.9 µs);
a few flops a byte sit far below the ridge.  The design moves only those
bytes: a program holds ``ROWS`` whole rows of one sample in registers
(``BLOCK_D`` the width's next power of two, the tail masked), so the
statistics (float32, two passes over the registers: mean, then the
centred sum of squares) and the modulation need no second read and no
scratch; the sample's modulation rows are loaded once a program and kept
in L2 (``evict_last``), the streamed rows marked ``evict_first``; loads run
along the row, which the compiler vectorises to 16-byte accesses.  The
width is a ``constexpr``: one build a width and variant, each published
DiT width (384, 768, 1152) its own.  The grid is ``(ceil(N / ROWS), B)``:
4,096 programs at 8,192 rows, many waves over the 132 SMs.  Tiling
measured on the H100 over 1, 2, 4, 8 rows and 2, 4, 8 warps a program at
all three widths: two rows and four warps are within 3% of the best of
each width and variant, and the hints gain 15-20% on the ungated pass.

**The backward** (``adaln_backward_kernel``, added with DiT training, whose
backward passes through both forward passes 57 times a DiT-XL/2 step; no
single PyTorch call computes it: ``F.layer_norm``'s backward covers the
norm alone).  For a row ``x'`` (the gated pass's sum, or ``x``), ``∂h``
and, where ``x'`` is used downstream, ``∂x'``::

    n̂  = (x' − mean)·r,   r = 1/sqrt(var + eps)        (recomputed, float32)
    ∂n̂ = ∂h·f,            f = 1 + scale rounded to scale's dtype
    ∂x = r·(∂n̂ − mean(∂n̂) − n̂·mean(∂n̂·n̂)) + ∂x'          (float32)
    GATED: g = ∂x rounded to y's dtype,  ∂y = g·gate  (in y's dtype)
    ∂shift = Σ_n ∂h,  ∂scale = Σ_n ∂h·n̂,  GATED: ∂gate = Σ_n (g·y rounded)

the roundings autograd's backward of the plain composition makes under
bf16 autocast (``ops/adaln.py::*_backward_reference``); the forward saves
``x'`` alone.  Bound: device-memory bytes.  A row is read once (float32
``x'``, ``∂h`` in h's dtype, and, as they exist, float32 ``∂x'`` and ``y``)
and written once (float32 ``∂x``, ``∂y`` in y's dtype): at DiT-XL/2's 8,192
rows of 1,152 the gated pass with ``∂x'`` moves 170.2 MB (50.8 µs at 3.35
TB/s), the ungated one 94.5 MB (28.2 µs).  The design keeps the registers
few (no lane masked, no whole row held): a program takes ``BWD_ROWS``
rows of one sample as one tile and walks the width in ``BWD_CHUNK``-column
chunks (128 divides every published DiT width: no lanes masked), three
times: the mean; the centred sum of squares with ``Σ ∂n̂`` and ``Σ ∂n̂·x̂``;
then each chunk's outputs and its ``[3, BWD_CHUNK]`` column sums over the
tile's rows, written as one partial of ``[B, parts, 3, D]`` float32 (3.5 MB
at DiT-XL/2's shapes).  The second and third walks read the tile again
from the caches (147 KB of ``x'`` a 32-row tile; L1, else the 50 MB L2),
not from device memory.  ``adaln_backward_reduce_kernel`` sums a sample's
partials in a fixed order and rounds them to the modulations' dtypes, so
no atomics: a replay reproduces its eager step bit for bit.  Tiling
measured on the H100 over 8, 16, 32 rows, 2, 4, 8 warps and 64 or 128
columns at the three widths: 32 rows, 4 warps and 128 columns were the
best at width 1152 (gated 113.8 µs, 44.6% of its bound; ungated 86.8 µs,
32.5%); 13% behind the best at 768 and 29% at 384, the students' widths,
which no cell trains.  So it is not yet at its bound: ``PERF.md`` §7 says
what is left.
"""

import triton
import triton.language as tl

ROWS = 2
NUM_WARPS = 4
BWD_ROWS = 32
BWD_NUM_WARPS = 4
BWD_CHUNK = 128
REDUCE_BLOCK = 256


@triton.jit
def adaln_kernel(
    x_ptr, y_ptr, gate_ptr, shift_ptr, scale_ptr, h_ptr, xs_ptr,
    tokens, gate_stride, shift_stride, scale_stride, eps,
    D: tl.constexpr, BLOCK_D: tl.constexpr, ROWS: tl.constexpr, GATED: tl.constexpr,
):
    sample = tl.program_id(1)
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_D)
    col_ok = cols < D
    mask = (rows < tokens)[:, None] & col_ok[None, :]
    offs = (sample * tokens + rows)[:, None] * D + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0, eviction_policy="evict_first")
    if GATED:
        y = tl.load(y_ptr + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        gate = tl.load(gate_ptr + sample * gate_stride + cols, mask=col_ok, other=0.0,
                       eviction_policy="evict_last")
        # The product rounded to the operands' dtype, as PyTorch's ``gate·y``.
        x = x + (gate[None, :].to(tl.float32) * y.to(tl.float32)).to(y.dtype).to(tl.float32)
        tl.store(xs_ptr + offs, x, mask=mask)  # each program reads its rows first
    mean = tl.sum(x, axis=1) / D
    centred = tl.where(mask, x - mean[:, None], 0.0)
    rstd = 1.0 / tl.sqrt(tl.sum(centred * centred, axis=1) / D + eps)
    shift = tl.load(shift_ptr + sample * shift_stride + cols, mask=col_ok, other=0.0,
                    eviction_policy="evict_last").to(tl.float32)
    scale = tl.load(scale_ptr + sample * scale_stride + cols, mask=col_ok, other=0.0,
                    eviction_policy="evict_last")
    # ``1 + scale`` rounded to scale's dtype, as PyTorch's.
    factor = (1.0 + scale.to(tl.float32)).to(scale.dtype).to(tl.float32)
    h = centred * rstd[:, None] * factor[None, :] + shift[None, :]
    tl.store(h_ptr + offs, h.to(h_ptr.dtype.element_ty), mask=mask)


def launch(x, y, gate, shift, scale, h, eps, xs):
    """``x`` ``[B, N, D]`` float32; ``x'`` written to ``xs`` (``x`` itself
    for the in-place pass) where gated; ``y`` and ``gate`` ``None`` for the
    ungated pass."""
    b, n, d = x.shape
    gated = y is not None
    if not gated:  # a placeholder the GATED=False build never touches
        y, gate = x, shift
    adaln_kernel[(triton.cdiv(n, ROWS), b)](
        x, y, gate, shift, scale, h, xs,
        n, gate.stride(0), shift.stride(0), scale.stride(0), eps,
        D=d, BLOCK_D=triton.next_power_of_2(d), ROWS=ROWS, GATED=gated, num_warps=NUM_WARPS,
    )


@triton.jit
def adaln_backward_kernel(
    xs_ptr, dh_ptr, dxs_ptr, y_ptr, gate_ptr, scale_ptr, dx_ptr, dy_ptr, part_ptr,
    tokens, parts, gate_stride, scale_stride, eps,
    D: tl.constexpr, CHUNK: tl.constexpr, ROWS: tl.constexpr, GATED: tl.constexpr,
    HAS_DXS: tl.constexpr,
):
    part = tl.program_id(0)
    sample = tl.program_id(1)
    rows = part * ROWS + tl.arange(0, ROWS)
    row_ok = rows < tokens
    base = (sample * tokens + rows)[:, None] * D
    cols = tl.arange(0, CHUNK)
    mask = row_ok[:, None] & (cols < CHUNK)[None, :]
    # Walk 1: the mean.
    total = tl.zeros([ROWS], dtype=tl.float32)
    for c in range(D // CHUNK):
        offs = base + c * CHUNK + cols[None, :]
        total += tl.sum(tl.load(xs_ptr + offs, mask=mask, other=0.0), axis=1)
    mean = total / D
    # Walk 2: the centred sum of squares, Σ ∂n̂ and Σ ∂n̂·(x' − mean).
    sq = tl.zeros([ROWS], dtype=tl.float32)
    s_dn = tl.zeros([ROWS], dtype=tl.float32)
    s_dnc = tl.zeros([ROWS], dtype=tl.float32)
    for c in range(D // CHUNK):
        offs = base + c * CHUNK + cols[None, :]
        centred = tl.where(mask, tl.load(xs_ptr + offs, mask=mask, other=0.0) - mean[:, None], 0.0)
        scale = tl.load(scale_ptr + sample * scale_stride + c * CHUNK + cols)
        # ``1 + scale`` rounded to scale's dtype, as the forward.
        factor = (1.0 + scale.to(tl.float32)).to(scale.dtype).to(tl.float32)
        dn = tl.load(dh_ptr + offs, mask=mask, other=0.0).to(tl.float32) * factor[None, :]
        sq += tl.sum(centred * centred, axis=1)
        s_dn += tl.sum(dn, axis=1)
        s_dnc += tl.sum(dn * centred, axis=1)
    rstd = 1.0 / tl.sqrt(sq / D + eps)
    mean_dn = s_dn / D
    mean_dn_nhat = s_dnc * rstd / D
    # Walk 3: the outputs and each chunk's column sums over the tile.
    out = part_ptr + (sample * parts + part) * 3 * D
    for c in range(D // CHUNK):
        col = c * CHUNK + cols
        offs = base + col[None, :]
        nhat = (tl.load(xs_ptr + offs, mask=mask, other=0.0) - mean[:, None]) * rstd[:, None]
        scale = tl.load(scale_ptr + sample * scale_stride + col)
        factor = (1.0 + scale.to(tl.float32)).to(scale.dtype).to(tl.float32)
        dh = tl.load(dh_ptr + offs, mask=mask, other=0.0, eviction_policy="evict_first").to(
            tl.float32)
        dx = rstd[:, None] * (dh * factor[None, :] - mean_dn[:, None]
                              - nhat * mean_dn_nhat[:, None])
        if HAS_DXS:
            dx = dx + tl.load(dxs_ptr + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        tl.store(dx_ptr + offs, dx, mask=mask)
        tl.store(out + col, tl.sum(dh, axis=0))
        tl.store(out + D + col, tl.sum(tl.where(mask, dh * nhat, 0.0), axis=0))
        if GATED:
            y = tl.load(y_ptr + offs, mask=mask, other=0.0, eviction_policy="evict_first")
            gate = tl.load(gate_ptr + sample * gate_stride + col).to(tl.float32)
            # The product's gradient in its dtype, then each product with
            # it rounded there, as autograd's backward of ``gate·y``.
            g = dx.to(y.dtype).to(tl.float32)
            tl.store(dy_ptr + offs, (g * gate[None, :]).to(y.dtype), mask=mask)
            tl.store(out + 2 * D + col,
                     tl.sum((g * y.to(tl.float32)).to(y.dtype).to(tl.float32), axis=0))


@triton.jit
def adaln_backward_reduce_kernel(
    part_ptr, dshift_ptr, dscale_ptr, dgate_ptr, parts,
    D: tl.constexpr, BLOCK: tl.constexpr, GATED: tl.constexpr,
):
    sample = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    ok = cols < D
    s_shift = tl.zeros([BLOCK], dtype=tl.float32)
    s_scale = tl.zeros([BLOCK], dtype=tl.float32)
    s_gate = tl.zeros([BLOCK], dtype=tl.float32)
    for p in range(parts):
        base = part_ptr + (sample * parts + p) * 3 * D
        s_shift += tl.load(base + cols, mask=ok, other=0.0)
        s_scale += tl.load(base + D + cols, mask=ok, other=0.0)
        if GATED:
            s_gate += tl.load(base + 2 * D + cols, mask=ok, other=0.0)
    out = sample * D + cols
    tl.store(dshift_ptr + out, s_shift.to(dshift_ptr.dtype.element_ty), mask=ok)
    tl.store(dscale_ptr + out, s_scale.to(dscale_ptr.dtype.element_ty), mask=ok)
    if GATED:
        tl.store(dgate_ptr + out, s_gate.to(dgate_ptr.dtype.element_ty), mask=ok)


def launch_backward(xs, dh, dxs, y, gate, scale, shift_dtype, eps):
    """``(∂x, ∂y, ∂gate, ∂shift, ∂scale)`` of ``xs`` ``[B, N, D]`` float32
    given ``dh`` (and ``dxs`` where not None); ``y`` and ``gate`` None for
    the ungated pass, whose ``∂y`` and ``∂gate`` are None."""
    import torch

    b, n, d = xs.shape
    gated = y is not None
    chunk = next(c for c in (BWD_CHUNK, 64, 32, 16) if d % c == 0)
    parts = triton.cdiv(n, BWD_ROWS)
    dx = torch.empty_like(xs)
    dy = torch.empty_like(y) if gated else None
    partial = torch.empty((b, parts, 3, d), dtype=torch.float32, device=xs.device)
    dshift = torch.empty((b, d), dtype=shift_dtype, device=xs.device)
    dscale = torch.empty((b, d), dtype=scale.dtype, device=xs.device)
    dgate = torch.empty((b, d), dtype=gate.dtype, device=xs.device) if gated else None
    # Placeholders the builds without them never touch.
    adaln_backward_kernel[(parts, b)](
        xs, dh, xs if dxs is None else dxs, y if gated else xs, gate if gated else scale, scale,
        dx, dy if gated else dx, partial,
        n, parts, (gate if gated else scale).stride(0), scale.stride(0), eps,
        D=d, CHUNK=chunk, ROWS=BWD_ROWS, GATED=gated, HAS_DXS=dxs is not None,
        num_warps=BWD_NUM_WARPS,
    )
    adaln_backward_reduce_kernel[(b, triton.cdiv(d, REDUCE_BLOCK))](
        partial, dshift, dscale, dgate if gated else dscale, parts,
        D=d, BLOCK=REDUCE_BLOCK, GATED=gated, num_warps=4,
    )
    return dx, dy, dgate, dshift, dscale
