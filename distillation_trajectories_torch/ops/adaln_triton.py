"""Triton kernel of the DiT block's adaLN passes (Hopper).

Imports ``triton`` at module level, so it is imported only by
``ops.adaln._launch`` on a CUDA tensor, never on the CPU.

Replaces no TPU kernel: the JAX package has no DiT.  It was added because
the block's normalise-modulate-cast and gate-residual passes, each a full
pass of PyTorch's over the ``[B·N, D]`` token rows, took about a third of a
DiT forward's device time on the H100.

    GATED:  x' = x + gate[b]·y   (stored over x, float32)
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
"""

import triton
import triton.language as tl

ROWS = 2
NUM_WARPS = 4


@triton.jit
def adaln_kernel(
    x_ptr, y_ptr, gate_ptr, shift_ptr, scale_ptr, h_ptr,
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
        tl.store(x_ptr + offs, x, mask=mask)  # each program reads its rows first
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


def launch(x, y, gate, shift, scale, h, eps):
    """``x`` ``[B, N, D]`` float32, overwritten by ``x'`` where gated;
    ``y`` and ``gate`` ``None`` for the ungated pass."""
    b, n, d = x.shape
    gated = y is not None
    if not gated:  # a placeholder the GATED=False build never touches
        y, gate = x, shift
    adaln_kernel[(triton.cdiv(n, ROWS), b)](
        x, y, gate, shift, scale, h,
        n, gate.stride(0), shift.stride(0), scale.stride(0), eps,
        D=d, BLOCK_D=triton.next_power_of_2(d), ROWS=ROWS, GATED=gated, num_warps=NUM_WARPS,
    )
