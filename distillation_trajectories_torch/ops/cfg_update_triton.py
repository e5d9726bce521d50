"""Triton kernel of the fused CFG combine + engine update (Hopper).

Imports ``triton`` at module level, so it is imported only by
``ops.cfg_update._launch`` on a CUDA tensor, never on the CPU.

Replaces ``distillation_trajectories_tpu/ops/cfg_update.py::_kernel``.

    out = c1·x − c2·(u + g·(c − u)) + σ·n

The four scalars come from a ``[4]`` float32 row in device memory, as the
Pallas kernel takes them through scalar prefetch: a chain keeps one row a
step in a ``[T-1, 4]`` table, so one launch serves every step and every
guidance scale, and a CUDA graph of the chain replays with whatever the
table holds.

Bound: device-memory bytes.  Four operands are read and one is written, 20 B
per f32 element for about 6 flops, far below the H100's ridge of about 295
ops/byte.  At the main-path shape ``[256, 32, 32, 3]`` f32 that is 15.7 MB
per call (and the 16 B row), about 4.695 µs at 3.35 TB/s.  The design moves
only those bytes: one pass over a flat 1-D grid, the ragged tail masked
instead of padded and sliced (no pad copies), contiguous masked block loads
the compiler vectorises to 16-byte accesses, and the scalar row read once
a block (it stays in L1/L2).  Math is f32 whatever the operand type; bf16
operands are rounded once, on store.
"""

import triton
import triton.language as tl

BLOCK = 1024
NUM_WARPS = 4


@triton.jit
def cfg_engine_update_kernel(
    x_ptr, u_ptr, c_ptr, n_ptr, out_ptr, s_ptr, numel,
    BLOCK: tl.constexpr,
):
    c1 = tl.load(s_ptr)
    c2 = tl.load(s_ptr + 1)
    sigma = tl.load(s_ptr + 2)
    g = tl.load(s_ptr + 3)
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < numel
    x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
    u = tl.load(u_ptr + offs, mask=mask).to(tl.float32)
    c = tl.load(c_ptr + offs, mask=mask).to(tl.float32)
    n = tl.load(n_ptr + offs, mask=mask).to(tl.float32)
    out = c1 * x - c2 * (u + g * (c - u)) + sigma * n
    tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)


def launch(x, u, c, n, out, row):
    numel = x.numel()
    grid = (triton.cdiv(numel, BLOCK),)
    cfg_engine_update_kernel[grid](
        x, u, c, n, out, row, numel,
        BLOCK=BLOCK, num_warps=NUM_WARPS,
    )
