"""FLOP and byte counts of a DiT forward from its shapes alone.

``dit_forward_flops`` is 2 x the multiply-adds of every linear layer and
convolution (the patch embedding, the timestep MLP, per block the qkv,
output, two MLP and adaLN linears, the final adaLN and output linears) and,
apart, of the attention products ``q k^T`` and ``p v`` (``4 N^2 d`` a
block), per sample.  Normalisation, modulation, gating, softmax and the
other elementwise work are not counted.  ``attention_bytes`` is the least
the attention of one block reads and writes per sample: q, k and v read
once and the output written once, in bf16.
"""

from __future__ import annotations

from typing import Dict

FREQ_DIM = 256


def dit_forward_flops(depth: int, hidden: int, tokens: int, patch: int = 2, channels: int = 4,
                      out_channels: int = 8, mlp_ratio: float = 4.0) -> Dict[str, int]:
    """``{"linear": ..., "attention": ...}`` FLOPs of one forward of one
    sample."""
    d, n, mlp = hidden, tokens, int(hidden * mlp_ratio)
    block = 2 * n * d * (3 * d + d + 2 * mlp) + 2 * d * 6 * d
    embed = 2 * n * channels * patch * patch * d + 2 * FREQ_DIM * d + 2 * d * d
    final = 2 * d * 2 * d + 2 * n * d * patch * patch * out_channels
    return {"linear": depth * block + embed + final, "attention": depth * 4 * n * n * d}


def attention_bytes(depth: int, hidden: int, tokens: int, itemsize: int = 2) -> int:
    """q, k, v read and the output written, every block, one sample."""
    return depth * 4 * tokens * hidden * itemsize
