"""FLOP and byte counts from shapes alone.

``unet_forward_flops`` is 2 x the multiply-adds of every convolution and
every linear layer of one U-Net forward (the published teacher/student
U-Net: base ``max(int(128 sf), 16)`` channels, multipliers 1, 2, 2, 2,
time embedding ``max(int(256 sf), 16)``), per image.  Pooling, upsampling,
normalisation and elementwise work are not counted.  ``cfg_update_bytes``
is one launch of the fused CFG update: four operands read once, the output
written once, and its four float32 scalars.
"""

from __future__ import annotations

from typing import Dict, Tuple


def unet_widths(size_factor: float) -> Tuple[int, list]:
    base = max(int(128 * size_factor), 16)
    dims = [max(16, int(base * m)) for m in (1, 2, 2, 2)]
    return max(int(256 * size_factor), 16), dims


def unet_forward_flops(size_factor: float, height: int, width: int, channels: int,
                       full_res_head: bool = False) -> Dict[str, int]:
    """``{"conv": ..., "linear": ...}`` FLOPs of one forward of one image."""
    ted, (d0, d1, d2, d3) = unet_widths(size_factor)
    conv = [0]
    linear = [2 * ted * ted, 2 * 1 * ted, 2 * ted * ted]  # time MLP, cond MLP

    def block(cin, cout, h, w):
        conv[0] += 2 * h * w * cout * cin * 9 + 2 * h * w * cout * cout * 9
        if cin != cout:
            conv[0] += 2 * h * w * cout * cin
        linear.append(2 * ted * cout)

    h, w = height, width
    block(channels, d0, h, w)
    block(d0, d1, h // 2, w // 2)
    block(d1, d2, h // 4, w // 4)
    block(d2, d3, h // 8, w // 8)
    block(d3, d3, h // 16, w // 16)
    block(2 * d3, d2, h // 8, w // 8)
    block(2 * d2, d1, h // 4, w // 4)
    block(2 * d1, d0, h // 2, w // 2)
    if full_res_head:
        block(2 * d0, d0, h, w)
    conv[0] += 2 * h * w * channels * d0  # final 1x1
    return {"conv": conv[0], "linear": sum(linear)}


def forward_flops(size_factor: float, height: int, width: int, channels: int) -> int:
    f = unet_forward_flops(size_factor, height, width, channels)
    return f["conv"] + f["linear"]


def cfg_update_bytes(numel: int, itemsize: int) -> int:
    """x, the two predictions and the noise read, the state written."""
    return 5 * numel * itemsize + 4 * 4
