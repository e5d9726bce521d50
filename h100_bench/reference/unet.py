"""The teacher/student diffusion U-Net in plain PyTorch, as functions of a
dict of tensors by name.

The published model (henriChevreux/distillation_trajectories
``models.py:85-244``): a sinusoidal time embedding through a linear layer
and ReLU, plus a conditioning MLP (linear, ReLU, linear) gated by a mask;
four encoder blocks with 2x2 max-pooling between them, a bottleneck block,
three decoder blocks that take the bilinear (align-corners) upsampled
features concatenated with the encoder's skip, a final 2x upsample and a
1x1 convolution.  A block is conv3x3, BatchNorm, ReLU, plus the ReLU'd
projection of the time embedding, then conv3x3, BatchNorm, ReLU, plus the
identity or a 1x1-convolution residual.  In training every block's output
goes through dropout.  The state-dict names are the published model's.

Inputs and outputs are NHWC, as the program's public API takes them.
Parameters are float32; the forward computes in the precision the
configuration states (``dtype``: under autocast for bfloat16, so each
convolution and linear layer takes bfloat16 operands and the tensors
between them are stored as those layers leave them), and returns float32.
``quant`` also rounds the operands of every convolution and linear layer
(the lower-precision control).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BLOCKS = ("enc1", "enc2", "enc3", "enc4", "bottleneck", "dec3", "dec2", "dec1")
BN_EPS = 1e-5


def widths(size_factor: float) -> Tuple[int, List[int]]:
    base = max(int(128 * size_factor), 16)
    return max(int(256 * size_factor), 16), [max(16, int(base * m)) for m in (1, 2, 2, 2)]


def block_channels(size_factor: float, channels: int) -> Dict[str, Tuple[int, int]]:
    _, (d0, d1, d2, d3) = widths(size_factor)
    return {"enc1": (channels, d0), "enc2": (d0, d1), "enc3": (d1, d2), "enc4": (d2, d3),
            "bottleneck": (d3, d3), "dec3": (2 * d3, d2), "dec2": (2 * d2, d1),
            "dec1": (2 * d1, d0)}


def param_spec(size_factor: float, channels: int):
    """``[(name, shape, kind)]`` in state-dict order; ``kind`` is
    ``("uniform", fan_in)`` for conv and linear weights and biases,
    ``"ones"`` / ``"zeros"`` for norms and buffers."""
    ted, (d0, _, _, _) = widths(size_factor)
    spec = []

    def lin(name, fin, fout):
        spec.append((f"{name}.weight", (fout, fin), ("uniform", fin)))
        spec.append((f"{name}.bias", (fout,), ("uniform", fin)))

    def conv(name, cin, cout, k):
        spec.append((f"{name}.weight", (cout, cin, k, k), ("uniform", cin * k * k)))
        spec.append((f"{name}.bias", (cout,), ("uniform", cin * k * k)))

    def norm(name, ch):
        spec.append((f"{name}.weight", (ch,), "ones"))
        spec.append((f"{name}.bias", (ch,), "zeros"))
        spec.append((f"{name}.running_mean", (ch,), "zeros"))
        spec.append((f"{name}.running_var", (ch,), "ones"))
        spec.append((f"{name}.num_batches_tracked", (), "count"))

    lin("time_mlp.1", ted, ted)
    lin("cond_emb.0", 1, ted)
    lin("cond_emb.2", ted, ted)
    for name, (cin, cout) in block_channels(size_factor, channels).items():
        conv(f"{name}.conv1", cin, cout, 3)
        norm(f"{name}.norm1", cout)
        lin(f"{name}.time_mlp", ted, cout)
        conv(f"{name}.conv2", cout, cout, 3)
        norm(f"{name}.norm2", cout)
        if cin != cout:
            conv(f"{name}.residual_conv", cin, cout, 1)
    conv("final", d0, channels, 1)
    return spec


def is_trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var", "num_batches_tracked"))


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    dim = max(dim, 2)
    half = max(dim // 2, 1)
    scale = math.log(10000.0) / (half - 1 + 1e-8)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -scale)
    args = t.reshape(-1).float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if emb.shape[-1] < dim:
        emb = F.pad(emb, (0, dim - emb.shape[-1]))
    return emb[:, :dim]


def dropout_shapes(batch: int, size_factor: float, channels: int, height: int, width: int):
    """NCHW shapes of the eight block outputs, in forward order."""
    chans = block_channels(size_factor, channels)
    scale = {"enc1": 1, "enc2": 2, "enc3": 4, "enc4": 8, "bottleneck": 16,
             "dec3": 8, "dec2": 4, "dec1": 2}
    return [(batch, chans[b][1], height // scale[b], width // scale[b]) for b in BLOCKS]


def _identity(x):
    return x


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
            mask: torch.Tensor, size_factor: float, *, train: bool = False,
            dropout_masks: Optional[List[torch.Tensor]] = None, keep: float = 1.0,
            quant: Optional[Callable] = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Predicted noise, float32 NHWC.  ``cond`` and ``mask`` are ``[B, 1]``.
    In ``train`` mode BatchNorm normalises with the batch statistics and
    each block output is multiplied by its mask over ``keep``."""
    with torch.autocast(device_type=x.device.type, dtype=dtype,
                        enabled=dtype != torch.float32, cache_enabled=False):
        return _forward(p, x, t, cond, mask, size_factor, train, dropout_masks, keep,
                        quant or _identity)


def _forward(p, x, t, cond, mask, size_factor, train, dropout_masks, keep, q):
    ted, _ = widths(size_factor)
    chans = block_channels(size_factor, x.shape[-1])

    def lin(name, h):
        return F.linear(q(h), q(p[f"{name}.weight"]), p[f"{name}.bias"])

    def conv(name, h, pad):
        return F.conv2d(q(h), q(p[f"{name}.weight"]), p[f"{name}.bias"], padding=pad)

    def norm(name, h):
        if train:
            return F.batch_norm(h, None, None, p[f"{name}.weight"], p[f"{name}.bias"],
                                True, 0.0, BN_EPS)
        return F.batch_norm(h, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                            p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, BN_EPS)

    def block(name, h, temb):
        cin, cout = chans[name]
        residual = h if cin == cout else conv(f"{name}.residual_conv", h, 0)
        y = F.relu(norm(f"{name}.norm1", conv(f"{name}.conv1", h, 1)))
        y = y + F.relu(lin(f"{name}.time_mlp", temb))[:, :, None, None]
        y = F.relu(norm(f"{name}.norm2", conv(f"{name}.conv2", y, 1)))
        return y + residual

    masks = iter(dropout_masks or ())

    def drop(h):
        if not train or dropout_masks is None:
            return h
        return h / keep * next(masks).to(h.dtype)

    def up(h):
        return F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=True)

    b = x.shape[0]
    temb = F.relu(lin("time_mlp.1", time_embedding(t, ted)))
    c = F.relu(lin("cond_emb.0", cond.reshape(b, 1).float()))
    temb = temb + mask.reshape(b, 1).float() * lin("cond_emb.2", c)
    h = x.float().permute(0, 3, 1, 2).contiguous()  # the published model's NCHW
    x1 = drop(block("enc1", h, temb))
    x2 = drop(block("enc2", F.max_pool2d(x1, 2, 2), temb))
    x3 = drop(block("enc3", F.max_pool2d(x2, 2, 2), temb))
    x4 = drop(block("enc4", F.max_pool2d(x3, 2, 2), temb))
    h = drop(block("bottleneck", F.max_pool2d(x4, 2, 2), temb))
    h = drop(block("dec3", torch.cat([up(h), x4], 1), temb))
    h = drop(block("dec2", torch.cat([up(h), x3], 1), temb))
    h = drop(block("dec1", torch.cat([up(h), x2], 1), temb))
    out = conv("final", up(h), 0)
    return out.float().permute(0, 2, 3, 1).contiguous()


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor float8 (e4m3) rounding, scaled to the tensor's largest
    magnitude; gradients pass straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = amax / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()
