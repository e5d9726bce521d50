"""Seeded U-Net weights made on the device in a few large calls.

The published init (torch's default for conv and linear layers): weights
and biases uniform in +-1/sqrt(fan_in); norms at scale 1, shift 0, running
mean 0 and variance 1.  One draw of uniforms for every such element, one
per-element bound, one multiply, and views of the result by name.  The
benchmark hands the same tensors to the program (copied into its model)
and to the reference.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..reference.unet import param_spec


def make_weights(size_factor: float, channels: int, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = param_spec(size_factor, channels)
    uniform = [(n, s, k[1]) for n, s, k in spec if isinstance(k, tuple)]
    sizes = [torch.Size(s).numel() for _, s, _ in uniform]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device)
    bounds = torch.tensor([fin ** -0.5 for _, _, fin in uniform], device=device)
    flat = (2.0 * u - 1.0) * torch.repeat_interleave(bounds, torch.tensor(sizes, device=device))
    out: Dict[str, torch.Tensor] = {}
    views = dict(zip((n for n, _, _ in uniform), flat.split(sizes)))
    for name, shape, kind in spec:
        if isinstance(kind, tuple):
            out[name] = views[name].view(shape)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return out


def param_count(weights: Dict[str, torch.Tensor]) -> int:
    from ..reference.unet import is_trainable

    return sum(v.numel() for k, v in weights.items() if is_trainable(k))
