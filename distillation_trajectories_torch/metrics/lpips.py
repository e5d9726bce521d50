"""AlexNet-LPIPS perceptual distance (port of ``metrics/lpips.py``).

LPIPS(x, y) = Σ_l mean_hw Σ_c w_lc (φ̂_l(x) − φ̂_l(y))²_c over the unit-
normalised ReLU taps φ̂ of torchvision alexnet's five convolutions, after
the lpips "scaling layer".  The module names are torchvision's and the
lpips package's: ``net.features.{0,3,6,8,10}.{weight,bias}`` and the 1x1
heads ``lin{0..4}.model.1.weight``.

Weights: ``LPIPS_WEIGHTS`` or ``weights/lpips_alex.npz`` (alexnet
``features.*`` plus the lpips ``lin*`` heads, as ``.npz`` or a torch file);
without one, seeded random features with flax's initialisers and uniform
``1/C`` heads — a self-consistent ranking, not calibrated LPIPS.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.inception import _init_, _read_state, load_first_weights

# lpips ScalingLayer constants (inputs in [-1, 1]).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision alexnet `features` convolutions: (in, out, kernel, stride,
# pad, index in `features`); a max-pool follows the first two ReLUs.
_ALEX_CONVS = (
    (3, 64, 11, 4, 2, 0),
    (64, 192, 5, 1, 2, 3),
    (192, 384, 3, 1, 1, 6),
    (384, 256, 3, 1, 1, 8),
    (256, 256, 3, 1, 1, 10),
)


def _weights_search_paths() -> Sequence[str]:
    """Candidate weight files, resolved when called, relative to this
    checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return [
        os.environ.get("LPIPS_WEIGHTS", ""),
        os.path.join(root, "weights", "lpips_alex.npz"),
    ]


class AlexFeatures(nn.Module):
    """torchvision alexnet ``features`` (through the last ReLU); returns the
    five ReLU taps of an NCHW input."""

    def __init__(self):
        super().__init__()
        layers = []
        for i, (cin, cout, k, s, p, _) in enumerate(_ALEX_CONVS):
            layers += [nn.Conv2d(cin, cout, k, stride=s, padding=p), nn.ReLU()]
            if i < 2:
                layers.append(nn.MaxPool2d(3, stride=2))
        self.features = nn.Sequential(*layers)
        self._taps = {idx + 1 for *_, idx in _ALEX_CONVS}

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._taps:
                taps.append(x)
        return tuple(taps)


class NetLinLayer(nn.Module):
    """lpips' per-channel 1x1 head (the dropout is inert in eval)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPSAlex(nn.Module):
    """AlexNet-LPIPS scorer: ``forward(images1, images2)`` takes NHWC (or
    HWC) images in [−1, 1], one channel repeated to three, and returns the
    ``[B]`` distances."""

    def __init__(self):
        super().__init__()
        self.net = AlexFeatures()
        for i, (_, cout, *_) in enumerate(_ALEX_CONVS):
            setattr(self, f"lin{i}", NetLinLayer(cout))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, images1: torch.Tensor, images2: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(images1, dtype=torch.float32).to(self.shift.device)
        y = torch.as_tensor(images2, dtype=torch.float32).to(self.shift.device)
        if x.ndim == 3:
            x, y = x[None], y[None]
        both = torch.cat([x, y]).permute(0, 3, 1, 2)
        if both.shape[1] == 1:
            both = both.expand(-1, 3, -1, -1)
        both = ((both - self.shift) / self.scale).contiguous(memory_format=torch.channels_last)
        b = x.shape[0]
        total = 0.0
        for i, tap in enumerate(self.net(both)):
            unit = tap * torch.rsqrt((tap * tap).sum(dim=1, keepdim=True) + 1e-10)
            d = (unit[:b] - unit[b:]) ** 2
            total = total + getattr(self, f"lin{i}").model(d).mean(dim=(1, 2, 3))
        return total


def load_lpips_weights(path: str, model: LPIPSAlex) -> LPIPSAlex:
    """Load alexnet ``features.*`` and lpips ``lin{i}.model.1.weight``
    tensors (``.npz`` or a torch file) into ``model`` in place; the heads
    are clipped at zero, as lpips does.  A missing entry raises
    ``KeyError``, a wrong shape ``ValueError``."""
    state = _read_state(path)
    new = {}
    for name, want in model.state_dict().items():
        key = name[len("net."):] if name.startswith("net.") else name
        if key not in state:
            raise KeyError(f"missing torch weight {key}")
        w = np.asarray(state[key], dtype=np.float32)
        if key.startswith("lin"):
            w = np.maximum(w, 0.0)
        if tuple(w.shape) != tuple(want.shape):
            raise ValueError(f"{key}: file has shape {w.shape}, model {tuple(want.shape)}")
        new[name] = torch.from_numpy(w)
    model.load_state_dict(new, strict=True)
    return model


def create_lpips(weights_path: Optional[str] = None, seed: int = 0,
                 device=None) -> Tuple[LPIPSAlex, bool]:
    """The scorer in eval mode on ``device`` (default ``cuda``); returns
    ``(scorer, pretrained)``.  Without a readable weights file: seeded
    random features (drawn on the CPU) and uniform ``1/C`` heads."""
    from ..config import resolve_device

    device = resolve_device("cuda" if device is None else device)
    with torch.device("meta"):
        model = LPIPSAlex()
    model.to_empty(device="cpu")
    _init_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for i, (_, cout, *_) in enumerate(_ALEX_CONVS):
            getattr(model, f"lin{i}").model[1].weight.fill_(1.0 / cout)
        model.shift.copy_(torch.tensor(_SHIFT).view(1, 3, 1, 1))
        model.scale.copy_(torch.tensor(_SCALE).view(1, 3, 1, 1))
    pretrained = load_first_weights(model, load_lpips_weights,
                                    [weights_path] if weights_path else _weights_search_paths(),
                                    "[lpips]")
    model = model.requires_grad_(False).to(device=device, memory_format=torch.channels_last)
    return model.eval(), pretrained
