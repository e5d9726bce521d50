"""InceptionV3 feature trunk for FID (port of ``models/inception.py``).

The full InceptionV3 trunk through the global average pool (2048-d
features), as a tree of ``nn.Module``s named as torchvision's
``inception_v3`` names them (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, …), so a torchvision state dict
loads into it directly; its ``fc.*`` and ``AuxLogits.*`` entries are left
over.  The public layout is NHWC, as in the JAX package; inside, the trunk
runs channels-last NCHW.

Weights: a torchvision state dict from a local file (``.pth`` or ``.npz``)
when one is found, otherwise a seeded random initialisation with flax's
initialisers (conv kernels LeCun-normal, truncated, fan-in; BatchNorm scale
1, bias 0, mean 0, variance 1).  FID values then rank sample sets under a
fixed random projection, not ImageNet semantics; callers stamp which.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INPUT_SIZE = 299

# flax's truncated normal is cut at ±2 standard normals and rescaled by the
# standard deviation of that truncated distribution.
_TRUNC_STD = 0.87962566103423978


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + ReLU, in inference mode."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    # 3x3/1 with zero padding 1 counted in the mean, as flax's avg_pool does.
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3Features(nn.Module):
    """InceptionV3 trunk: ``[N, H, W, 3]`` (299x299 for FID) → ``[N, 2048]``
    globally pooled features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal at ±2σ with variance
    1/fan_in, fan_in = in_channels x kernel area."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def _read_state(path: str) -> dict:
    """A state dict of numpy arrays from a ``.npz`` or a torch file."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return {k: v.numpy() for k, v in torch.load(path, map_location="cpu").items()}


def load_torchvision_weights(path: str, model: nn.Module) -> nn.Module:
    """Load a torchvision ``inception_v3`` state dict (``.pth``/``.pt`` or
    ``.npz`` with the same names) into ``model`` in place.  Extra entries
    (``fc.*``, ``AuxLogits.*``) are ignored; a missing one raises
    ``KeyError`` naming it, a wrong shape ``ValueError``."""
    state = _read_state(path)
    own = model.state_dict()
    new = {}
    for name, want in own.items():
        if name.endswith("num_batches_tracked"):
            new[name] = want
            continue
        if name not in state:
            raise KeyError(f"missing torch weight {name}")
        w = np.asarray(state[name], dtype=np.float32)
        if tuple(w.shape) != tuple(want.shape):
            raise ValueError(f"{name}: file has shape {w.shape}, model {tuple(want.shape)}")
        new[name] = torch.from_numpy(w)
    model.load_state_dict(new, strict=True)
    return model


def load_first_weights(model: nn.Module, loader, paths: Sequence[Optional[str]],
                       tag: str) -> bool:
    """Load the first of ``paths`` that exists and ``loader(path, model)``
    reads; an unreadable file is reported and the next one tried.  False
    when none loaded, leaving ``model`` as it was initialised."""
    for path in paths:
        if path and os.path.exists(path):
            try:
                loader(path, model)
            except Exception as e:  # noqa: BLE001 - any unreadable file means random features
                print(f"{tag}: failed to load weights from {path}: {e}")
                continue
            print(f"{tag}: loaded pretrained weights from {path}")
            return True
    return False


def _weights_search_paths() -> Sequence[str]:
    """Candidate weight files, resolved when called, relative to this
    checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return [
        os.environ.get("INCEPTION_WEIGHTS", ""),
        os.path.join(root, "weights", "inception_v3.npz"),
        os.path.join(root, "weights", "inception_v3.pth"),
    ]


def create_inception(weights_path: Optional[str] = None, seed: int = 0,
                     device=None) -> Tuple[InceptionV3Features, bool]:
    """The trunk in eval mode on ``device`` (default ``cuda``); returns
    ``(model, pretrained)``.  Weights come from ``weights_path`` or the
    first file found among ``INCEPTION_WEIGHTS``, ``weights/inception_v3.npz``
    and ``weights/inception_v3.pth``; a missing or unreadable file leaves
    the seeded random init (drawn on the CPU, so independent of the
    device) and ``pretrained=False``."""
    from ..config import resolve_device

    device = resolve_device("cuda" if device is None else device)
    with torch.device("meta"):
        model = InceptionV3Features()
    model.to_empty(device="cpu")
    _init_(model, torch.Generator().manual_seed(seed))
    pretrained = load_first_weights(model, load_torchvision_weights,
                                    [weights_path] if weights_path else _weights_search_paths(),
                                    "[fid] Inception")
    if not pretrained:
        print("[fid] no pretrained Inception weights found — using deterministic "
              "random features (FID values are self-consistent, not ImageNet-FID)")
    model = model.requires_grad_(False).to(device=device, memory_format=torch.channels_last)
    model.eval()
    return model, pretrained


def preprocess_for_inception(images: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, C]`` in [−1, 1] → ImageNet-normalised ``[N, 299, 299, 3]``
    on the images' device: to [0, 1], grey repeated to RGB, bilinear
    resize with half-pixel centres (``jax.image.resize``'s for upsampling),
    then the ImageNet mean and standard deviation."""
    x = (images.float() + 1.0) / 2.0
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(INPUT_SIZE, INPUT_SIZE),
                      mode="bilinear", align_corners=False, antialias=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return ((x - mean) / std).permute(0, 2, 3, 1)
