"""Unified teacher/student diffusion U-Net (PyTorch port).

Port of ``distillation_trajectories_tpu/models/unet.py``.  Module names are
the reference torch model's (``time_mlp.1``, ``cond_emb.0``,
``{enc1..enc4,bottleneck,dec3,dec2,dec1,dec0}.{conv1,norm1,time_mlp,conv2,
norm2,residual_conv}``, ``final``), so a state dict from
``models/torch_port.py::unet_torch_state_dict_from_variables`` or from
:mod:`.convert` loads with ``strict=True``.

The public layout is NHWC in and out, as in the JAX package; inside, the
input is viewed as NCHW with channels-last strides (a free permute), which
is the layout cuDNN's fast convolutions take.  Parameters stay float32; the
convolutions and matmuls run in ``dtype`` under autocast (bf16 by default,
float32 is the parity mode), and the output is float32.

Train mode follows flax, not torch, where the two differ: BatchNorm
normalizes with the biased batch variance and also updates ``running_var``
with it (torch's ``BatchNorm2d`` would update it with the unbiased one), and
dropout (``nn.Dropout`` after every block, as at JAX ``unet.py:296-340``)
draws its masks from an explicit ``torch.Generator`` when one is given.
``remat`` recomputes each block's activations in the backward pass
(``torch.utils.checkpoint``), as JAX wraps each ``Block`` in ``nn.remat``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding, float32 ``[B, dim]``; odd ``dim`` is
    zero-padded."""
    dim = max(dim, 2)
    half_dim = max(dim // 2, 1)
    scale = math.log(10000.0) / (half_dim - 1 + 1e-8)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=t.device) * -scale
    )
    if t.ndim > 1:
        t = t.reshape(t.shape[0])
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if emb.shape[-1] < dim:
        emb = F.pad(emb, (0, dim - emb.shape[-1]))
    elif emb.shape[-1] > dim:
        emb = emb[:, :dim]
    return emb


def _align_corners_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """``[out, in]`` linear-interpolation weights of the align_corners=True
    map, computed in double precision and stored as float32.  (``F.interpolate``
    computes the source positions in float32, which moves the result by up
    to a few ulps of the input's range.)"""
    m = torch.zeros((out_size, in_size), dtype=torch.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m.float()
    for i in range(out_size):
        src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        lo = int(math.floor(src))
        hi = min(lo + 1, in_size - 1)
        m[i, lo] += 1.0 - (src - lo)
        m[i, hi] += src - lo
    return m.float()


def resize_bilinear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``size = (h, w)`` with
    ``align_corners=True``, as two interpolation-matrix products (rows, then
    columns), the JAX package's formulation."""
    mh = _align_corners_matrix(x.shape[1], int(size[0])).to(x.device, x.dtype)
    mw = _align_corners_matrix(x.shape[2], int(size[1])).to(x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("ow,bhwc->bhoc", mw, x).contiguous()


class SinusoidalPositionEmbeddings(nn.Module):
    """``time_mlp.0`` of the reference layout (no parameters)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return sinusoidal_time_embedding(t, self.dim)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode statistics.

    Eval mode is torch's own.  In train mode the fused kernel normalizes
    with the batch mean and biased variance (statistics in float32 also for
    bf16 input); given zeroed buffers and momentum 1 it writes the batch
    mean and the *unbiased* variance into them, and the running update here
    scales that back to the biased variance, as flax does (torch momentum
    0.1 is flax momentum 0.9).
    """

    def batch_stats(self, x: torch.Tensor):
        """Train-mode normalization with the batch statistics alone:
        ``(y, batch mean, unbiased batch variance)``; the running buffers
        are left as they are."""
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        return y, mean, var

    def update_running(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """The flax running update from :meth:`batch_stats` of ``n`` values
        per channel."""
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var * ((n - 1) / n), alpha=self.momentum
            )
            self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, var = self.batch_stats(x)
        self.update_running(mean, var, x.numel() // self.num_features)
        return y


def _norm(kind: str, ch: int) -> nn.Module:
    if kind == "group":
        # flax GroupNorm's epsilon is 1e-6 (torch's default is 1e-5).
        return nn.GroupNorm(min(32, ch), ch, eps=1e-6)
    if kind != "batch":
        raise ValueError(f"norm must be 'batch' or 'group', got {kind!r}")
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class Block(nn.Module):
    """conv3x3 → norm → ReLU → (+ ReLU'd time bias) → conv3x3 → norm → ReLU,
    plus the identity or 1×1-conv residual.

    With ``remat`` a train-mode forward that records gradients keeps only
    the block's inputs and recomputes the rest in the backward pass.  The
    recomputation runs train-mode BatchNorm again, so inside it the norms
    use the batch statistics alone; the running buffers take the first
    pass's statistics once, outside."""

    def __init__(self, in_ch: int, out_ch: int, time_emb_dim: int, norm: str,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm1 = _norm(norm, out_ch)
        self.time_mlp = nn.Linear(time_emb_dim, out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.norm2 = _norm(norm, out_ch)
        self.residual_conv = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def _body(self, x: torch.Tensor, temb: torch.Tensor, stats=None) -> torch.Tensor:
        """The block; with a ``stats`` list, BatchNorm normalizes with the
        batch statistics and appends them to it instead of updating its
        running buffers."""

        def norm(layer, h):
            if stats is None:
                return layer(h)
            y, mean, var = layer.batch_stats(h)
            stats.extend((mean, var))
            return y

        residual = x if self.residual_conv is None else self.residual_conv(x)
        h = F.relu(norm(self.norm1, self.conv1(x)))
        h = h + F.relu(self.time_mlp(temb))[:, :, None, None]
        h = F.relu(norm(self.norm2, self.conv2(h)))
        return h + residual

    def _body_with_stats(self, x: torch.Tensor, temb: torch.Tensor):
        stats = []
        return (self._body(x, temb, stats), *stats)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self._body(x, temb)
        if not isinstance(self.norm1, BatchNorm2d):
            return checkpoint(self._body, x, temb, use_reentrant=False)
        out, mean1, var1, mean2, var2 = checkpoint(
            self._body_with_stats, x, temb, use_reentrant=False)
        n = out.numel() // out.shape[1]
        self.norm1.update_running(mean1, var1, n)
        self.norm2.update_running(mean2, var2, n)
        return out


class DiffusionUNet(nn.Module):
    """Unified teacher/student U-Net; 32 → 16 → 8 → 4 → 2 → 4 → 8 → 16 → 32.

    ``forward(x [B,H,W,C], t [B], cond [B,1], cond_mask [B,1])`` returns ε̂
    as float32 ``[B,H,W,C]``, contiguous.  ``cond_mask=0`` reproduces the
    reference's ``cond=None`` pass; the cond MLP is always evaluated.  As in
    the reference, the enc1 skip is unused unless ``full_res_head``.

    In train mode each block's output goes through dropout with rate
    ``dropout``; ``generator`` (a ``torch.Generator`` on the input's device)
    draws the masks, so a train step can be replayed, and without one the
    global generator does.  Eval mode applies no dropout.  ``remat``
    recomputes each block in the backward pass (see :class:`Block`); the
    numbers do not change.
    """

    def __init__(
        self,
        channels: int = 3,
        size_factor: float = 1.0,
        dtype: torch.dtype = torch.float32,
        norm: str = "batch",
        full_res_head: bool = False,
        dropout: float = 0.0,
        remat: bool = False,
    ):
        super().__init__()
        self.channels = channels
        self.size_factor = size_factor
        self.dtype = dtype
        self.drop = nn.Dropout(dropout)
        ted = self.time_emb_dim
        d0, d1, d2, d3 = self.dims

        self.time_mlp = nn.Sequential(
            SinusoidalPositionEmbeddings(ted), nn.Linear(ted, ted), nn.ReLU()
        )
        self.cond_emb = nn.Sequential(nn.Linear(1, ted), nn.ReLU(), nn.Linear(ted, ted))
        block = lambda i, o: Block(i, o, ted, norm, remat)
        self.enc1 = block(channels, d0)
        self.enc2 = block(d0, d1)
        self.enc3 = block(d1, d2)
        self.enc4 = block(d2, d3)
        self.bottleneck = block(d3, d3)
        self.dec3 = block(2 * d3, d2)
        self.dec2 = block(2 * d2, d1)
        self.dec1 = block(2 * d1, d0)
        self.dec0 = block(2 * d0, d0) if full_res_head else None
        self.final = nn.Conv2d(d0, channels, 1)

    @property
    def time_emb_dim(self) -> int:
        return max(int(256 * self.size_factor), 16)

    @property
    def base_channels(self) -> int:
        return max(int(128 * self.size_factor), 16)

    @property
    def dims(self):
        base = self.base_channels
        return [max(16, int(base * m)) for m in (1, 2, 2, 2)]

    def _dropout(self, h: torch.Tensor, generator) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1-p, scale by 1/(1-p)."""
        if not self.training or self.drop.p == 0.0:
            return h
        if generator is None:
            return self.drop(h)
        keep = 1.0 - self.drop.p
        mask = torch.empty_like(h).bernoulli_(keep, generator=generator)
        return h / keep * mask

    def forward(self, x, t, cond=None, cond_mask=None, generator=None):
        b = x.shape[0]
        if t.ndim > 1:
            t = t.reshape(b, -1)[:, 0]
        if cond is None:
            cond_in = x.new_zeros((b, 1), dtype=torch.float32)
            mask = x.new_zeros((b, 1), dtype=torch.float32)
        else:
            cond_in = cond.reshape(b, -1)[:, :1].float()
            mask = (
                x.new_ones((b, 1), dtype=torch.float32)
                if cond_mask is None
                else cond_mask.reshape(b, 1).float()
            )
        up = lambda h: F.interpolate(
            h, scale_factor=2, mode="bilinear", align_corners=True
        )
        pool = lambda h: F.max_pool2d(h, 2, 2)
        drop = lambda h: self._dropout(h, generator)
        with torch.autocast(
            device_type=x.device.type,
            dtype=self.dtype,
            enabled=self.dtype != torch.float32,
        ):
            temb = self.time_mlp(t) + mask * self.cond_emb(cond_in)
            h = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels-last strides
            x1 = drop(self.enc1(h, temb))
            x2 = drop(self.enc2(pool(x1), temb))
            x3 = drop(self.enc3(pool(x2), temb))
            x4 = drop(self.enc4(pool(x3), temb))
            h = drop(self.bottleneck(pool(x4), temb))
            h = drop(self.dec3(torch.cat([up(h), x4], dim=1), temb))
            h = drop(self.dec2(torch.cat([up(h), x3], dim=1), temb))
            h = drop(self.dec1(torch.cat([up(h), x2], dim=1), temb))
            h = up(h)
            if self.dec0 is not None:
                h = drop(self.dec0(torch.cat([h, x1], dim=1), temb))
            out = self.final(h)
        return out.float().permute(0, 2, 3, 1).contiguous()


def init_unet_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Reference (torch default) init from an explicit generator:
    conv/linear weights and biases U(±1/√fan_in); norms at scale 1, bias 0,
    running mean 0 and variance 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(max(m.weight[0].numel(), 1))
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.reset_parameters()
    return model


def make_unet(config, size_factor: float = 1.0, device=None, seed: int = 0):
    """Build a U-Net from a Config (channels, dropout, compute dtype, norm,
    head, remat), initialised from ``seed`` on the CPU (so the weights do not
    depend on the device) and moved to ``device`` (default
    ``config.device``) in channels-last layout."""
    from ..config import resolve_device

    device = resolve_device(config.device if device is None else device)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    with torch.device("meta"):
        model = DiffusionUNet(
            channels=config.channels,
            size_factor=size_factor,
            dtype=dtype,
            norm=config.norm,
            full_res_head=bool(config.full_res_head),
            dropout=config.dropout,
            remat=bool(getattr(config, "remat", False)),
        )
    model.to_empty(device="cpu")
    init_unet_(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, memory_format=torch.channels_last)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def param_size_mb(model: nn.Module) -> float:
    """Model size in MB at float32 storage."""
    return param_count(model) * 4 / (1024 * 1024)


def SimpleUNet(config, **kwargs) -> DiffusionUNet:
    """The reference's teacher name: ``make_unet`` at size_factor 1.0."""
    return make_unet(config, size_factor=1.0, **kwargs)


def StudentUNet(config, size_factor: float = 1.0, architecture_type=None, **kwargs) -> DiffusionUNet:
    """The reference's student name; ``architecture_type`` is ignored, as
    in the JAX package."""
    return make_unet(config, size_factor=size_factor, **kwargs)
