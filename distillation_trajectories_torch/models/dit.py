"""The class-conditional diffusion transformer (DiT; Peebles & Xie,
"Scalable Diffusion Models with Transformers", arXiv:2212.09748; code
github.com/facebookresearch/DiT ``models.py``) on the trajectory sweep.

The published forward: a 2x2 stride-2 patch embedding of the latent plus
the fixed 2-D sin-cos position table; the conditioning
``c = t_emb + y_emb`` (the cos-then-sin timestep embedding of 256
frequencies through Linear, SiLU, Linear, and a label table of 1000
classes plus the null class); ``depth`` adaLN-Zero blocks, each
``x += gate1 * Attn(LN(x) (1 + scale1) + shift1)`` and
``x += gate2 * MLP(LN(x) (1 + scale2) + shift2)`` with the six modulations
from ``Linear(SiLU(c))``, LayerNorm without affine at eps 1e-6, multi-head
attention with a biased qkv and an output projection, and a GELU(tanh) MLP
of ratio 4; the final adaLN layer and the unpatchify.  ``learn_sigma``
doubles the output channels: the samplers read the first ``C`` (the
predicted noise) and leave the variance half unused, since their update
has its own sigma; the teacher's train step reads both
(``forward(..., variance=True)``), as DiT's objective trains the variance.
Training drops each sample's class to the null class with probability
``class_dropout_prob`` (0.1; DiT's ``LabelEmbedder.token_drop``), from
uniforms the step draws (:meth:`DiT.drop_classes`).  State-dict names are
the published model's, bar ``pos_embed``, a buffer here (a frozen
parameter there).

The port's own choices: inputs and outputs NHWC, as the U-Net's; bf16
autocast over float32 weights (the port's compute lane); attention through
``F.scaled_dot_product_attention`` restricted to its fused backends
(flash, cuDNN, memory-efficient), so that a shape they refuse raises
rather than falling back to the math path; every weight seeded random
(:func:`init_dit_`), where DiT zero-inits the adaLN and final linears.

Conditioning through the engine's ``(cond, cond_mask)`` rows: a sample
whose ``cond * cond_mask > 0`` takes its label, every other the null
class.  So the CFG pair (0, 1) / (1, 1) is null against label, and the
no-CFG row (0, 0) the null class.

Two paths run a DiT: the sweep
(``trajectories/engine.py::sweep_compare_trajectories_multi``) and the
teacher's trainer (``training/teacher.py::train_teacher``, its step
``training/state.py::make_dit_teacher_train_step`` on the epoch lane).
The other paths built for the U-Net refuse one (:func:`require_unet`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.adaln import gate_add_ln_modulate, ln_modulate
from ..utils.profiling import span

# Published sizes (DiT models.py: DiT_XL_2, DiT_B_2, DiT_S_2).
DIT_VARIANTS: Dict[str, Dict[str, int]] = {
    "DiT-XL/2": dict(depth=28, hidden_size=1152, num_heads=16, patch_size=2),
    "DiT-B/2": dict(depth=12, hidden_size=768, num_heads=12, patch_size=2),
    "DiT-S/2": dict(depth=12, hidden_size=384, num_heads=6, patch_size=2),
}
NUM_CLASSES = 1000
FREQ_DIM = 256
CLASS_DROPOUT_PROB = 0.1  # DiT models.py: DiT(class_dropout_prob=0.1)


def _fused_backends():
    from torch.nn.attention import SDPBackend

    return [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
            SDPBackend.EFFICIENT_ATTENTION]


FUSED_SDPA = ("flash", "cudnn", "efficient")


def require_unet(obj, lane: str) -> None:
    """Raise ``ValueError`` where ``lane``, a path built for the U-Net, is
    handed a DiT: a model, or a ``Config`` whose ``architecture`` is not
    ``"unet"``."""
    arch = getattr(obj, "architecture", "unet")
    if arch != "unet":
        variant = getattr(obj, "variant", None)
        raise ValueError(f"{lane} runs the U-Net only; got architecture {arch!r}"
                         + (f" ({variant})" if variant else ""))


def timestep_embedding(t: torch.Tensor, dim: int = FREQ_DIM,
                       max_period: float = 10000.0) -> torch.Tensor:
    """``[cos(t f), sin(t f)]``, ``f_i = exp(-ln(max_period) i / (dim/2))``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.reshape(-1).float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sincos_pos_embed_2d(dim: int, grid: int) -> np.ndarray:
    """``[grid*grid, dim]`` float64: DiT's ``get_2d_sincos_pos_embed`` (the
    first half of each row from the column index, the second from the row,
    each ``[sin, cos]`` at ``1/10000^(2i/(dim/2))``)."""
    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    cols, rows = np.meshgrid(g, g)
    return np.concatenate([one_d(dim // 2, cols), one_d(dim // 2, rows)], axis=1)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_channels: int, hidden: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, hidden, patch, stride=patch)

    def forward(self, x_nchw: torch.Tensor) -> torch.Tensor:
        return self.proj(x_nchw).flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQ_DIM, hidden), nn.SiLU(), nn.Linear(hidden, hidden))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t))


class LabelEmbedder(nn.Module):
    """``num_classes`` rows and the null class's last."""

    def __init__(self, num_classes: int, hidden: int):
        super().__init__()
        self.embedding_table = nn.Embedding(num_classes + 1, hidden)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.embedding_table(labels)


class Attention(nn.Module):
    def __init__(self, hidden: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden // num_heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from torch.nn.attention import sdpa_kernel

        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        with sdpa_kernel(_fused_backends()):
            o = F.scaled_dot_product_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, hidden: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, inner)
        self.fc2 = nn.Linear(inner, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """One adaLN-Zero block's weights: :meth:`DiT.trunk` runs it, joined to
    its neighbours at the seams."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.attn = Attention(hidden, num_heads)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 6 * hidden))


class FinalLayer(nn.Module):
    """The final adaLN layer's weights: :meth:`DiT.trunk` ends in it."""

    def __init__(self, hidden: int, patch: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden, patch * patch * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 2 * hidden))


class DiT(nn.Module):
    """``forward(x [B,H,W,C], t [B], cond [B,1], cond_mask [B,1], labels
    [B])`` returns the predicted noise, float32 ``[B,H,W,C]``, contiguous:
    the first ``C`` of the ``2C`` output channels under ``learn_sigma``;
    with ``variance=True`` all ``2C`` (the noise, then the variance
    interpolation ``v``), as the trainer reads them.  ``labels`` (int, in
    ``[0, num_classes]``, the last the null class) are read where
    ``cond * cond_mask > 0``; the other samples, and all of them without
    ``labels`` or ``cond``, take the null class.

    On CUDA tensors the block's LayerNorm, modulate, gate and residual
    passes run in the fused kernels of :mod:`..ops.adaln`; where autograd
    records the forward (a train step), their backward is a kernel too.
    On CPU tensors they run in their plain versions (:meth:`trunk`).

    Each eager forward is one ``dit.forward`` span (variant, batch,
    tokens, heads, head_dim, backends, ``adaln``: "fused" or "plain", and
    ``grad``: whether autograd records it); a CUDA-graph replay runs no
    Python, so records none."""

    architecture = "dit"

    def __init__(self, input_size: int = 32, patch_size: int = 2, in_channels: int = 4,
                 hidden_size: int = 1152, depth: int = 28, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_classes: int = NUM_CLASSES,
                 learn_sigma: bool = True, class_dropout_prob: float = CLASS_DROPOUT_PROB,
                 dtype: torch.dtype = torch.float32, variant: Optional[str] = None):
        super().__init__()
        if input_size % patch_size or hidden_size % num_heads or hidden_size % 4:
            raise ValueError(f"DiT sizes do not fit: input {input_size}, patch {patch_size}, "
                             f"hidden {hidden_size}, heads {num_heads}")
        self.variant = variant or f"DiT-d{depth}-h{hidden_size}/{patch_size}"
        self.in_channels = in_channels
        self.out_channels = 2 * in_channels if learn_sigma else in_channels
        self.patch_size = patch_size
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.class_dropout_prob = class_dropout_prob
        self.dtype = dtype
        self.grid = input_size // patch_size
        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size)
        self.register_buffer("pos_embed", torch.from_numpy(
            sincos_pos_embed_2d(hidden_size, self.grid)).float().unsqueeze(0))
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels)

    def classes(self, cond, cond_mask, labels, b: int, device) -> torch.Tensor:
        """``[B]`` int64: each sample's label where ``cond * cond_mask > 0``,
        the null class (``num_classes``) elsewhere."""
        null = torch.full((b,), self.num_classes, dtype=torch.int64, device=device)
        if labels is None or cond is None:
            return null
        take = cond.reshape(b, -1)[:, 0].float()
        if cond_mask is not None:
            take = take * cond_mask.reshape(b).float()
        return torch.where(take > 0, labels.reshape(b).to(torch.int64), null)

    def drop_classes(self, labels: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
        """DiT's ``token_drop`` in training: ``labels`` with each sample whose
        uniform ``u`` (``[B]``, in [0, 1)) is below ``class_dropout_prob``
        set to the null class."""
        null = torch.full_like(labels, self.num_classes)
        return torch.where(uniforms < self.class_dropout_prob, null, labels)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, N, p*p*C']`` -> NHWC ``[B, H, W, C']``."""
        b, g, p, c = x.shape[0], self.grid, self.patch_size, self.out_channels
        x = x.reshape(b, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, g * p, g * p, c)

    def trunk(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """The blocks and the final layer on the ``[B, N, D]`` float32 token
        rows ``x`` under conditioning ``c``: the published block's
        arithmetic, with every modulation computed first (each depends on
        ``c`` alone), so that each seam, attention to MLP and one block's
        end to the next normalisation, is one gated add joined to the next
        LayerNorm and modulate (:mod:`..ops.adaln`, which updates ``x`` in
        place where autograd does not record it)."""
        mods = [block.adaLN_modulation(c).chunk(6, dim=1) for block in self.blocks]
        final = self.final_layer.adaLN_modulation(c).chunk(2, dim=1)
        h = ln_modulate(x, *mods[0][:2])
        for block, (_, _, gate1, shift2, scale2, gate2), (shift, scale, *_) in zip(
                self.blocks, mods, mods[1:] + [final]):
            # ``h`` names a branch's input, then its output: the input is
            # freed before the seam's pass.
            h = block.attn(h)
            x, h = gate_add_ln_modulate(x, h, gate1, shift2, scale2)
            h = block.mlp(h)
            x, h = gate_add_ln_modulate(x, h, gate2, shift, scale)
        return self.final_layer.linear(h)

    def forward(self, x, t, cond=None, cond_mask=None, labels=None, variance: bool = False):
        b = x.shape[0]
        if t.ndim > 1:
            t = t.reshape(b, -1)[:, 0]
        y = self.classes(cond, cond_mask, labels, b, x.device)
        with span("dit.forward", variant=self.variant, batch=b, tokens=self.grid ** 2,
                  heads=self.num_heads, head_dim=self.blocks[0].attn.head_dim,
                  backends=FUSED_SDPA, adaln="fused" if x.is_cuda else "plain",
                  grad=torch.is_grad_enabled()), \
                torch.autocast(device_type=x.device.type, dtype=self.dtype,
                               enabled=self.dtype != torch.float32, cache_enabled=False):
            h = self.x_embedder(x.permute(0, 3, 1, 2)) + self.pos_embed
            c = self.t_embedder(t) + self.y_embedder(y)
            out = self.unpatchify(self.trunk(h.contiguous(), c))
        if variance:
            return out.float().contiguous()
        return out[..., : self.in_channels].float().contiguous()


def init_dit_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, every one nonzero in law: conv and linear
    weights and biases U(+-1/sqrt(fan_in)) (torch's default), the label
    table N(0, 1); the position table stays the fixed sin-cos one."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(max(m.weight[0].numel(), 1))
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(generator=generator)
    return model


def make_dit(config, variant: str = "DiT-XL/2", device=None, seed: int = 0) -> DiT:
    """A DiT of the published ``variant`` (a key of :data:`DIT_VARIANTS`) on ``config.image_size`` /
    ``config.channels`` latents, at ``config.compute_dtype``, its weights
    drawn by :func:`init_dit_` from ``seed`` on ``device`` (default
    ``config.device``): a 675M-parameter model is drawn where it runs, so
    its weights depend on the device's generator."""
    from ..config import resolve_device

    if variant not in DIT_VARIANTS:
        raise ValueError(f"unknown DiT variant {variant!r}; have {sorted(DIT_VARIANTS)}")
    device = resolve_device(config.device if device is None else device)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    with torch.device("meta"):
        model = DiT(input_size=config.image_size, in_channels=config.channels, dtype=dtype,
                    variant=variant, **DIT_VARIANTS[variant])
    model.to_empty(device=device)
    model.pos_embed.copy_(torch.from_numpy(
        sincos_pos_embed_2d(model.pos_embed.shape[-1], model.grid)).float().unsqueeze(0))
    return init_dit_(model, torch.Generator(device=device).manual_seed(seed))
