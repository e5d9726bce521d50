"""The class-conditional diffusion transformer (DiT) in plain PyTorch, as
functions of a dict of tensors by name.

The published model (Peebles & Xie, arXiv:2212.09748; github.com/
facebookresearch/DiT ``models.py``: ``DiT``, ``DiTBlock``, ``FinalLayer``,
``TimestepEmbedder``, ``LabelEmbedder``, ``get_2d_sincos_pos_embed``): the
latent cut into ``patch`` x ``patch`` patches by a stride-``patch``
convolution, plus a fixed 2-D sin-cos position table; the conditioning
``c = t_emb + y_emb``, ``t_emb`` the cos-then-sin embedding of 256
frequencies ``exp(-ln(1e4) i / 128)`` through Linear, SiLU, Linear, and
``y_emb`` a row of a table of the classes and, last, the null class;
``depth`` adaLN-Zero blocks::

    shift1, scale1, gate1, shift2, scale2, gate2 = Linear(SiLU(c))
    x += gate1 * Attn(LN(x) (1 + scale1) + shift1)
    x += gate2 * MLP(LN(x) (1 + scale2) + shift2)

with LayerNorm without affine at eps 1e-6, ``Attn`` a biased qkv linear,
``softmax(q k^T / sqrt(head_dim)) v`` over the heads written out (no fused
attention) and an output linear, and ``MLP`` Linear, GELU(tanh), Linear at
ratio 4; then the final layer (adaLN shift and scale, LN, Linear to
``patch^2 * 2C``) and the unpatchify.  The state-dict names are the
published model's.

Departures from the published model, as the benchmark runs it:

* every weight is seeded random (conv and linear weights and biases
  U(+-1/sqrt(fan_in)), the label table N(0, 1)), the adaLN and final
  linears included, which DiT initialises to zero: zero gates and a zero
  output would leave nothing to compare;
* the chain feeds its own step index of its T-step schedule as ``t``
  (DiT trained on 1000 steps and samples 250 respaced ones);
* the learned-variance half of the output is computed and unused (the
  engine's update has its own sigma), so the forward returns the first
  ``C`` channels;
* guidance, in the chain, applies to all ``C`` channels (DiT's
  ``forward_with_cfg`` guides the first three), and at scale 1.0 the chain
  is the unconditional one, the null class (DiT's ``sample.py`` samples
  conditionally at scale 1);
* no VAE: the chains and the metrics are over latents.

Conditioning as the program's engine gives it: a sample whose
``cond * mask > 0`` takes its label, every other the null class.
Inputs and outputs are NHWC.  Parameters are float32; the forward computes
in the precision the configuration states (``dtype``: under autocast for
bfloat16), and returns float32.  ``quant`` rounds the operands of every
matrix product, convolution and linear layer (the lower-precision control).
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FREQ_DIM = 256
LN_EPS = 1e-6


def sizes(depth: int, hidden: int, heads: int, patch: int = 2, channels: int = 4,
          input_size: int = 32, mlp_ratio: float = 4.0, num_classes: int = 1000,
          learn_sigma: bool = True) -> dict:
    """Everything the forward needs to know of a variant besides its weights."""
    return dict(depth=depth, hidden=hidden, heads=heads, patch=patch, channels=channels,
                input_size=input_size, mlp=int(hidden * mlp_ratio), num_classes=num_classes,
                out_channels=2 * channels if learn_sigma else channels)


def param_spec(s: dict) -> List[Tuple[str, tuple, object]]:
    """``[(name, shape, kind)]`` of the trainable tensors in state-dict
    order; ``kind`` is ``("uniform", fan_in)`` or ``"normal"``."""
    d, p, c = s["hidden"], s["patch"], s["channels"]
    spec = []

    def lin(name, fin, fout):
        spec.append((f"{name}.weight", (fout, fin), ("uniform", fin)))
        spec.append((f"{name}.bias", (fout,), ("uniform", fin)))

    spec.append(("x_embedder.proj.weight", (d, c, p, p), ("uniform", c * p * p)))
    spec.append(("x_embedder.proj.bias", (d,), ("uniform", c * p * p)))
    lin("t_embedder.mlp.0", FREQ_DIM, d)
    lin("t_embedder.mlp.2", d, d)
    spec.append(("y_embedder.embedding_table.weight", (s["num_classes"] + 1, d), "normal"))
    for i in range(s["depth"]):
        lin(f"blocks.{i}.attn.qkv", d, 3 * d)
        lin(f"blocks.{i}.attn.proj", d, d)
        lin(f"blocks.{i}.mlp.fc1", d, s["mlp"])
        lin(f"blocks.{i}.mlp.fc2", s["mlp"], d)
        lin(f"blocks.{i}.adaLN_modulation.1", d, 6 * d)
    lin("final_layer.linear", d, p * p * s["out_channels"])
    lin("final_layer.adaLN_modulation.1", d, 2 * d)
    return spec


def pos_embed(dim: int, grid: int) -> torch.Tensor:
    """``[1, grid*grid, dim]`` float32: ``get_2d_sincos_pos_embed`` (the
    first half of a row from the token's column, the second from its row,
    each ``[sin, cos]`` at frequencies ``1/10000^(2i/(dim/2))``), in
    float64 and then float32, as published."""
    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    cols, rows = np.meshgrid(g, g)
    table = np.concatenate([one_d(dim // 2, cols), one_d(dim // 2, rows)], axis=1)
    return torch.from_numpy(table).float().unsqueeze(0)


def timestep_embedding(t: torch.Tensor, dim: int = FREQ_DIM) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.reshape(-1).float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _identity(x):
    return x


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
            mask: torch.Tensor, labels: torch.Tensor, s: dict, *,
            pos: Optional[torch.Tensor] = None, quant: Optional[Callable] = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Predicted noise, float32 NHWC ``[B, H, W, C]`` (the first ``C`` of the
    output channels).  ``cond`` and ``mask`` are ``[B, 1]``, ``labels``
    ``[B]``; ``s`` is :func:`sizes`; ``pos`` the position table (default
    :func:`pos_embed`, made on ``x``'s device)."""
    if pos is None:
        pos = pos_embed(s["hidden"], s["input_size"] // s["patch"]).to(x.device)
    with torch.autocast(device_type=x.device.type, dtype=dtype,
                        enabled=dtype != torch.float32, cache_enabled=False):
        return _forward(p, x, t, cond, mask, labels, s, pos, quant or _identity)


def _forward(p, x, t, cond, mask, labels, s, pos, q):
    b, height, width, channels = x.shape
    d, heads, patch = s["hidden"], s["heads"], s["patch"]
    hd = d // heads

    def lin(name, h):
        return F.linear(q(h), q(p[f"{name}.weight"]), p[f"{name}.bias"])

    def norm(h):
        return F.layer_norm(h, (d,), eps=LN_EPS)

    def modulate(h, shift, scale):
        return h * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)

    null = torch.full((b,), s["num_classes"], dtype=torch.int64, device=x.device)
    take = cond.reshape(b).float() * mask.reshape(b).float() > 0
    y = torch.where(take, labels.reshape(b).to(torch.int64), null)

    h = F.conv2d(q(x.permute(0, 3, 1, 2)), q(p["x_embedder.proj.weight"]),
                 p["x_embedder.proj.bias"], stride=patch)
    h = h.flatten(2).transpose(1, 2) + pos
    n = h.shape[1]
    temb = lin("t_embedder.mlp.2", F.silu(lin("t_embedder.mlp.0", timestep_embedding(t))))
    c = temb + p["y_embedder.embedding_table.weight"][y]
    for i in range(s["depth"]):
        pre = f"blocks.{i}."
        shift1, scale1, gate1, shift2, scale2, gate2 = lin(
            pre + "adaLN_modulation.1", F.silu(c)).chunk(6, dim=1)
        a = modulate(norm(h), shift1, scale1)
        qh, kh, vh = lin(pre + "attn.qkv", a).reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        scores = torch.matmul(q(qh), q(kh).transpose(-2, -1)) * hd ** -0.5
        o = torch.matmul(q(torch.softmax(scores, dim=-1)), q(vh))
        h = h + gate1.unsqueeze(1) * lin(pre + "attn.proj", o.transpose(1, 2).reshape(b, n, d))
        m = modulate(norm(h), shift2, scale2)
        m = lin(pre + "mlp.fc2", F.gelu(lin(pre + "mlp.fc1", m), approximate="tanh"))
        h = h + gate2.unsqueeze(1) * m
    shift, scale = lin("final_layer.adaLN_modulation.1", F.silu(c)).chunk(2, dim=1)
    out = lin("final_layer.linear", modulate(norm(h), shift, scale))
    g, co = height // patch, s["out_channels"]
    out = out.reshape(b, g, g, patch, patch, co).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, height, width, co)
    return out[..., :channels].float().contiguous()


def make_weights(s: dict, seed: int, device,
                 into: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Seeded weights of every tensor of :func:`param_spec`, drawn in its
    order from one generator on the device, each tensor in place (no
    temporaries the size of the model): into new tensors, or into the
    float32 tensors of ``into`` (a model's state dict), which then hold the
    same numbers."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, shape, kind in param_spec(s):
        if into is None:
            w = torch.empty(shape, device=device)
        else:
            w = into[name]
            if tuple(w.shape) != tuple(shape) or w.dtype != torch.float32:
                raise ValueError(f"{name}: {tuple(w.shape)} {w.dtype}, the reference has "
                                 f"{tuple(shape)} float32")
        if kind == "normal":
            out[name] = w.normal_(generator=gen)
        else:
            bound = kind[1] ** -0.5
            out[name] = w.uniform_(-bound, bound, generator=gen)
    return out


def param_count(s: dict) -> int:
    """The trainable parameters of :func:`param_spec` (the position table,
    a fixed buffer, apart)."""
    return sum(int(np.prod(sh)) for _, sh, _ in param_spec(s))
