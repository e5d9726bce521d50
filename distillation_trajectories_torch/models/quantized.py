"""int8 quantized-inference lane of the U-Net sampler (port of
``distillation_trajectories_tpu/models/quantized.py``).

Inference only, opt-in (``Config.sampler_quant="int8"``):

* **BatchNorm folding**: eval BatchNorm is the per-channel affine
  ``(x − μ)·γ/√(σ² + ε) + β``, folded into the conv before it (kernel
  scaled, bias adjusted), with the running statistics the port's eval-mode
  ``BatchNorm2d`` uses.
* **Weights**: per-output-channel symmetric int8, ``s_w[o] = max|W[..,o]|/127``.
* **Activations**: per-tensor symmetric int8, with a dynamic scale
  ``max|x|/127`` computed at every conv input, or a static host-float scale
  from :func:`calibrate_activation_scales`.
* **Mixed precision**: ``quant_blocks`` keeps int8 to a subset of Blocks;
  the rest run the folded float path in the model dtype.
* **The convolution**: PyTorch has no int8 convolution on CUDA, so a conv
  is an im2col of the int8 activation (NHWC, taps ordered as the HWIO
  kernel) and one ``torch._int_mm`` int8 × int8 → int32 product,
  dequantized as ``acc · (s_x · s_w[o]) + b_folded[o]``.  int32 accumulation
  is exact (max |acc| ≤ 127²·9·C_in ≪ 2³¹), so given equal int8 operands
  the accumulators equal the JAX package's (an XLA int8 convolution) bit
  for bit.  ``torch._int_mm`` on CUDA takes more than 16 rows and K, N
  multiples of 8, and on an H100 cuBLASLt refused
  (``CUBLAS_STATUS_NOT_SUPPORTED``) small products with both operands
  row-major (M = 17 or 24 at K = 32): the int8 kernel is stored so that its
  ``[K, N]`` matrix is column-major, the layout cuBLASLt's int8 kernels
  take, and :func:`int8_matmul` pads M to a multiple of 8 of at least 32
  and K, N to multiples of 8 with zeros, which change no sum.  It does so
  on every device, so the CPU runs the same padded path as the card.

Only the Block convs (conv1/conv2 3×3 and the 1×1 residual projection) are
quantized; the time/cond MLPs, the upsampling and the final 1×1 conv stay in
the model dtype.  The fold and quantization run once, when the eval
function is built (:func:`make_quantized_eval_fn`): later changes to the
model's weights are not seen by that function.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .dit import require_unet
from .unet import DiffusionUNet, sinusoidal_time_embedding

_BN_EPS = 1e-5  # the Block BatchNorm2d's eps
_INT_MM_MIN_ROWS = 32  # torch._int_mm on CUDA: M > 16; small M is refused
_INT_MM_ALIGN = 8  # torch._int_mm on CUDA: M, K and N multiples of 8


def _block_names(model: DiffusionUNet):
    names = ["enc1", "enc2", "enc3", "enc4", "bottleneck", "dec3", "dec2", "dec1"]
    if model.dec0 is not None:
        names.append("dec0")
    return names


def _quant_weight(w: torch.Tensor, nbits: Optional[int]) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric quantization of an HWIO kernel;
    ``nbits=None`` keeps the float kernel (the fold-only twin).  The int8
    kernel is an HWIO view of OHWI memory, so its ``[K, N]`` matrix is a
    column-major view (see :func:`int8_matmul`)."""
    if nbits is None:
        return {"w": w, "scale": torch.ones((w.shape[-1],), dtype=torch.float32, device=w.device)}
    qmax = float(2 ** (nbits - 1) - 1)
    s = w.abs().amax(dim=(0, 1, 2)) / qmax
    s = torch.clamp(s.float(), min=1e-12)
    wq = torch.clamp(torch.round(w / s), -qmax, qmax).to(torch.int8)
    return {"w_int8": wq.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0), "scale": s}


def _hwio(conv: torch.nn.Conv2d) -> torch.Tensor:
    return conv.weight.detach().float().permute(2, 3, 1, 0).contiguous()


@torch.no_grad()
def quantize_unet_variables(
    model: DiffusionUNet,
    nbits: Optional[int] = 8,
    quant_blocks: Optional[set] = None,
) -> Dict[str, Any]:
    """Fold eval-mode BatchNorm into the Block convs of ``model`` (its
    parameters and buffers) and quantize them.

    Returns the JAX package's tree: ``blocks/{name}/{conv1,conv2,residual}``
    hold an HWIO ``w_int8`` (or float ``w`` where the Block stays float)
    with its ``scale`` ``[O]`` and folded ``bias``; ``time_mlp``,
    ``time_dense``, ``cond_dense1``, ``cond_dense2`` and ``final`` hold the
    torch ``weight``/``bias``.  ``nbits=None`` gives the folded float tree
    (the exactness twin of the plain forward).
    """
    if not isinstance(model.enc1.norm1, torch.nn.BatchNorm2d):
        raise ValueError(
            "sampler_quant requires norm='batch': GroupNorm is input-"
            "dependent and cannot be folded into the conv at inference"
        )
    dense = lambda m: {"weight": m.weight.detach(), "bias": m.bias.detach()}
    out: Dict[str, Any] = {
        "time_dense": dense(model.time_mlp[1]),
        "cond_dense1": dense(model.cond_emb[0]),
        "cond_dense2": dense(model.cond_emb[2]),
        "final": dense(model.final),
        "blocks": {},
    }
    for name in _block_names(model):
        block = getattr(model, name)
        blk_nbits = nbits if quant_blocks is None or name in quant_blocks else None
        blk: Dict[str, Any] = {"time_mlp": dense(block.time_mlp)}
        for conv_name, norm_name in (("conv1", "norm1"), ("conv2", "norm2")):
            conv, norm = getattr(block, conv_name), getattr(block, norm_name)
            f = norm.weight.float() * torch.rsqrt(norm.running_var.float() + _BN_EPS)
            w = _hwio(conv) * f
            b = (conv.bias.float() - norm.running_mean.float()) * f + norm.bias.float()
            q = _quant_weight(w, blk_nbits)
            q["bias"] = b
            blk[conv_name] = q
        if block.residual_conv is not None:  # 1×1 projection, no BN to fold
            q = _quant_weight(_hwio(block.residual_conv), blk_nbits)
            q["bias"] = block.residual_conv.bias.detach().float()
            blk["residual"] = q
        out["blocks"][name] = blk
    return out


def _aquant(x: torch.Tensor, static_scale: Optional[float] = None):
    """Per-tensor symmetric int8 activation quantization: ``(x_int8, s)``,
    ``s`` a 0-d float32 tensor (dynamic) or the host float ``static_scale``."""
    if static_scale is not None:
        s = max(float(static_scale), 1e-12)
    else:
        s = torch.clamp(x.abs().amax().float() / 127.0, min=1e-12)
    xq = torch.clamp(torch.round(x.float() / s), -127.0, 127.0)
    return xq.to(torch.int8), s


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8 -> [M, N] int32`` through
    ``torch._int_mm``: ``a`` row-major and ``b`` column-major (the layout
    cuBLASLt's int8 kernels take; copied into it when it is not), both
    zero-padded to M ≥ 32 and M, K, N multiples of 8 on every device, and
    the product sliced back."""
    m, k = a.shape
    n = b.shape[1]
    mp = max(_round_up(m, _INT_MM_ALIGN), _INT_MM_MIN_ROWS)
    kp, np_ = _round_up(k, _INT_MM_ALIGN), _round_up(n, _INT_MM_ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    if not b.t().is_contiguous():
        b = b.t().contiguous().t()
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def _im2col(xq: torch.Tensor, kh: int, kw: int, pad: int) -> torch.Tensor:
    """``[B·H·W, kh·kw·C]`` patches of an NHWC tensor (stride 1, ``pad``
    zeros each side), taps ordered (kh, kw, C) as an HWIO kernel."""
    b, h, w, c = xq.shape
    if kh == kw == 1 and pad == 0:
        return xq.reshape(b * h * w, c)
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
    patches = xp.unfold(1, kh, 1).unfold(2, kw, 1)  # [B, H, W, C, kh, kw]
    return patches.permute(0, 1, 2, 4, 5, 3).reshape(b * h * w, kh * kw * c)


def _qconv(q: Dict[str, Any], xq: torch.Tensor, s_x, padding: int,
           dtype=torch.float32) -> torch.Tensor:
    """int8 × int8 → int32 conv of NHWC ``xq`` dequantized to float32 (plus
    the folded bias).

    Where the Block stays float (``w`` instead of ``w_int8``), ``xq`` is the
    float activation and ``s_x`` None: a ``dtype`` conv over the folded
    kernel, rounded to float32."""
    if "w_int8" in q:
        wq = q["w_int8"]
        kh, kw, cin, cout = wq.shape
        b, h, w, _ = xq.shape
        acc = int8_matmul(_im2col(xq, kh, kw, padding), wq.reshape(kh * kw * cin, cout))
        out = acc.reshape(b, h, w, cout).float() * (s_x * q["scale"])
    else:
        x = xq.to(dtype).permute(0, 3, 1, 2)
        out = F.conv2d(x, q["w"].to(dtype).permute(3, 2, 0, 1), padding=padding)
        out = out.float().permute(0, 2, 3, 1)
    return out + q["bias"]


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor, dtype) -> torch.Tensor:
    """``nn.Linear`` with its input and parameters cast to ``dtype``."""
    return F.linear(x.to(dtype), p["weight"].to(dtype), p["bias"].to(dtype))


def _qblock(
    blk: Dict[str, Any],
    x: torch.Tensor,
    temb: torch.Tensor,
    dtype,
    scales: Optional[Dict[str, float]] = None,
    collect: Optional[Dict[str, torch.Tensor]] = None,
    name: str = "",
) -> torch.Tensor:
    """Quantized Block forward (eval semantics of :class:`..unet.Block`) on
    NHWC ``x``.

    ``scales``: static activation scales ``{"in": s, "mid": s}`` (host
    floats).  ``collect``: a dict that receives ``max|activation|`` at both
    quant sites, the calibration hook of :func:`calibrate_activation_scales`.
    """
    quant = "w_int8" in blk["conv1"]
    if collect is not None:
        collect[f"{name}:in"] = x.abs().amax().float()
    s_in = scales.get("in") if scales else None
    xq, s_x = _aquant(x, s_in) if quant else (x, None)
    if "residual" in blk:
        residual = _qconv(blk["residual"], xq, s_x, 0, dtype)
    else:
        residual = x.float()
    h = F.relu(_qconv(blk["conv1"], xq, s_x, 1, dtype))
    t_bias = F.relu(_dense(blk["time_mlp"], temb, dtype)).float()
    h = h + t_bias[:, None, None, :]
    if collect is not None:
        collect[f"{name}:mid"] = h.abs().amax().float()
    s_mid = scales.get("mid") if scales else None
    hq, s_h = _aquant(h, s_mid) if quant else (h, None)
    h = F.relu(_qconv(blk["conv2"], hq, s_h, 1, dtype))
    return (h + residual).to(dtype)


def _pool(h: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _upsample(h: torch.Tensor) -> torch.Tensor:
    """×2 bilinear, align_corners=True, in float32 as the plain forward's
    ``F.interpolate`` runs under autocast; returned in ``h``'s dtype."""
    up = F.interpolate(h.float().permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                       align_corners=True)
    return up.permute(0, 2, 3, 1).to(h.dtype)


@torch.no_grad()
def quantized_unet_apply(
    model: DiffusionUNet,
    qvars: Dict[str, Any],
    x: torch.Tensor,
    t: torch.Tensor,
    cond: Optional[torch.Tensor] = None,
    cond_mask: Optional[torch.Tensor] = None,
    act_scales: Optional[Dict[str, Dict[str, float]]] = None,
    collect: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Eval forward of NHWC ``x`` over a folded / quantized tree: float32
    ``[B, H, W, C]``.

    Mirrors :meth:`..unet.DiffusionUNet.forward` in eval mode (the same
    pool, upsampling, concat order, unused enc1 skip and optional ``dec0``);
    the activations are NHWC and cast as the JAX package's quantized
    forward casts them (model dtype between blocks, float32 at the quant
    sites).  ``act_scales``: static scales ``{block: {"in": s, "mid": s}}``.
    ``collect``: the calibration hook (see :func:`_qblock`).
    """
    dtype = model.dtype
    b = x.shape[0]
    x = x.to(dtype)
    blocks = qvars["blocks"]

    if t.ndim > 1:
        t = t.reshape(b, -1)[:, 0]
    temb = sinusoidal_time_embedding(t, model.time_emb_dim).to(dtype)
    temb = F.relu(_dense(qvars["time_dense"], temb, dtype))
    if cond is None:
        cond_in = x.new_zeros((b, 1), dtype=dtype)
        mask = x.new_zeros((b, 1), dtype=dtype)
    else:
        cond_in = cond.reshape(b, -1)[:, :1].to(dtype)
        mask = (x.new_ones((b, 1), dtype=dtype) if cond_mask is None
                else cond_mask.reshape(b, 1).to(dtype))
    cemb = F.relu(_dense(qvars["cond_dense1"], cond_in, dtype))
    cemb = _dense(qvars["cond_dense2"], cemb, dtype)
    temb = temb + mask * cemb

    def qb(name, h_in):
        return _qblock(blocks[name], h_in, temb, dtype,
                       scales=(act_scales or {}).get(name), collect=collect, name=name)

    x1 = qb("enc1", x)
    x2 = qb("enc2", _pool(x1))
    x3 = qb("enc3", _pool(x2))
    x4 = qb("enc4", _pool(x3))
    h = qb("bottleneck", _pool(x4))
    h = qb("dec3", torch.cat([_upsample(h), x4], dim=-1))
    h = qb("dec2", torch.cat([_upsample(h), x3], dim=-1))
    h = qb("dec1", torch.cat([_upsample(h), x2], dim=-1))
    h = _upsample(h)
    if "dec0" in blocks:
        h = qb("dec0", torch.cat([h, x1], dim=-1))

    fin = qvars["final"]
    out = F.conv2d(h.to(dtype).permute(0, 3, 1, 2), fin["weight"].to(dtype),
                   fin["bias"].to(dtype))
    return out.float().permute(0, 2, 3, 1).contiguous()


def make_quantized_eval_fn(
    model: DiffusionUNet,
    nbits: Optional[int] = 8,
    act_scales: Optional[Dict[str, Dict[str, float]]] = None,
    quant_blocks: Optional[set] = None,
):
    """Drop-in for :func:`..training.state.make_eval_model_fn` with the
    Block convs int8: ``(x, t, cond=None, cond_mask=None) -> ε̂``.

    The fold and quantization of ``model``'s current weights happen here,
    once.  ``act_scales`` switches the activations to static calibrated
    scales (host floats, :func:`calibrate_activation_scales`);
    ``quant_blocks`` keeps int8 to that subset of Blocks.
    """
    require_unet(model, "the int8 lane")
    qvars = quantize_unet_variables(model, nbits=nbits, quant_blocks=quant_blocks)

    def model_fn(x, t, cond=None, cond_mask=None):
        return quantized_unet_apply(model, qvars, x, t, cond, cond_mask, act_scales=act_scales)

    return model_fn


def calibrate_activation_scales(
    model: DiffusionUNet,
    xs: torch.Tensor,
    ts: torch.Tensor,
    conds: Optional[torch.Tensor] = None,
    cond_masks: Optional[torch.Tensor] = None,
    margin: float = 1.0,
) -> Dict[str, Dict[str, float]]:
    """Static per-site activation scales from a calibration set.

    ``xs``/``ts`` (and optional ``conds``/``cond_masks``) carry a leading
    calibration axis; for each entry the fold-only forward records
    ``max|activation|`` at every quant site, and a site's scale is
    ``margin · max / 127`` over the set (at least 1e-12), returned as host
    floats.  Calibrate on states that span the sampler's t-range:
    activations grow toward the noisy end of the chain, and values above
    ``s·127`` at run time clip.
    """
    device = next(model.parameters()).device
    q_float = quantize_unet_variables(model, nbits=None)
    agg: Dict[str, float] = {}
    for i in range(xs.shape[0]):
        rec: Dict[str, torch.Tensor] = {}
        pick = lambda a: None if a is None else torch.as_tensor(a[i]).to(device)
        quantized_unet_apply(model, q_float, pick(xs), pick(ts), pick(conds), pick(cond_masks),
                             collect=rec)
        values = torch.stack(list(rec.values())).cpu().tolist()  # one host transfer
        for k, v in zip(rec, values):
            agg[k] = max(agg.get(k, 0.0), float(v))
    scales: Dict[str, Dict[str, float]] = {}
    for k, v in agg.items():
        name, site = k.split(":")
        scales.setdefault(name, {})[site] = float(max(margin * v / 127.0, 1e-12))
    return scales
