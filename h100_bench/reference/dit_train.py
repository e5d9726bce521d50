"""DiT's teacher training step in plain PyTorch: the loss, its gradients,
Adam and the EMA, as functions of a dict of tensors by name.

The published step (facebookresearch/DiT ``train.py``, ``models.py``
``LabelEmbedder.token_drop``, ``diffusion/gaussian_diffusion.py``
``training_losses`` and ``_vb_terms_bpd``, ``diffusion/diffusion_utils.py``
``normal_kl`` and ``discretized_gaussian_log_likelihood``; IDDPM's hybrid
objective), per sample::

    t ~ U{0..T-1},  ε ~ N(0, I),  y -> null class where u < 0.1
    x_t = sqrt(ac_t) x_0 + sqrt(1 - ac_t) ε
    [ε̂, v] = DiT(x_t, t, y)                     (the 2C output channels)
    mse = mean (ε - ε̂)^2
    vb  = mean KL(N(μ̃, β̃_t) || N(μ_θ, σ²_θ)) / ln 2    (t > 0), with ε̂ detached:
          μ̃ = c1_t x_0 + c2_t x_t, log β̃ clipped (β̃_1 for β̃_0);
          x̂_0 = sqrt(1/ac_t) x_t - sqrt(1/ac_t - 1) ε̂,  μ_θ = c1_t x̂_0 + c2_t x_t,
          log σ²_θ = f log β_t + (1 - f) log β̃_t,  f = (v + 1) / 2
        = -mean log p(x_0) / ln 2                    (t = 0): the Gaussian of
          mean μ_θ, log-scale log σ²_θ / 2, binned at 2/255 (tanh form of Φ)
    loss = mean over the batch of (mse + vb)

then Adam (β 0.9 / 0.999, eps 1e-8; DiT's AdamW at weight decay 0 is the
same update) at the configuration's learning rate, and the EMA
``ema <- rate ema + (1 - rate) θ``.  The schedule (linear β over T steps,
scaled by 1000 / T) and its tables are computed in float64 and cast to
float32, as DiT's ``_extract_into_tensor`` does.  A step's draws come from
the trainer's generator in its documented order: ``t``, ``ε``, the class
dropout's uniforms.

The forward is :mod:`.dit`'s (the same weights by name, position table,
timestep embedding, written-out softmax), returning both output halves:
``dit.forward`` returns the noise half alone.

Departures from the published run, as the benchmark runs it: every weight
seeded random, the adaLN and final linears included, which DiT
initialises to zero (zero gates and a zero output would leave nothing to
compare); latents drawn, not encoded by the VAE; the program computes
under bf16 autocast with float32 weights and Adam (DiT trains in float32),
the reference in float32 with TF32 off (the caller's
``compare.float32_exact``).  On the card a step's loss and gradients may
be computed in blocks of samples (``block``), each block's share of the
batch mean summed, so that DiT-XL/2 at batch 32 fits beside nothing else.
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import dit as ref_dit

CLASS_DROPOUT_PROB = 0.1


def schedule(timesteps: int, beta_start: float, beta_end: float) -> Dict[str, np.ndarray]:
    """The tables the objective gathers by ``t``, float64 cast to float32."""
    scale = 1000.0 / timesteps
    betas = np.linspace(scale * beta_start, scale * beta_end, timesteps, dtype=np.float64)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    out = {"sqrt_ac": np.sqrt(ac), "sqrt_omac": np.sqrt(1.0 - ac),
           "sqrt_recip_ac": np.sqrt(1.0 / ac), "sqrt_recipm1_ac": np.sqrt(1.0 / ac - 1),
           "coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
           "coef2": (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
           "log_var_clipped": np.log(np.append(post_var[1], post_var[1:])),
           "log_betas": np.log(betas)}
    return {k: v.astype(np.float32) for k, v in out.items()}


def step_draws(gen: torch.Generator, batch: int, shape, timesteps: int, device):
    """A step's ``t``, ``ε`` and the class dropout's uniforms, in that order."""
    t = torch.randint(0, timesteps, (batch,), generator=gen, device=device)
    noise = torch.randn((batch, *shape), generator=gen, device=device)
    u = torch.rand((batch,), generator=gen, device=device)
    return t, noise, u


def drop_classes(labels: torch.Tensor, u: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``token_drop``: the null class where ``u < 0.1``."""
    return torch.where(u < CLASS_DROPOUT_PROB, torch.full_like(labels, num_classes), labels)


def forward(p, x, t, y, s, pos, quant: Optional[Callable] = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Both output halves, float32 NHWC ``[B, H, W, 2C]``, of the DiT of
    sizes ``s`` (:func:`.dit.sizes`) on classes ``y`` (the null class is
    ``num_classes``)."""
    q = quant or (lambda a: a)
    with torch.autocast(device_type=x.device.type, dtype=dtype,
                        enabled=dtype != torch.float32, cache_enabled=False):
        b, height, width, _ = x.shape
        d, heads, patch = s["hidden"], s["heads"], s["patch"]
        hd = d // heads

        def lin(name, h):
            return F.linear(q(h), q(p[f"{name}.weight"]), p[f"{name}.bias"])

        def modulate(h, shift, scale):
            return F.layer_norm(h, (d,), eps=ref_dit.LN_EPS) * (1 + scale.unsqueeze(1)) \
                + shift.unsqueeze(1)

        h = F.conv2d(q(x.permute(0, 3, 1, 2)), q(p["x_embedder.proj.weight"]),
                     p["x_embedder.proj.bias"], stride=patch)
        h = h.flatten(2).transpose(1, 2) + pos
        n = h.shape[1]
        temb = lin("t_embedder.mlp.2",
                   F.silu(lin("t_embedder.mlp.0", ref_dit.timestep_embedding(t))))
        c = temb + p["y_embedder.embedding_table.weight"][y]
        for i in range(s["depth"]):
            pre = f"blocks.{i}."
            shift1, scale1, gate1, shift2, scale2, gate2 = lin(
                pre + "adaLN_modulation.1", F.silu(c)).chunk(6, dim=1)
            a = modulate(h, shift1, scale1)
            qh, kh, vh = lin(pre + "attn.qkv", a).reshape(b, n, 3, heads, hd).permute(
                2, 0, 3, 1, 4)
            scores = torch.matmul(q(qh), q(kh).transpose(-2, -1)) * hd ** -0.5
            o = torch.matmul(q(torch.softmax(scores, dim=-1)), q(vh))
            h = h + gate1.unsqueeze(1) * lin(pre + "attn.proj", o.transpose(1, 2).reshape(b, n, d))
            m = lin(pre + "mlp.fc2",
                    F.gelu(lin(pre + "mlp.fc1", modulate(h, shift2, scale2)), approximate="tanh"))
            h = h + gate2.unsqueeze(1) * m
        shift, scale = lin("final_layer.adaLN_modulation.1", F.silu(c)).chunk(2, dim=1)
        out = lin("final_layer.linear", modulate(h, shift, scale))
        g, co = height // patch, s["out_channels"]
        out = out.reshape(b, g, g, patch, patch, co).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, height, width, co).float()


def _cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3))))


def _log_likelihood(x, means, log_scales):
    centred = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _cdf(inv_stdv * (centred + 1.0 / 255.0))
    cdf_min = _cdf(inv_stdv * (centred - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_probs = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_probs))


def loss_terms(out, x0, x_t, t, noise, tab):
    """``(mse, vb)`` ``[B]`` of the model output ``out`` (``[B, H, W, 2C]``)."""
    c = x0.shape[-1]
    eps, v = out[..., :c], out[..., c:]
    at = lambda k: tab[k][t].view(-1, 1, 1, 1)
    mean_flat = lambda a: a.mean(dim=(1, 2, 3))
    mse = mean_flat((noise - eps) ** 2)
    true_mean = at("coef1") * x0 + at("coef2") * x_t
    true_logvar = at("log_var_clipped")
    frac = (v + 1) / 2
    logvar = frac * at("log_betas") + (1 - frac) * true_logvar
    x0_hat = at("sqrt_recip_ac") * x_t - at("sqrt_recipm1_ac") * eps.detach()
    mean = at("coef1") * x0_hat + at("coef2") * x_t
    kl = 0.5 * (-1.0 + logvar - true_logvar + torch.exp(true_logvar - logvar)
                + (true_mean - mean) ** 2 * torch.exp(-logvar))
    kl = mean_flat(kl) / math.log(2.0)
    nll = -mean_flat(_log_likelihood(x0, mean, 0.5 * logvar)) / math.log(2.0)
    return mse, torch.where(t == 0, nll, kl)


class DiTTeacherSteps:
    """Follows a DiT teacher's trainer from its initial weights through its
    first steps.  ``gen`` is the trainer's draw generator, seeded as the
    trainer seeds it.  ``block`` (default the batch) samples at a time go
    through the forward and backward.  ``half_batch`` (a fault control)
    takes the loss over the first half of the batch alone.  ``first_grads``
    holds the first step's gradients, ``ema`` (with ``ema_rate``) the
    EMA."""

    def __init__(self, weights: Dict[str, torch.Tensor], s: dict, tab: Dict[str, np.ndarray],
                 timesteps: int, lr: float, gen: torch.Generator,
                 quant: Optional[Callable] = None, half_batch: bool = False,
                 dtype: torch.dtype = torch.float32, block: Optional[int] = None,
                 ema_rate: Optional[float] = None):
        self.params = {k: v.detach().clone().float().requires_grad_() for k, v in weights.items()}
        dev = next(iter(self.params.values())).device
        self.s, self.T, self.lr, self.gen = s, timesteps, lr, gen
        self.quant, self.half_batch, self.dtype, self.block = quant, half_batch, dtype, block
        self.tab = {k: torch.from_numpy(v).to(dev) for k, v in tab.items()}
        self.pos = ref_dit.pos_embed(s["hidden"], s["input_size"] // s["patch"]).to(dev)
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.ema_rate = ema_rate
        self.ema = ({k: v.detach().clone() for k, v in self.params.items()}
                    if ema_rate is not None else None)
        self.steps = 0
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    def step(self, latents: torch.Tensor, labels: torch.Tensor) -> float:
        b = latents.shape[0]
        t, noise, u = step_draws(self.gen, b, latents.shape[1:], self.T, latents.device)
        y = drop_classes(labels.to(torch.int64), u, self.s["num_classes"])
        x_t = self.tab["sqrt_ac"][t].view(-1, 1, 1, 1) * latents \
            + self.tab["sqrt_omac"][t].view(-1, 1, 1, 1) * noise
        n = b // 2 if self.half_batch else b
        block = self.block or n
        names = list(self.params)
        grads = [torch.zeros_like(self.params[k]) for k in names]
        total = 0.0
        for lo in range(0, n, block):
            sl = slice(lo, min(lo + block, n))
            out = forward(self.params, x_t[sl], t[sl], y[sl], self.s, self.pos, self.quant,
                          self.dtype)
            mse, vb = loss_terms(out, latents[sl], x_t[sl], t[sl], noise[sl], self.tab)
            loss = (mse + vb).sum() / n
            for acc, g in zip(grads, torch.autograd.grad(loss, [self.params[k] for k in names])):
                acc.add_(g)
            total += float(loss.detach())
            del out, mse, vb, loss
        self.steps += 1
        if self.first_grads is None:
            self.first_grads = dict(zip(names, grads))
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** self.steps, 1 - b2 ** self.steps
            for k, g in zip(names, grads):
                prm = self.params[k]
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(eps)
                prm.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
                if self.ema is not None:
                    self.ema[k].mul_(self.ema_rate).add_(prm, alpha=1 - self.ema_rate)
        return total
