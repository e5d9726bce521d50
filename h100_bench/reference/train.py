"""The teacher's train step in plain PyTorch, and Adam.

The published step: one timestep per image, two noise draws, the images
noised to ``t`` with each; the conditional forward (cond 1, mask 1) on the
first and the unconditional one (cond 0, mask 0) on the second, both in
train mode with dropout; loss = mean of the two noise MSEs.  Then Adam at
torch's defaults (beta 0.9 / 0.999, eps 1e-8), as the published trainer
builds it, at the configuration's learning rate.  The forwards compute in
``dtype`` (autocast), the loss and Adam in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from . import unet
from ..yardstick import draws as D


class TeacherSteps:
    """Follows a trainer from its initial weights through its first steps.

    ``gen`` is the trainer's draw generator, seeded as the trainer seeds it;
    each step takes its ``t``, both noises and both forwards' dropout masks
    from it in the trainer's order."""

    def __init__(self, weights: Dict[str, torch.Tensor], size_factor: float, schedule: dict,
                 timesteps: int, lr: float, dropout: float, gen: torch.Generator,
                 quant: Optional[Callable] = None, half_batch: bool = False,
                 dtype: torch.dtype = torch.float32):
        self.params = {k: v.detach().clone().float().requires_grad_(unet.is_trainable(k))
                       for k, v in weights.items() if unet.is_trainable(k)}
        self.buffers = {k: v for k, v in weights.items() if not unet.is_trainable(k)}
        self.sf, self.T, self.lr, self.keep = size_factor, timesteps, lr, 1.0 - dropout
        self.gen, self.quant, self.half_batch, self.dtype = gen, quant, half_batch, dtype
        dev = next(iter(self.params.values())).device
        self.sqrt_ac = torch.tensor(schedule["sqrt_ac"], device=dev)
        self.sqrt_omac = torch.tensor(schedule["sqrt_omac"], device=dev)
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.steps = 0
        self.grads: List[Dict[str, torch.Tensor]] = []

    def _mse(self, a, b):
        if self.half_batch:
            a, b = a[: a.shape[0] // 2], b[: b.shape[0] // 2]
        return torch.mean((a - b) ** 2)

    def step(self, images: torch.Tensor) -> float:
        b, h, w, c = images.shape
        dev = images.device
        t, n1, n2 = D.teacher_step_draws(self.gen, b, (h, w, c), self.T, dev)
        ca = self.sqrt_ac[t].view(b, 1, 1, 1)
        cb = self.sqrt_omac[t].view(b, 1, 1, 1)
        p = {**self.params, **self.buffers}
        shapes = unet.dropout_shapes(b, self.sf, c, h, w)
        ones, zeros = images.new_ones((b, 1)), images.new_zeros((b, 1))
        losses = []
        for noise, cm in ((n1, ones), (n2, zeros)):
            masks = D.dropout_masks(self.gen, shapes, self.keep, dev)
            pred = unet.forward(p, ca * images + cb * noise, t, cm, cm, self.sf, train=True,
                                dropout_masks=masks, keep=self.keep, quant=self.quant,
                                dtype=self.dtype)
            losses.append(self._mse(pred, noise))
        loss = (losses[0] + losses[1]) / 2.0
        grads = torch.autograd.grad(loss, list(self.params.values()))
        self.steps += 1
        self.grads.append({k: g.detach() for k, g in zip(self.params, grads)})
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** self.steps, 1 - b2 ** self.steps
            for (k, prm), g in zip(self.params.items(), grads):
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(eps)
                prm.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
        return float(loss.detach())
