"""DiT's training objective: the ε-MSE plus the variational bound of the
learned variance (IDDPM's hybrid loss, as facebookresearch/DiT trains it:
``diffusion/__init__.py::create_diffusion`` with ``learn_sigma=True`` and
the MSE loss type, ``diffusion/gaussian_diffusion.py::training_losses``
and ``_vb_terms_bpd``, ``diffusion/diffusion_utils.py::normal_kl`` and
``discretized_gaussian_log_likelihood``).

Per sample, with ``[ε̂, v]`` the model's two output halves::

    mse = mean (ε − ε̂)²
    vb  = mean KL(N(μ̃, β̃_t) ‖ N(μ_θ, σ²_θ)) / ln 2            (t > 0)
        = −mean log p(x_0 | μ_θ, σ²_θ) / ln 2                  (t = 0)

with the posterior ``μ̃ = c1_t x_0 + c2_t x_t`` and its log-variance
``log β̃_t`` clipped (``β̃_1`` in place of ``β̃_0``), the model's mean the
posterior's at ``x̂_0 = √(1/ᾱ_t) x_t − √(1/ᾱ_t − 1) ε̂``, its log-variance
``f log β_t + (1 − f) log β̃_t`` at ``f = (v + 1) / 2``, and ``p`` the
discretized Gaussian with bins of width 2/255 (the tanh approximation of
Φ).  ``vb`` sees ``ε̂`` detached, so its gradient reaches only ``v``.  The
loss is the batch mean of ``mse + vb``.

The schedule's tables are computed in float64 and cast to float32, as
DiT's ``_extract_into_tensor`` casts each gathered value.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def dit_schedule(timesteps: int, beta_start: float, beta_end: float) -> Dict[str, np.ndarray]:
    """DiT's linear schedule (``get_named_beta_schedule("linear", T)``,
    its β range scaled by 1000 / T) and the tables the objective and
    ``process.q_sample`` gather by ``t``, float64 arithmetic cast to float32
    arrays."""
    scale = 1000.0 / timesteps
    betas = np.linspace(scale * beta_start, scale * beta_end, timesteps, dtype=np.float64)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas, axis=0)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    tables = {
        "sqrt_alphas_cumprod": np.sqrt(ac),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - ac),
        "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / ac),
        "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / ac - 1),
        "posterior_mean_coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
        "posterior_mean_coef2": (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
        "posterior_log_variance_clipped": np.log(np.append(post_var[1], post_var[1:])),
        "log_betas": np.log(betas),
    }
    return {k: v.astype(np.float32) for k, v in tables.items()}


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) ‖ N(mean2, e^logvar2)), elementwise, in nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """log p(x) of data in [−1, 1] binned at width 2/255 under N(means,
    e^(2 log_scales)); the end bins open to ±∞."""
    centred = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centred + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centred - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def _at(tables: Dict[str, torch.Tensor], name: str, t: torch.Tensor, ndim: int):
    return tables[name][t].reshape(-1, *((1,) * (ndim - 1)))


def _mean_flat(a: torch.Tensor) -> torch.Tensor:
    return a.mean(dim=tuple(range(1, a.ndim)))


def hybrid_terms(out: torch.Tensor, x0: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor, tables: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mse, vb)``, each ``[B]`` float32, of the model output ``out``
    (``[B, ..., 2C]`` channels-last: ``ε̂``, then ``v``) at ``x_t`` noised
    from ``x0`` with ``noise`` to integer ``t``; ``tables`` are
    :func:`dit_schedule`'s on ``t``'s device."""
    c = x0.shape[-1]
    eps, v = out[..., :c], out[..., c:]
    at = lambda name: _at(tables, name, t, x0.ndim)
    mse = _mean_flat((noise - eps) ** 2)
    true_mean = at("posterior_mean_coef1") * x0 + at("posterior_mean_coef2") * x_t
    true_logvar = at("posterior_log_variance_clipped")
    frac = (v + 1) / 2
    logvar = frac * at("log_betas") + (1 - frac) * true_logvar
    x0_hat = at("sqrt_recip_alphas_cumprod") * x_t \
        - at("sqrt_recipm1_alphas_cumprod") * eps.detach()
    mean = at("posterior_mean_coef1") * x0_hat + at("posterior_mean_coef2") * x_t
    kl = _mean_flat(normal_kl(true_mean, true_logvar, mean, logvar)) / math.log(2.0)
    nll = -_mean_flat(discretized_gaussian_log_likelihood(x0, mean, 0.5 * logvar)) \
        / math.log(2.0)
    return mse, torch.where(t == 0, nll, kl)
