"""The trajectory metric suite's per-sample scalars in plain PyTorch, over
``[S, N, H, W, C]`` teacher/student trajectory pairs.

The published definitions, transforms included: the trajectory MSE is
``log1p(1 - 1000 mse)`` (NaN where the MSE exceeds 2e-3); cosines of step
vectors skip steps where either norm is zero; the Wasserstein distance of
each step is over the 1,000 pixels whose uniform keys are smallest.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

SAMPLE_SIZE = 1000


def scalar_metrics(teacher: torch.Tensor, student: torch.Tensor,
                   uniforms: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    s, n = teacher.shape[:2]
    pixels = teacher.shape[2] * teacher.shape[3]
    x = teacher.reshape(s, n, -1).float()
    y = student.reshape(s, n, -1).float()
    d = x.shape[-1]
    norm = torch.linalg.vector_norm
    m: Dict[str, torch.Tensor] = {}
    last = x[:, -1] - y[:, -1]
    m["endpoint_distance"] = norm(last, dim=-1)
    mse = (last ** 2).mean(-1)
    m["mse"] = mse
    m["trajectory_mse"] = torch.log1p(1.0 - ((x - y) ** 2).mean(dim=(1, 2)) * 1000.0)
    dist = norm(x - y, dim=-1)
    m["point_by_point_similarity"] = torch.exp(-5.0 * dist.mean(-1))
    m["log_mse_similarity"] = (1.0 - torch.log1p(mse * 5000.0) / math.log1p(5000.0)).clamp_min(0.0)
    t_dir, s_dir = x[:, 1:] - x[:, :-1], y[:, 1:] - y[:, :-1]
    t_steps, s_steps = norm(t_dir, dim=-1), norm(s_dir, dim=-1)
    tpl = (t_steps / pixels).sum(-1) / (n - 1)
    spl = (s_steps / pixels).sum(-1) / (n - 1)
    m["teacher_path_length"], m["student_path_length"] = tpl, spl
    m["path_length_similarity"] = torch.log1p(
        torch.where(torch.maximum(tpl, spl) > 0, torch.minimum(tpl, spl) / torch.maximum(tpl, spl), 1.0))
    m["path_length_ratio"] = torch.where(tpl > 0, spl / tpl, math.inf)
    t_eff = torch.where(tpl > 0, norm(x[:, -1] - x[:, 0], dim=-1) / tpl, 0.0)
    s_eff = torch.where(spl > 0, norm(y[:, -1] - y[:, 0], dim=-1) / spl, 0.0)
    m["teacher_efficiency"], m["student_efficiency"] = t_eff, s_eff
    e_max, e_min = torch.maximum(t_eff, s_eff), torch.minimum(t_eff, s_eff)
    m["efficiency_similarity"] = torch.log1p(torch.where(e_max > 0, e_min / e_max, 1.0))
    v_max, v_min = torch.maximum(t_steps, s_steps), torch.minimum(t_steps, s_steps)
    m["mean_velocity_similarity"] = torch.where(v_max > 0, v_min / v_max, 1.0).mean(-1)
    m["mean_position_difference"] = dist.mean(-1)
    m["max_position_difference"] = dist.amax(-1)
    valid = (t_steps > 0) & (s_steps > 0)
    cos = torch.where(valid, (t_dir * s_dir).sum(-1) / torch.where(valid, t_steps * s_steps, 1.0), 0.0)
    n_valid = valid.sum(-1)
    m["mean_directional_consistency"] = torch.where(n_valid > 0, cos.sum(-1) / n_valid.clamp_min(1), 0.0)
    weights = (t_steps + s_steps) / 2.0
    total = weights.sum(-1)
    wmean = torch.where(total > 0, torch.where(valid, cos * weights, 0.0).sum(-1) / total, 0.0)
    m["weighted_directional_consistency"] = wmean ** 2
    m["path_alignment"] = torch.exp(-10.0 * dist.sum(-1) / n)
    if d > SAMPLE_SIZE:
        idx = torch.argsort(uniforms, dim=-1)[..., :SAMPLE_SIZE]
        xs, ys = torch.gather(x, -1, idx), torch.gather(y, -1, idx)
    else:
        xs, ys = x, y
    mean_w = (torch.sort(xs, dim=-1).values - torch.sort(ys, dim=-1).values).abs().mean(-1).mean(-1)
    m["mean_wasserstein"] = mean_w
    m["distribution_similarity"] = torch.log1p(torch.exp(-mean_w))
    return m
