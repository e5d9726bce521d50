"""The gaps that decide ``correct``, and the reference's arithmetic mode.

Each number is a gap between what the program produced and what the
reference works out: relative to the reference where values differ in
scale from seed to seed, absolute for scores bounded by construction.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch


@contextlib.contextmanager
def float32_exact():
    """No autograd, and float32 matrix products and convolutions without
    TF32 (the reference's float32 parts)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def relative_gap(program: float, reference: float) -> float:
    """``|p - r| / |r|``; 0 where both are NaN (a metric the reference's
    transform leaves undefined), inf where only one is."""
    if math.isnan(reference) and math.isnan(program):
        return 0.0
    if math.isnan(reference) or math.isnan(program):
        return math.inf
    if program == reference:
        return 0.0
    return abs(program - reference) / abs(reference) if reference else math.inf


def absolute_gap(program: float, reference: float) -> float:
    """``|p - r|``, with NaN read as :func:`relative_gap` reads it."""
    if math.isnan(reference) and math.isnan(program):
        return 0.0
    if math.isnan(reference) or math.isnan(program):
        return math.inf
    return abs(program - reference)


def trajectory_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """``||p - r|| / ||r - r_0||`` over a ``[T+1, ...]`` trajectory whose
    first state is the shared starting noise: the gap against the path the
    reference's chain moved (float64 sums)."""
    p = np.asarray(program, dtype=np.float64)
    r = np.asarray(reference, dtype=np.float64)
    if p.shape != r.shape or not np.isfinite(p).all():
        return math.inf
    return float(np.linalg.norm(p - r) / np.linalg.norm(r - r[:1]))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float]) -> Dict[str, float]:
    """``| ||p_leaf|| - ||r_leaf|| |`` of every leaf of ``reference``, each
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    median = float(np.median(list(reference.values())))
    return {k: (abs(program[k] - r) / max(r, median) if math.isfinite(program[k]) else math.inf)
            for k, r in reference.items()}

