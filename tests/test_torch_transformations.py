"""Port parity: the heatmap normalisation ``transform_metrics`` equals the
JAX package's exactly (same numpy arithmetic), on arrays with negatives,
values above the clip points and NaN, and on the scalars the CLI feeds it."""

import numpy as np
import pytest

from distillation_trajectories_tpu.metrics.transformations import (
    transform_metrics as jax_transform_metrics,
)
from distillation_trajectories_torch.metrics import transform_metrics


def _inputs(kind):
    rng = np.random.default_rng(0)
    if kind == "scalars":
        return (0.61, -0.4, -0.73, 0.52)
    arrays = [rng.normal(0.0, 2.0, (4, 5)) for _ in range(4)]
    for a in arrays:
        a[0, 0], a[1, 1], a[2, 2] = np.nan, -3.0, 7.5
    return tuple(arrays)


@pytest.mark.parametrize("kind", ["scalars", "arrays"])
def test_transform_metrics_equals_jax_exactly(kind):
    args = _inputs(kind)
    got = transform_metrics(*args)
    want = jax_transform_metrics(*args)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    if kind == "arrays":
        # Every score but the passthrough lies in [0, 1] where it is defined.
        for k in ("trajectory_mse", "distribution_similarity"):
            v = np.asarray(got[k])
            assert np.isnan(v[0, 0]) and np.all((v[~np.isnan(v)] >= 0) & (v[~np.isnan(v)] <= 1))
