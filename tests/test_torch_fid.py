"""Port parity for FID: ``calculate_fid`` against the JAX package's on both
the low-rank and the dense path and the 999.0 placeholder, and
``fid_across_sizes`` against the JAX one at sf {0.1, 1.0}, 16x16x1, T=10,
with a shared stub featurizer and JAX's sampler draws replayed
(``torch_parity.sample_draws``).  FIDs at rtol 1e-4."""

import os

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.metrics.fid import calculate_fid as jax_calculate_fid
from distillation_trajectories_tpu.metrics.fid import fid_across_sizes as jax_fid_across_sizes
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_torch.diffusion.sampling import subsampled_timestep_indices
from distillation_trajectories_torch.metrics.fid import (
    calculate_and_visualize_fid,
    calculate_fid,
    fid_across_sizes,
)
from distillation_trajectories_torch.models import make_unet, variables_from_unet_state_dict
from torch_parity import configs, sample_draws

torch.set_num_threads(2)


@pytest.mark.parametrize("n1, n2, d", [(12, 9, 48), (64, 40, 8), (1, 10, 8)],
                         ids=["low-rank", "dense", "placeholder"])
def test_calculate_fid_matches_jax(n1, n2, d):
    rng = np.random.default_rng(7)
    f1 = rng.normal(size=(n1, d))
    f2 = rng.normal(loc=0.3, scale=1.2, size=(n2, d))
    got, want = calculate_fid(f1, f2), jax_calculate_fid(f1, f2)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if n1 < 2:
        assert got == 999.0
    assert isinstance(got, float)


class _StubInception:
    """Duck-typed featurizer: the first 32 pixels of each image, so no
    Inception runs; shared by both packages."""

    pretrained = False

    def get_features(self, images):
        x = np.asarray(images, dtype=np.float64)
        return x.reshape(x.shape[0], -1)[:, :32]


def test_fid_across_sizes_matches_jax(tmp_path):
    jcfg, tcfg = configs(tmp_path)
    n = 4
    # Seeded port weights, carried into the JAX models by the port's bridge.
    teacher = make_unet(tcfg, size_factor=1.0, device="cpu", seed=0)
    students = {sf: make_unet(tcfg, size_factor=sf, device="cpu", seed=1 + i)
                for i, sf in enumerate((0.1, 1.0))}
    jax_pair = lambda sf, m: (jax_make_unet(jcfg, size_factor=sf),  # noqa: E731
                              variables_from_unet_state_dict(m.state_dict()))
    want = jax_fid_across_sizes(*jax_pair(1.0, teacher),
                                {sf: jax_pair(sf, m) for sf, m in students.items()}, jcfg,
                                inception=_StubInception(), num_samples=n, precompile=False)
    # The JAX FID writes under jcfg; the port under its own base_dir.
    _, tcfg = configs(tmp_path / "port")
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    shape = (n, 16, 16, 1)
    n_steps = len(subsampled_timestep_indices(tcfg.sample_steps, tcfg.timesteps))
    draws = (sample_draws(k1, shape, n_steps), sample_draws(k2, shape, n_steps))
    timings = {}
    got = fid_across_sizes(teacher, students, tcfg,
                           inception=_StubInception(), num_samples=n, draws=draws,
                           device="cpu", timings=timings)
    assert list(got) == list(want) == [0.1, 1.0]
    for sf in want:
        np.testing.assert_allclose(got[sf], want[sf], rtol=1e-4, err_msg=str(sf))
        for cfg in (jcfg, tcfg):
            out = os.path.join(cfg.analysis_dir, "fid", f"size_{sf}")
            assert sorted(os.listdir(out)) == [f"fid_samples_size_{sf}.png",
                                               f"fid_score_size_{sf}.txt"]
    # sf 1.0 shares the teacher's architecture, so two samplers serve three
    # sample sets.
    assert timings["samplers"] == 2
    assert {"sampling_s", "features_s", "transfer_s", "frechet_s", "artifacts_s"} <= set(timings)

    # One size through the per-size path gives the same score from the
    # same draws.
    one = calculate_and_visualize_fid(teacher, students[0.1], tcfg,
                                      size_factor=0.1, inception=_StubInception(),
                                      num_samples=n, draws=draws, device="cpu")
    np.testing.assert_allclose(one["fid_score"], got[0.1], rtol=1e-6)


def test_fid_across_sizes_without_students_does_nothing(tmp_path):
    class _Boom:
        def get_features(self, images):  # pragma: no cover - must not run
            raise AssertionError("featurized with no students")

    _, tcfg = configs(tmp_path)
    assert fid_across_sizes(object(), {}, tcfg, inception=_Boom(), device="cpu") == {}


def test_default_draws_give_students_one_shared_stream(tmp_path):
    """Without injected draws, every student is sampled from the same
    stream: two students with the same weights score the same FID."""
    _, tcfg = configs(tmp_path)
    teacher = make_unet(tcfg, size_factor=0.2, device="cpu", seed=0)
    a = make_unet(tcfg, size_factor=0.1, device="cpu", seed=1)
    b = make_unet(tcfg, size_factor=0.1, device="cpu", seed=1)
    got = fid_across_sizes(teacher, {0.1: a, 0.15: b}, tcfg, inception=_StubInception(),
                           num_samples=3, seed=5, device="cpu")
    assert np.isfinite(got[0.1]) and got[0.1] == got[0.15]
