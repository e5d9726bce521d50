"""Port parity: Config and diffusion schedules (torch port vs JAX package)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.diffusion.schedules import (
    extract as jax_extract,
    get_diffusion_params as jax_get_diffusion_params,
)
from distillation_trajectories_torch.config import Config, resolve_device
from distillation_trajectories_torch.diffusion.schedules import (
    extract,
    get_diffusion_params,
)
from torch_parity import tmp_path  # noqa: F401  (each test's outputs removed when it ends)

torch.set_num_threads(2)


def test_config_fields_defaults_and_directories_match_jax(tmp_path, monkeypatch):
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(Config)}
    port_only = {"device", "architecture"}
    assert port_fields - jax_fields == port_only
    assert jax_fields <= port_fields

    ref = JaxConfig(base_dir=str(tmp_path))
    port = Config(base_dir=str(tmp_path))
    # Every attribute, including the derived directory contract.
    assert {k: v for k, v in vars(port).items() if k not in port_only} == vars(ref)
    assert (port.device, port.architecture) == ("cuda", "unet")
    assert port.student_dir(0.5) == ref.student_dir(0.5)
    # base_dir defaults to the repo root in both packages.
    assert Config().base_dir == JaxConfig().base_dir
    # The test split comes from the port's data layer, as JAX's does.
    from distillation_trajectories_tpu.data import datasets as jax_datasets

    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [])
    for got, want in zip(port.get_test_dataset(), ref.get_test_dataset()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
@pytest.mark.parametrize("timesteps", [10, 50])
def test_get_diffusion_params_exact(tmp_path, schedule, timesteps):
    ref = jax_get_diffusion_params(
        timesteps, JaxConfig(base_dir=str(tmp_path), noise_schedule=schedule)
    )
    port = get_diffusion_params(
        timesteps, Config(base_dir=str(tmp_path), noise_schedule=schedule)
    )
    assert set(port) == set(ref)
    for k in ref:
        want = np.asarray(ref[k])
        assert port[k].dtype == want.dtype, k
        np.testing.assert_array_equal(port[k], want, err_msg=k)
    assert not port["alphas"].flags.writeable


def test_extract_matches_jax():
    a = get_diffusion_params(10)["sqrt_alphas_cumprod"]
    t = np.array([0, 4, 9, 12, -1], dtype=np.int32)  # out-of-range clamps
    want = np.asarray(jax_extract(a, jnp.asarray(t), (5, 16, 16, 3)))
    got = extract(a, torch.from_numpy(t), (5, 16, 16, 3))
    assert tuple(got.shape) == (5, 1, 1, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_request_without_gpu_raises(monkeypatch):
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.trajectories import (
        generate_trajectory,
        sweep_compare_trajectories,
    )

    cfg = Config(image_size=16, channels=1, timesteps=10, sample_steps=10)
    model = make_unet(cfg, size_factor=0.1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        make_unet(cfg, size_factor=0.1)
    with pytest.raises(RuntimeError, match="cuda"):
        sweep_compare_trajectories(model, {0.1: model}, cfg, num_samples=1)
    with pytest.raises(RuntimeError, match="cuda"):
        generate_trajectory(model, torch.zeros((1, 16, 16, 1)), 10, config=cfg)
    assert resolve_device("cpu") == torch.device("cpu")
