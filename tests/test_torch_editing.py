"""The port's editing flows against the JAX package's on the CPU (16x16,
sf 0.1 for the modules, the sf-1.0 teacher for the CLI, T ≤ 6, float32),
the port's seeded weights carried into JAX and JAX's draws injected
(``torch_parity.JaxEditingDraws``):

- ``denoise_with_trajectory`` in engine and ancestral mode, with and
  without a ``post_step``, at the sampler tolerance (rtol 2e-5 / atol
  1e-5); its trajectory has ``start_t + 2`` rows;
- ``create_random_mask`` bit-exact;
- each ``apply_*`` flow's images and trajectories at the same tolerance;
- ``find_semantic_directions``: the batched latents against JAX's vmapped
  ones, and PCA exact on identical latents (PCA signs follow rounding in
  the chains, so the port's directions are compared up to sign);
- the CLI's ``run`` against JAX's three functions called as the JAX CLI
  calls them, and the PNG names of its plots against JAX's ``visualize_*``;
- ``--spatial``, ``spatial_shape`` and the default ``cuda`` device raising
  here.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.analysis import dimensionality as jax_dimensionality
from distillation_trajectories_tpu.data import datasets as jax_datasets
from distillation_trajectories_tpu.data import get_real_images as jax_get_real_images
from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.editing import core as jax_core
from distillation_trajectories_tpu.editing import latent_manipulation as jax_latent
from distillation_trajectories_tpu.editing import masked_inpainting as jax_inpaint
from distillation_trajectories_tpu.editing import prompt_editing as jax_prompt
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.training import checkpoints as jax_ckpt
from distillation_trajectories_tpu.training.state import make_eval_model_fn as jax_eval_fn
from distillation_trajectories_torch.diffusion import get_diffusion_params
from distillation_trajectories_torch.editing import core, latent_manipulation
from distillation_trajectories_torch.editing import (
    apply_latent_manipulation,
    apply_masked_inpainting,
    apply_prompt_editing,
    create_random_mask,
    find_semantic_directions,
    generate_image_with_latents,
)
from distillation_trajectories_torch.models import make_unet, variables_from_unet_state_dict
from distillation_trajectories_torch.scripts import run_editing_demo
from distillation_trajectories_torch.training import make_eval_model_fn, save_checkpoint
from torch_parity import (
    NAMES_ONLY,
    JaxEditingDraws,
    configs,
    file_set,
    quick_plots,
)

torch.set_num_threads(2)
T = 6
TOL = dict(rtol=2e-5, atol=1e-5)


@pytest.fixture(scope="module")
def small():
    """(JAX config, port config, JAX model, variables, port model): sf 0.1
    at 16x16x1, T=6."""
    jcfg, tcfg = configs(timesteps=T, sample_steps=T)
    model = make_unet(tcfg, size_factor=0.1, seed=4)
    variables = variables_from_unet_state_dict(model.state_dict())
    return jcfg, tcfg, jax_make_unet(jcfg, size_factor=0.1), variables, model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["engine", "ancestral"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "post_step"])
def test_denoise_with_trajectory_matches_jax(small, mode, masked):
    jcfg, tcfg, jmodel, variables, model = small
    dp = jax_params(T, jcfg)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    keep = (rng.uniform(size=(1, 16, 16, 1)) > 0.5).astype(np.float32)
    known = rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
    start_t = T - 1

    jax_post = (lambda z: keep * z + (1 - keep) * known) if masked else None
    want_x, want_traj = jax_core.denoise_with_trajectory(
        jax_eval_fn(jmodel, variables), jnp.asarray(x0), dp["alphas"], start_t,
        jax.random.PRNGKey(7), post_step=jax_post, diffusion_params=dp, mode=mode)

    keep_t, known_t = torch.from_numpy(keep), torch.from_numpy(known)
    post = (lambda z: keep_t * z + (1 - keep_t) * known_t) if masked else None
    got_x, got_traj = core.denoise_with_trajectory(
        make_eval_model_fn(model), torch.from_numpy(x0), get_diffusion_params(T)["alphas"],
        start_t, step_noise=JaxEditingDraws().redenoise(7, x0.shape, start_t),
        post_step=post, diffusion_params=get_diffusion_params(T), mode=mode)
    assert tuple(got_traj.shape) == (start_t + 2, 2, 16, 16, 1) == want_traj.shape
    _close(got_traj, want_traj)
    _close(got_x, want_x)
    torch.testing.assert_close(got_traj[-1], got_traj[-2], rtol=0, atol=0)


def test_denoise_default_step_noise_is_seeded():
    x0 = torch.randn((1, 4, 4, 1), generator=torch.Generator().manual_seed(0))
    fn = lambda x, t, c, m: 0.1 * x
    alphas = get_diffusion_params(T)["alphas"]
    a = core.denoise_with_trajectory(fn, x0, alphas, 3, seed=5)[1]
    b = core.denoise_with_trajectory(fn, x0, alphas, 3,
                                     step_noise=core.EditingDraws("cpu").redenoise(5, (1, 4, 4, 1), 3))[1]
    c = core.denoise_with_trajectory(fn, x0, alphas, 3, seed=6)[1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="step_noise"):
        core.denoise_with_trajectory(fn, x0, alphas, 3, step_noise=torch.zeros((2, 1, 4, 4, 1)))
    with pytest.raises(ValueError, match="diffusion_params"):
        core.denoise_with_trajectory(fn, x0, alphas, 3, mode="ancestral")


@pytest.mark.parametrize("seed", range(6))
def test_create_random_mask_is_bit_exact(seed):
    for h, w in ((16, 16), (32, 24)):
        got = create_random_mask(h, w, rng=np.random.default_rng(seed))
        want = jax_inpaint.create_random_mask(h, w, rng=np.random.default_rng(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["engine", "ancestral"])
def test_apply_masked_inpainting_matches_jax(small, mode):
    jcfg, tcfg, jmodel, variables, model = small
    image = np.random.default_rng(2).uniform(0, 1, (16, 16, 1)).astype(np.float32)
    want = jax_inpaint.apply_masked_inpainting(jmodel, jcfg, image, variables=variables, seed=3,
                                               mode=mode)
    got = apply_masked_inpainting(model, tcfg, image, seed=3, mode=mode, draws=JaxEditingDraws())
    assert set(got) == set(want)
    assert np.array_equal(got["mask"], want["mask"])
    assert np.array_equal(got["original_image"], want["original_image"])
    assert got["trajectory"].shape == (T + 1, 1, 16, 16, 1)
    for k in ("inpainted_image", "trajectory"):
        _close(got[k], want[k])
    outside = got["mask"] == 0
    np.testing.assert_allclose(got["inpainted_image"][outside], image[None][outside], atol=1e-6)


def test_latent_manipulation_matches_jax(small):
    jcfg, tcfg, jmodel, variables, model = small
    draws = JaxEditingDraws()
    want = jax_latent.generate_image_with_latents(jmodel, jcfg, variables=variables, seed=2)
    got = generate_image_with_latents(model, tcfg, seed=2, draws=draws)
    for g, w in zip(got, want):
        _close(g, w)

    want = jax_latent.apply_latent_manipulation(jmodel, jcfg, latent=want[1], strength=1.5,
                                                variables=variables, seed=2)
    got = apply_latent_manipulation(model, tcfg, latent=got[1], strength=1.5, seed=2, draws=draws)
    assert set(got) == set(want) and got["strength"] == 1.5
    assert got["trajectory"].shape == (T // 2 + 2, 1, 16, 16, 1)
    for k in ("original_latent", "manipulated_latent", "original_image", "manipulated_image",
              "trajectory"):
        _close(got[k], want[k])


def test_prompt_editing_matches_jax(small):
    jcfg, tcfg, jmodel, variables, model = small
    want = jax_prompt.apply_prompt_editing(jmodel, jcfg, "a", "b", variables=variables, seed=5)
    got = apply_prompt_editing(model, tcfg, "a", "b", seed=5, draws=JaxEditingDraws())
    assert set(got) == set(want)
    assert (got["original_prompt"], got["edited_prompt"]) == ("a", "b")
    for k in ("original_image", "edited_image", "original_trajectory", "edited_trajectory"):
        _close(got[k], want[k])
    assert not np.allclose(got["original_image"], got["edited_image"])


class _Capture:
    """Wraps ``pca_fit_transform`` to keep its input."""

    def __init__(self, fn):
        self.fn, self.inputs = fn, []

    def __call__(self, data, n):
        self.inputs.append(np.array(data))
        return self.fn(data, n)


def test_find_semantic_directions_matches_jax(small):
    jcfg, tcfg, jmodel, variables, model = small
    want_cap = _Capture(jax_latent.pca_fit_transform)
    with mock.patch.object(jax_latent, "pca_fit_transform", want_cap):
        want = jax_latent.find_semantic_directions(jmodel, jcfg, variables=variables,
                                                   num_samples=12)
    got_cap = _Capture(latent_manipulation.pca_fit_transform)
    with mock.patch.object(latent_manipulation, "pca_fit_transform", got_cap):
        got = find_semantic_directions(model, tcfg, num_samples=12, draws=JaxEditingDraws())
    (got_latents,), (want_latents,) = got_cap.inputs, want_cap.inputs
    assert got_latents.shape == want_latents.shape == (12, 256)
    _close(got_latents, want_latents)

    assert sorted(got) == sorted(want) == sorted(f"pca_{i}" for i in range(10))
    components = latent_manipulation.pca_fit_transform(got_latents, 10)[2]
    for i in range(10):
        assert np.array_equal(got[f"pca_{i}"], components[i])
    # PCA on identical latents is exact.
    for g, w in zip(latent_manipulation.pca_fit_transform(want_latents, 10),
                    jax_dimensionality.pca_fit_transform(want_latents, 10)):
        assert np.array_equal(g, w)
    for i in range(3):  # the leading directions agree up to sign
        assert abs(float(np.dot(got[f"pca_{i}"], want[f"pca_{i}"]))) > 1 - 1e-4


def test_run_editing_demo_matches_jax(tmp_path, monkeypatch):
    """The CLI's ``run`` (sf-1.0 teacher, 16x16x3, T=4, 32 direction
    samples) against the JAX functions it ports, then the plot names."""
    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [])
    kw = dict(dataset="MNIST", image_size=16, timesteps=4, compute_dtype="float32")
    jcfg, tcfg = configs(tmp_path / "jax", channels=3, **kw)
    for cfg in (jcfg, configs(tmp_path / "port", channels=3, **kw)[1]):
        save_checkpoint(cfg.teacher_models_dir, 1, make_unet(tcfg, size_factor=1.0, seed=3))
    teacher = jax_make_unet(jcfg, size_factor=1.0)
    variables = jax_ckpt.variables_from_checkpoint(jax_ckpt.load_checkpoint(jcfg.teacher_models_dir))

    args = run_editing_demo.parse_args(
        ["--base_dir", str(tmp_path / "port"), "--dataset", "MNIST", "--image_size", "16",
         "--timesteps", "4", "--seed", "1", "--strength", "1.5", "--device", "cpu"])
    config = run_editing_demo.make_config(args)
    config.compute_dtype = "float32"
    timings = {}
    got = run_editing_demo.run(args, config, draws=JaxEditingDraws(), timings=timings)
    assert set(timings) == {"teacher_load_s", "inpainting_s", "latent_manipulation_s",
                            "prompt_editing_s"}

    real01 = (jax_get_real_images(jcfg, 1)[0] + 1.0) / 2.0
    mask = jax_inpaint.create_random_mask(16, 16, rng=np.random.default_rng(1))
    want = {"inpainting": jax_inpaint.apply_masked_inpainting(
        teacher, jcfg, real01, mask=mask, variables=variables, seed=1)}
    directions = jax_latent.find_semantic_directions(teacher, jcfg, variables=variables,
                                                     num_samples=32)
    want["prompt_editing"] = jax_prompt.apply_prompt_editing(
        teacher, jcfg, "a digit", "another digit", variables=variables, seed=1)
    # The port's pca_0 equals JAX's up to sign; manipulate along the port's.
    dot = float(np.dot(got["directions"]["pca_0"], directions["pca_0"]))
    assert abs(dot) > 1 - 1e-4
    want["latent_manipulation"] = jax_latent.apply_latent_manipulation(
        teacher, jcfg, direction=np.sign(dot) * directions["pca_0"], strength=1.5,
        variables=variables, seed=1)

    for flow, result in want.items():
        assert set(got[flow]) == set(result), flow
        for k, v in result.items():
            if isinstance(v, np.ndarray):
                _close(got[flow][k], v)
            else:
                assert got[flow][k] == v, (flow, k)

    with quick_plots():
        run_editing_demo.plot(got, config)
    with NAMES_ONLY:
        for fn, flow in ((jax_inpaint.visualize_inpainting, "inpainting"),
                         (jax_latent.visualize_latent_manipulation, "latent_manipulation"),
                         (jax_prompt.visualize_prompt_editing, "prompt_editing")):
            fn(want[flow], str(tmp_path / "jax" / "output" / "analysis" / "editing"))
    names = file_set(run_editing_demo.output_dir(config))
    assert names == file_set(str(tmp_path / "jax" / "output" / "analysis" / "editing"))
    assert len(names) == 6


def test_unported_lanes_and_default_device_raise(small, tmp_path):
    jcfg, tcfg, jmodel, variables, model = small
    with pytest.raises(NotImplementedError, match="spatial"):
        run_editing_demo.make_config(run_editing_demo.parse_args(
            ["--base_dir", str(tmp_path), "--spatial", "2,2", "--device", "cpu"]))
    image = np.zeros((16, 16, 1), np.float32)
    for shape in ((1, 2), (2, 1)):
        cfg = configs(timesteps=T, spatial_shape=shape)[1]
        with pytest.raises(NotImplementedError):
            apply_masked_inpainting(model, cfg, image)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_editing_demo.make_config(run_editing_demo.parse_args(["--base_dir", str(tmp_path)]))
