"""The port on a CUDA GPU (skipped without one): the Triton kernel against
its plain version, and a train step, the InceptionV3 trunk, AlexNet-LPIPS,
the noise-prediction compute half and the sweep function's averaged chains
on the card against the CPU.

Imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import pytest
import torch

from distillation_trajectories_torch.ops.cfg_update import (
    cfg_engine_update,
    cfg_engine_update_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape, dtype, tol",
    [
        ((256, 32, 32, 3), torch.float32, 1e-6),  # FMA contraction: ~1 ulp
        ((256, 32, 32, 3), torch.bfloat16, 1e-2),
        ((1, 7, 5, 1), torch.float32, 1e-6),
    ],
)
def test_kernel_matches_plain_version(cuda, shape, dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    ops = [torch.randn(shape, device=cuda, generator=gen).to(dtype) for _ in range(4)]
    before = cfg_engine_update.launches
    got = cfg_engine_update(*ops, 1.0007, 0.0123, 0.0456, 3.0)
    torch.cuda.synchronize()
    assert cfg_engine_update.launches == before + 1
    assert got.dtype == dtype and got.shape == shape and got.device.type == "cuda"
    want = cfg_engine_update_reference(*ops, 1.0007, 0.0123, 0.0456, 3.0)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 8, 8, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cfg_engine_update(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2),
                          x.transpose(1, 2), 1.0, 0.1, 0.1, 1.0)
    with pytest.raises(TypeError):
        h = x.half()
        cfg_engine_update(h, h, h, h, 1.0, 0.1, 0.1, 1.0)
    with pytest.raises(ValueError, match="shape"):
        cfg_engine_update(x, x[:1], x, x, 1.0, 0.1, 0.1, 1.0)
    with pytest.raises(ValueError):
        cfg_engine_update(x, x.cpu(), x, x, 1.0, 0.1, 0.1, 1.0)


def _bias_feeds_batch_norm(name):
    return name.endswith(("conv1.bias", "conv2.bias"))


def test_teacher_step_on_card_matches_cpu(cuda):
    """One teacher step (float32, TF32 off, sf 0.1, 16x16x1, batch 8, T=10,
    dropout 0) on the card against the same step, weights and draws on
    the CPU, at the tolerances the CPU tests hold the step to JAX with."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training.state import (
        StepDraws,
        TorchDraws,
        create_train_state,
        make_teacher_train_step,
    )

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = Config(device="cpu", image_size=16, channels=1, timesteps=10, sample_steps=10,
                     compute_dtype="float32", dropout=0.0)
        images = torch.rand((8, 16, 16, 1), generator=torch.Generator().manual_seed(0)) * 2 - 1
        draws = TorchDraws(1, "cpu").teacher_step(images, 10)
        step = make_teacher_train_step(get_diffusion_params(10), 10)
        out = {}
        for device in ("cpu", cuda):
            model = make_unet(cfg, size_factor=0.1, device=device, seed=0)
            state = create_train_state(model, cfg, draws=None)
            moved = StepDraws(draws.t.to(device), tuple(n.to(device) for n in draws.noises))
            _, loss = step(state, images.to(device), moved)
            out[str(device)] = (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()},
                                {k: v.cpu() for k, v in model.state_dict().items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (want_loss, want_g, want_s), (loss, grads, states) = out["cpu"], out["cuda"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for k, g in grads.items():
        if _bias_feeds_batch_norm(k):
            assert g.abs().max() < 1e-6 and want_g[k].abs().max() < 1e-6, k
        else:
            atol = max(1e-7, 5e-5 * float(want_g[k].abs().max()))
            torch.testing.assert_close(g, want_g[k], rtol=1e-4, atol=atol, msg=k)
    for k, v in states.items():
        if "running" in k:
            torch.testing.assert_close(v, want_s[k], rtol=1e-5, atol=1e-6, msg=k)


def _no_tf32():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return saved


def test_inception_on_card_matches_cpu(cuda):
    """The seeded InceptionV3 trunk at 299x299 (preprocessing included),
    float32 with TF32 off, on the card against the CPU: within 1e-4 of
    the largest feature, as the CPU tests hold the trunk to JAX."""
    from distillation_trajectories_torch.models.inception import (
        create_inception,
        preprocess_for_inception,
    )

    saved = _no_tf32()
    try:
        images = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
        out = {}
        for device in ("cpu", cuda):
            model, _ = create_inception(weights_path="/nonexistent.npz", device=device)
            with torch.no_grad():
                out[str(device)] = model(preprocess_for_inception(images.to(device))).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    want, got = out["cpu"], out["cuda"]
    assert got.shape == (2, 2048) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def test_lpips_on_card_matches_cpu(cuda):
    from distillation_trajectories_torch.metrics.lpips import create_lpips

    saved = _no_tf32()
    try:
        gen = torch.Generator().manual_seed(1)
        x, y = (torch.rand((8, 64, 64, 3), generator=gen) * 2 - 1 for _ in range(2))
        out = {}
        for device in ("cpu", cuda):
            scorer, _ = create_lpips(weights_path="/nonexistent.npz", device=device)
            with torch.no_grad():
                out[str(device)] = scorer(x.to(device), y.to(device)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=0)


def test_noise_prediction_on_card_matches_cpu(cuda):
    """The noise-prediction compute half (sf 0.2 against sf 0.1, 16x16x1,
    10 images, 10 timesteps, float32, TF32 off, shared weights, images and
    noise) on the card against the CPU: per-timestep metrics within rtol
    1e-4."""
    import numpy as np

    from distillation_trajectories_torch.analysis.noise_prediction import noise_prediction_metrics
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.models import make_unet

    saved = _no_tf32()
    try:
        gen = torch.Generator().manual_seed(2)
        images = torch.rand((10, 16, 16, 1), generator=gen) * 2 - 1
        noise = torch.randn((10, 10, 16, 16, 1), generator=gen)
        out = {}
        for device in ("cpu", cuda):
            cfg = Config(device=str(device), image_size=16, channels=1, timesteps=10,
                         compute_dtype="float32")
            out[str(device)], _ = noise_prediction_metrics(
                make_unet(cfg, size_factor=0.2, seed=0), make_unet(cfg, size_factor=0.1, seed=1),
                cfg, images=images, noise=noise)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for t, want in out["cpu"]["metrics_by_timestep"].items():
        for k, w in want.items():
            np.testing.assert_allclose(out["cuda"]["metrics_by_timestep"][t][k], w, rtol=1e-4,
                                       err_msg=f"t={t} {k}")


def test_averaged_sweep_chains_on_card_match_cpu(cuda):
    """The trajectories CLI's unit, the sweep function's chains averaged
    over 4 samples (sf 0.1, 16x16x1, T=10, CFG at 3.0, float32, TF32 off,
    shared draws), on the card against the CPU at the sampler tolerance
    (rtol 2e-5 / atol 1e-5); every step launches the kernel once."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.diffusion.sampling import (
        CFG_COND_PAIRS,
        draw_step_noise,
        seeded_normal,
    )
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.trajectories import make_sweep_trajectory_fn

    saved = _no_tf32()
    try:
        seeds = [0, 1, 2, 3]
        noises = seeded_normal([(s, 0) for s in seeds], (16, 16, 1), "cpu")
        step_noise = draw_step_noise(seeds, 10, (16, 16, 1), "cpu")
        out = {}
        for device in ("cpu", cuda):
            cfg = Config(device=str(device), image_size=16, channels=1, timesteps=10,
                         compute_dtype="float32")
            fn = make_sweep_trajectory_fn(make_unet(cfg, size_factor=0.1, seed=3), 10, cfg)
            before = cfg_engine_update.launches
            trajs = fn(noises.to(device), seeds, CFG_COND_PAIRS, 3.0,
                       step_noise=step_noise.to(device))
            out[str(device)] = (trajs.mean(dim=0).cpu(), cfg_engine_update.launches - before)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (want, cpu_launches), (got, launches) = out["cpu"], out["cuda"]
    assert (cpu_launches, launches) == (0, 9)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)
