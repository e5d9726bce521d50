"""The port on a CUDA GPU (skipped without one): the Triton kernel against
its plain version, and a train step, the InceptionV3 trunk, AlexNet-LPIPS,
the noise-prediction compute half, the sweep function's averaged chains,
the editing chain, the progressive steps (and a progressive round's
captured epoch lane against its eager per-batch loop), the int8 lane's padded
``torch._int_mm`` product, its conv and forward, and the sliding-window
sampler on the card against the CPU; the engine's kernel launches under
either value of ``Config.pallas_cfg_update``; a CFG chain sharded over two
ranks that share the card against the unsharded chain there; and the
samplers' captured lane (a maker's CUDA graph against its eager body: one
graph for three guidance scales, weights changed in place or given per
call, 9 launches counted a T=10 replay), the benches' single-seed maker
among them (one graph for three scales, and for two values of a guided
student's ``w``); the sweep's makers kept across calls (a warm-up and a
capture a model in the first of three calls, then replays alone); and the
DiT's fused attention and its captured chain, labels a graph input; the
DiT block's fused adaLN kernels against their float32 compositions, their
refusals, and a DiT-S/2 forward through them against the plain forward.

Imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
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


def test_editing_chain_on_card_matches_cpu(cuda):
    """``denoise_with_trajectory`` in engine mode with the inpainting
    ``post_step`` (sf 0.1, 16x16x1, batch 2, T=10, float32, TF32 off,
    shared weights and draws) on the card against the CPU at the sampler
    tolerance (rtol 2e-5 / atol 1e-5); every update launches the kernel."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.editing import EditingDraws, denoise_with_trajectory
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training import make_eval_model_fn

    saved = _no_tf32()
    try:
        cfg = Config(device="cpu", image_size=16, channels=1, timesteps=10,
                     compute_dtype="float32")
        dp = get_diffusion_params(10)
        gen = torch.Generator().manual_seed(3)
        original = torch.rand((2, 16, 16, 1), generator=gen) * 2 - 1
        mask = (torch.rand((1, 16, 16, 1), generator=gen) > 0.5).float()
        noise, step_noise = EditingDraws("cpu").chain(0, (2, 16, 16, 1), 9)
        out = {}
        for device in ("cpu", cuda):
            m, o = mask.to(device), original.to(device)
            model_fn = make_eval_model_fn(make_unet(cfg, size_factor=0.1, device=device, seed=4))
            before = cfg_engine_update.launches
            _, traj = denoise_with_trajectory(
                model_fn, m * noise.to(device) + (1 - m) * o, dp["alphas"], 9,
                step_noise=step_noise.to(device), post_step=lambda z: m * z + (1 - m) * o,
                diffusion_params=dp)
            out[str(device)] = (traj.cpu(), cfg_engine_update.launches - before)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (want, cpu_launches), (got, launches) = out["cpu"], out["cuda"]
    assert (cpu_launches, launches) == (0, 9) and got.shape == (11, 2, 16, 16, 1)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("guidance_range, teacher_guided",
                         [(None, False), ((1.0, 5.0), False), ((1.0, 5.0), True)],
                         ids=["plain", "guided", "teacher_guided"])
def test_progressive_step_on_card_matches_cpu(cuda, guidance_range, teacher_guided):
    """One progressive step (teacher T=10 → S=5, sf 0.1, 16x16x1, batch 8,
    float32, TF32 off, dropout 0, shared weights and draws) on the card
    against the CPU: the loss at rtol 1e-5, the gradients at rtol 1e-4 with
    an atol of 5e-5 of each tensor's largest |g|."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training.progressive import make_progressive_distill_step
    from distillation_trajectories_torch.training.state import (
        StepDraws,
        TorchDraws,
        create_train_state,
    )

    saved = _no_tf32()
    try:
        cfg = Config(device="cpu", image_size=16, channels=1, timesteps=10,
                     compute_dtype="float32", dropout=0.0)
        images = torch.rand((8, 16, 16, 1), generator=torch.Generator().manual_seed(0)) * 2 - 1
        draws = TorchDraws(2, "cpu").progressive_step(images, 5, guidance_range)
        dpt, dps = get_diffusion_params(10), get_diffusion_params(5)
        out = {}
        for device in ("cpu", cuda):
            step = make_progressive_distill_step(
                make_unet(cfg, size_factor=0.1, device=device, seed=9), dpt["alphas"],
                dps["alphas"], 10, dpt, guidance_range=guidance_range,
                teacher_guided=teacher_guided)
            model = make_unet(cfg, size_factor=0.1, device=device, seed=0)
            moved = StepDraws(draws.t.to(device), (draws.noises[0].to(device),),
                              w=None if draws.w is None else draws.w.to(device))
            _, loss = step(create_train_state(model, cfg, draws=None), images.to(device), moved)
            out[str(device)] = (float(loss), {k: p.grad.cpu() for k, p in model.named_parameters()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (want_loss, want_g), (loss, grads) = out["cpu"], out["cuda"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for k, g in grads.items():
        if _bias_feeds_batch_norm(k):
            assert g.abs().max() < 1e-6 and want_g[k].abs().max() < 1e-6, k
        else:
            atol = max(1e-7, 5e-5 * float(want_g[k].abs().max()))
            torch.testing.assert_close(g, want_g[k], rtol=1e-4, atol=atol, msg=k)


@pytest.mark.parametrize("m, k, n", [(4, 27, 32), (512, 27, 128), (17, 2304, 256),
                                     (4096, 4608, 128), (48, 144, 20), (25, 64, 32),
                                     (262144, 3, 128)])
def test_int8_matmul_padded_on_card_is_exact(cuda, m, k, n):
    """torch._int_mm on CUDA takes M > 16 and K, N multiples of 8, and an
    H100 refused small row-major products: the padded product with a
    column-major b equals the exact one at shapes that need each pad, and at
    enc1's 1x1 residual (K = 3)."""
    from distillation_trajectories_torch.models.quantized import int8_matmul

    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
    b = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen)
    got = int8_matmul(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu().long(), a.long() @ b.long())
    col = b.t().contiguous().t().to(cuda)  # the quantized weights' layout
    assert torch.equal(int8_matmul(a.to(cuda), col), got)


def test_int8_conv_and_forward_on_card_match_cpu(cuda):
    """``_qconv`` bit for bit, and the int8 forward of a seeded sf-0.1
    U-Net (float32, TF32 off) within a relative L2 of 1e-4."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.models.quantized import _qconv, make_quantized_eval_fn

    gen = torch.Generator().manual_seed(0)
    q = {"w_int8": torch.randint(-127, 128, (3, 3, 24, 40), dtype=torch.int8, generator=gen),
         "scale": torch.rand(40, generator=gen) * 1e-2, "bias": torch.randn(40, generator=gen)}
    xq = torch.randint(-127, 128, (2, 4, 4, 24), dtype=torch.int8, generator=gen)
    want = _qconv(q, xq, torch.tensor(0.03), 1)
    got = _qconv({k: v.to(cuda) for k, v in q.items()}, xq.to(cuda), torch.tensor(0.03, device=cuda), 1)
    assert torch.equal(got.cpu(), want)

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        x = torch.randn((2, 16, 16, 1), generator=gen)
        t, c = torch.tensor([2.0, 7.0]), torch.ones((2, 1))
        for device in ("cpu", cuda):
            cfg = Config(device=str(device), image_size=16, channels=1, compute_dtype="float32")
            fn = make_quantized_eval_fn(make_unet(cfg, size_factor=0.1, seed=3))
            outs.append(fn(x.to(device), t.to(device), c.to(device), c.to(device)).cpu())
        assert float((outs[1] - outs[0]).norm() / outs[0].norm()) < 1e-4
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_window_sampler_on_card_matches_sequential_chain(cuda):
    """Sliding-window ParaDiGMS at tol=0 (plain update, W·B-row forwards)
    against the sequential chain (the kernel's update tail) on the card,
    float32 with TF32 off, at the JAX window tests' tolerance; and no
    kernel launch on the window path."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.diffusion.parallel_sampling import (
        sliding_window_trajectory,
    )
    from distillation_trajectories_torch.diffusion.sampling import generate_trajectory_scan
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training import make_eval_model_fn

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = Config(device="cuda", image_size=16, channels=1, compute_dtype="float32")
        fn = make_eval_model_fn(make_unet(cfg, size_factor=0.1, seed=0))
        alphas = get_diffusion_params(10)["alphas"]
        noise = torch.randn((2, 16, 16, 1), device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(4))
        seq = generate_trajectory_scan(fn, noise, 10, alphas, seed=9, guidance_scale=4.0)
        before = cfg_engine_update.launches
        win, sweeps = sliding_window_trajectory(fn, noise, 10, alphas, seed=9,
                                                guidance_scale=4.0, window=4, tol=0.0)
        torch.cuda.synchronize()
        assert cfg_engine_update.launches == before and sweeps == 9
        torch.testing.assert_close(win, seq, rtol=1e-4, atol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_engine_launches_the_kernel_each_step_under_either_flag(cuda, monkeypatch):
    """``Config.pallas_cfg_update`` False (the default) and True on the
    card: ``generate_trajectory`` launches the kernel once a step (9 a T=10
    chain) and never calls the plain version, and the flag changes nothing
    (sf 0.1, 16x16x1, CFG at 3.0, float32, TF32 off)."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.ops import cfg_update
    from distillation_trajectories_torch.trajectories import generate_trajectory

    plain_calls = []
    monkeypatch.setattr(cfg_update, "cfg_engine_update_reference",
                        lambda *args: plain_calls.append(args))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = dict(device="cuda", image_size=16, channels=1, compute_dtype="float32")
        model = make_unet(Config(**kw), size_factor=0.1, seed=0)
        noise = torch.randn((2, 16, 16, 1), device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(4))
        trajs, made = {}, {}
        for flag in (False, True):
            before = cfg_engine_update.launches
            trajs[flag] = generate_trajectory(model, noise, 10, seed=9, guidance_scale=3.0,
                                              config=Config(pallas_cfg_update=flag, **kw))
            made[flag] = cfg_engine_update.launches - before
        torch.cuda.synchronize()
        assert made == {False: 9, True: 9} and not plain_calls
        assert torch.equal(trajs[True], trajs[False])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_sharded_chain_on_two_ranks_sharing_the_card(cuda):
    """Two ``gloo`` ranks on the one card, each its 4 rows of an 8-sample
    CFG chain through the kernel (9 launches a rank), gathered: the
    unsharded chain on the card at the sampler's tolerance."""
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.diffusion.sampling import generate_trajectory_scan
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.parallel.launch import spawn_ranks
    from distillation_trajectories_torch.training import make_eval_model_fn

    import torch_dist

    cfg = torch_dist.config(device="cuda")
    model = make_unet(cfg, size_factor=0.1, seed=2)
    gen = torch.Generator().manual_seed(6)
    noise = torch.randn((8, 16, 16, 1), generator=gen)
    step_noise = torch.randn((9, 8, 16, 16, 1), generator=gen)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    out = spawn_ranks(2, torch_dist.sharded_chain_on_card, (sd, noise, step_noise),
                      backend="gloo", timeout=300)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = generate_trajectory_scan(make_eval_model_fn(model), noise.cuda(), 10,
                                        get_diffusion_params(10, cfg)["alphas"], 0,
                                        guidance_scale=3.0, step_noise=step_noise.cuda())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for rank_out in out:
        assert rank_out["launches"] == 9
        torch.testing.assert_close(rank_out["traj"], want.cpu(), rtol=2e-4, atol=1e-5)


def _epochs(cuda, lane, family, epochs=2):
    """Two epochs of 6 batches (sf 0.1 teacher or {0.01, 0.05} student
    group, 16x16x1, batch 8, T=10, dropout 0.3, float32) through one lane:
    ``graph`` (the epoch lane: 2 eager steps, one capture, replays) or
    ``loop`` (the per-batch loop; for the group, the members in turn)."""
    import numpy as np

    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.data.datasets import DataLoader
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training import state as st
    from distillation_trajectories_torch.training.loop import run_train_epoch

    cfg = Config(image_size=16, channels=1, batch_size=8, timesteps=10, sample_steps=10,
                 compute_dtype="float32", dropout=0.3)
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (48, 16, 16, 1)).astype(np.float32)
    dataset = torch.from_numpy(images).to(cuda)
    dp = get_diffusion_params(10)
    teacher = make_unet(cfg, 0.2, seed=9)
    if family == "teacher":
        states = [st.create_train_state(make_unet(cfg, 0.1, seed=3), cfg, st.TorchDraws(11, cuda),
                                        use_ema=True)]
        fns = [(st.make_teacher_epoch_fn if lane == "graph" else st.make_teacher_train_step)(
            dp, 10, ema_rate=0.999)]
    else:
        states = [st.create_train_state(make_unet(cfg, sf, seed=int(sf * 1000)), cfg,
                                        st.TorchDraws(int(sf * 1000), cuda)) for sf in (0.01, 0.05)]
        if lane == "graph":
            states = [st.stack_train_states(states)]
            fns = [st.make_multi_distill_epoch_fn(teacher, dp, 10, 10)]
        else:
            fns = [st.make_distill_train_step(teacher, dp, 10, 10)] * 2
    losses = []
    for state, fn in zip(states, fns):
        loader = DataLoader(images, np.zeros(48, np.int32), 8, shuffle=True, seed=7)
        for _ in range(epochs):
            state, l, _ = run_train_epoch(
                state, train_step=fn, loader=loader, config=cfg, device=cuda, progress_desc="",
                log_label="", log_every=0, use_scan=lane == "graph", epoch_fn=fn,
                dataset_dev=dataset, reduce_loss=False)
            losses.append(l)
    torch.cuda.synchronize()
    if lane == "graph":
        assert isinstance(fns[0].captured[0].graph, torch.cuda.CUDAGraph)
    return losses, states


@pytest.mark.parametrize("family", ["teacher", "group"])
def test_epoch_lane_graph_matches_eager_loop(cuda, family):
    """The epoch lane's captured graph against the eager per-batch loop
    from one seed (float32, TF32 off, cuDNN deterministic): the draw
    generators end in the same state and each step's loss agrees at rtol
    1e-5.  The upsample's backward adds with atomics in no fixed order and
    Adam's first steps lift that rounding into the weights, so two eager
    runs differ too (``chip_smoke.py`` 13(a) prints by how much): each
    tensor is held to a relative norm difference of 5e-3, bar the conv
    biases that feed a BatchNorm (true gradient 0), and each weight to 2.2
    x steps x lr, Adam's bound on two runs' moves apart."""
    import numpy as np

    from distillation_trajectories_torch.training import state as st

    saved, det = _no_tf32(), torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (g_losses, g_states), (l_losses, l_states) = (_epochs(cuda, lane, family)
                                                      for lane in ("graph", "loop"))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        torch.backends.cudnn.deterministic = det
    if family == "group":  # [n, 2] member columns against each member's epochs
        members = [st.unstack_train_state(g_states[0], i) for i in range(2)]
        g_losses = [l[:, i] for i in range(2) for l in g_losses]
        g_models = [m.model for m in members]
        gens = [m.draws.generator for m in members]
    else:
        g_models, gens = [g_states[0].model], [g_states[0].draws.generator]
    for got, want in zip(gens, [s.draws.generator for s in l_states]):
        assert torch.equal(got.get_state(), want.get_state())
    np.testing.assert_allclose(np.concatenate(g_losses), np.concatenate(l_losses), rtol=1e-5)
    with torch.no_grad():
        for got, want in zip(g_models, [s.model for s in l_states]):
            ref = dict(want.named_parameters())
            for name, p in got.named_parameters():
                diff = (p - ref[name]).abs()
                assert float(diff.max()) <= 2.2 * 12 * 1e-4, name
                if not _bias_feeds_batch_norm(name):
                    assert float(diff.norm() / ref[name].norm()) <= 5e-3, name


@pytest.mark.parametrize("guidance_range, teacher_guided",
                         [(None, False), ((1.0, 5.0), False), ((1.0, 5.0), True)],
                         ids=["plain", "guided", "teacher_guided"])
def test_progressive_round_graph_matches_eager_loop(cuda, guidance_range, teacher_guided):
    """A progressive round's captured epoch lane (``make_progressive_epoch_fn``:
    2 eager steps, one capture, replays) against the eager per-batch loop
    of ``make_progressive_distill_step`` from one seed: sf 0.1, 16x16x1,
    batch 8, teacher T=10 → S=5, dropout 0.3, two epochs of 8 batches,
    float32, TF32 off, cuDNN deterministic.

    Whole rounds: the draw generators end in the same state and each
    weight lies within 2.2 x steps x lr of the loop's, Adam's bound on two
    runs' moves apart.  The upsample's backward adds with atomics in no
    fixed order, and a progressive round carries that rounding far: a
    replayed round's losses drift past 1e-5 from the loop's within a few
    steps, and two eager loops' weights past 5e-3 in a tensor's relative
    norm (``chip_smoke.py`` 13(d) prints both distances).  So the step is
    held step by step: 4 replays, each
    against the eager step from the same state restored in place
    (weights, buffers, Adam state, generator): the loss at rtol 1e-5, the
    generator left where the replay left it, and the weights after the
    step as ``chip_smoke.py::_hold_weights`` holds one step (relative norm
    5e-3 bar the conv biases that feed a BatchNorm, each weight within 2.2
    x lr)."""
    import numpy as np

    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.data.datasets import DataLoader
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training import progressive
    from distillation_trajectories_torch.training.loop import run_train_epoch
    from distillation_trajectories_torch.training.state import TorchDraws, create_train_state

    cfg = Config(image_size=16, channels=1, batch_size=8, timesteps=10, sample_steps=10,
                 compute_dtype="float32", dropout=0.3)
    images = np.random.default_rng(0).uniform(-1, 1, (64, 16, 16, 1)).astype(np.float32)
    dataset = torch.from_numpy(images).to(cuda)
    dpt, dps = get_diffusion_params(10), get_diffusion_params(5)
    args = (make_unet(cfg, 0.1, seed=9), dpt["alphas"], dps["alphas"], 10, dpt)
    kw = dict(guidance_range=guidance_range, teacher_guided=teacher_guided)
    saved, det = _no_tf32(), torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for lane in ("graph", "loop"):
            make = (progressive.make_progressive_epoch_fn if lane == "graph"
                    else progressive.make_progressive_distill_step)
            fn = make(*args, **kw)
            state = create_train_state(make_unet(cfg, 0.1, seed=0), cfg, TorchDraws(4, cuda))
            loader = DataLoader(images, np.zeros(64, np.int32), 8, shuffle=True, seed=7)
            for _ in range(2):
                state, _, _ = run_train_epoch(
                    state, train_step=fn, loader=loader, config=cfg, device=cuda,
                    progress_desc="", log_label="", log_every=0, use_scan=lane == "graph",
                    epoch_fn=fn, dataset_dev=dataset, reduce_loss=False)
            torch.cuda.synchronize()
            runs[lane] = (state, fn)
        (g, epoch_fn), (l, _) = runs["graph"], runs["loop"]
        assert g.step == l.step == 16
        assert torch.equal(g.draws.generator.get_state(), l.draws.generator.get_state())
        _assert_adam_bound(g.model, l.model, 16, cfg.lr, rel_limit=None)

        captured, eager = epoch_fn.captured[0], progressive.make_progressive_distill_step(*args, **kw)
        assert isinstance(captured.graph, torch.cuda.CUDAGraph)
        gen = g.draws.generator
        for k in range(4):
            params = list(g.model.parameters())
            tensors = [*params, *g.model.buffers(),
                       *(t for p in params for t in g.optimizer.state[p].values())]
            before, gen_before = [t.clone() for t in tensors], gen.get_state()
            captured.i.fill_(k)
            captured.graph.replay()
            replayed, gen_after = float(captured.losses[k]), gen.get_state()
            after = {name: p.detach().clone() for name, p in g.model.named_parameters()}
            with torch.no_grad():
                for t, b in zip(tensors, before):
                    t.copy_(b)
            gen.set_state(gen_before)
            _, loss = eager(g, dataset.index_select(0, captured.idx[k]))
            assert abs(replayed - float(loss)) <= 1e-5 * abs(float(loss)), k
            assert torch.equal(gen.get_state(), gen_after), k
            _assert_adam_bound(after, dict(g.model.named_parameters()), 1, cfg.lr)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        torch.backends.cudnn.deterministic = det


def _assert_adam_bound(got, want, steps, lr, rel_limit=5e-3):
    """Two trainings' weights (modules, or tensors by name) from one state:
    each weight within 2.2 x steps x lr and, unless ``rel_limit`` is None,
    each tensor within a relative norm difference of ``rel_limit``, bar
    the conv biases that feed a BatchNorm."""
    got, ref = (dict(m.named_parameters()) if isinstance(m, torch.nn.Module) else m
                for m in (got, want))
    with torch.no_grad():
        for name, p in got.items():
            diff = (p - ref[name]).abs()
            assert float(diff.max()) <= 2.2 * steps * lr, name
            if rel_limit is not None and not _bias_feeds_batch_norm(name):
                assert float(diff.norm() / ref[name].norm()) <= rel_limit, name


def test_continue_training_resumes_adam_on_the_graph_lane(cuda, tmp_path):
    """``continue_training`` on the card from a checkpoint with Adam state:
    the capturable Adam takes the restored count on the device, the epoch
    lane captures and replays, and the checkpoint it writes carries
    optax's count (3 batches a run: 2 warm-up steps, 1 replay)."""
    import importlib

    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.training import load_checkpoint, teacher

    resume = importlib.import_module("distillation_trajectories_torch.training.continue_training")
    cfg = Config(dataset="MNIST", image_size=16, channels=1, batch_size=8, timesteps=10,
                 sample_steps=10, epochs=1, limit_batches_per_epoch=3, num_samples_to_generate=0,
                 base_dir=str(tmp_path)).create_directories()
    teacher.train_teacher(cfg, seed=0)
    state = resume.continue_training(cfg, 1, seed=0)
    assert state.step == 3 and state.optimizer.defaults["capturable"]
    assert all(st["step"].device.type == "cuda" for st in state.optimizer.state.values())
    payload = load_checkpoint(cfg.teacher_models_dir, 2)
    assert int(payload["opt_state"]["0"]["count"]) == 6


def _graph_lane_makers(cuda):
    """An sf-0.1 teacher (16x16x1, T=10, float32) and its two captured
    makers: the sweep chain and the sample grid (the loop lane)."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training.teacher import make_grid_fn
    from distillation_trajectories_torch.trajectories import make_sweep_trajectory_fn

    cfg = Config(device="cuda", image_size=16, channels=1, timesteps=10, sample_steps=10,
                 compute_dtype="float32", num_samples_to_generate=4)
    model = make_unet(cfg, size_factor=0.1, seed=5)
    return model, make_sweep_trajectory_fn(model, 10, cfg), make_grid_fn(
        model, cfg, get_diffusion_params(10, cfg))


def _chain_inputs(cuda, seed, n=4, steps=9):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((n, 16, 16, 1), device=cuda, generator=gen),
            torch.randn((steps, n, 16, 16, 1), device=cuda, generator=gen))


def test_captured_chain_replays_the_eager_chain(cuda):
    """The sweep maker's captured chain on the card (T=10, float32, TF32
    off): the first call eager, the second captures; one CUDA graph then
    serves guidance 2.0, 3.0 and 7.5, each replay equal to the eager body
    bit for bit with 9 kernel launches counted and the plain version never
    called; a weight changed in place is seen by the next replay; two
    calls share no storage."""
    from distillation_trajectories_torch.diffusion.sampling import CFG_COND_PAIRS
    from distillation_trajectories_torch.ops import cfg_update

    plain = []
    saved = _no_tf32()
    try:
        model, sweep, _ = _graph_lane_makers(cuda)
        noises, step_noise = _chain_inputs(cuda, 1)
        seeds = list(range(4))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cfg_update, "cfg_engine_update_reference",
                       lambda *args: plain.append(args))
            first = sweep(noises, seeds, CFG_COND_PAIRS, 3.0, step_noise=step_noise)
            assert not sweep.graphs.graphs  # the first call runs eagerly
            for gs in (2.0, 3.0, 7.5):
                before = cfg_update.cfg_engine_update.launches
                got = sweep(noises, seeds, CFG_COND_PAIRS, gs, step_noise=step_noise)
                made = cfg_update.cfg_engine_update.launches - before
                want = sweep(noises, seeds, CFG_COND_PAIRS, gs, step_noise=step_noise, eager=True)
                torch.cuda.synchronize()
                assert made == 9 and torch.equal(got, want), gs
            assert not plain
        (graph,) = sweep.graphs.graphs.values()
        # A replay's launches of each counted wrapper: the CFG update's 9, and
        # none of the DiT's adaLN kernels in a U-Net chain.
        assert isinstance(graph.graph, torch.cuda.CUDAGraph) and graph.launches == [9, 0, 0]
        assert torch.equal(first, sweep(noises, seeds, CFG_COND_PAIRS, 3.0,
                                        step_noise=step_noise, eager=True))
        assert first.untyped_storage().data_ptr() != got.untyped_storage().data_ptr()
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.01)
        got = sweep(noises, seeds, CFG_COND_PAIRS, 3.0, step_noise=step_noise)
        want = sweep(noises, seeds, CFG_COND_PAIRS, 3.0, step_noise=step_noise, eager=True)
        assert torch.equal(got, want) and not torch.equal(got, first)
        assert len(sweep.graphs.graphs) == 1
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_cfg_and_cfg_off_graphs_share_their_static_set(cuda):
    """The sweep maker's CFG key (T=10, float32, TF32 off) warms the draws'
    signature up and is captured on its second call; its CFG-off key is
    then captured on its first call, its graph on the same static inputs
    and output (``data_ptr``), one static set; each replay, in either
    order, equals its eager body bit for bit, and the CFG-off replay
    leaves the CFG result the caller holds as it was."""
    from distillation_trajectories_torch.diffusion.sampling import (
        CFG_COND_PAIRS,
        NOCFG_COND_PAIRS,
    )

    saved = _no_tf32()
    try:
        _, sweep, _ = _graph_lane_makers(cuda)
        noises, step_noise = _chain_inputs(cuda, 4)
        call = lambda pairs, gs, eager=False: sweep(  # noqa: E731
            noises, list(range(4)), pairs, gs, step_noise=step_noise, eager=eager)
        call(CFG_COND_PAIRS, 3.0)
        on = call(CFG_COND_PAIRS, 5.0)
        off = call(NOCFG_COND_PAIRS, 1.0)
        assert len(sweep.graphs.graphs) == 2 and len(sweep.graphs._statics) == 1
        cfg_graph, off_graph = sweep.graphs.graphs.values()
        assert cfg_graph.output.data_ptr() == off_graph.output.data_ptr()
        assert [a.data_ptr() for a in cfg_graph.inputs] == \
            [a.data_ptr() for a in off_graph.inputs]
        kept = on.clone()
        for pairs, gs in ((NOCFG_COND_PAIRS, 1.0), (CFG_COND_PAIRS, 5.0), (NOCFG_COND_PAIRS, 1.0),
                          (CFG_COND_PAIRS, 2.0)):
            got = call(pairs, gs)
            want = call(pairs, gs, eager=True)
            torch.cuda.synchronize()
            assert torch.equal(got, want), gs
        assert torch.equal(off, call(NOCFG_COND_PAIRS, 1.0, eager=True))
        assert torch.equal(on, kept) and not torch.equal(on, off)
        assert len(sweep.graphs.graphs) == 2
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_captured_grid_sees_the_weights_it_is_given(cuda):
    """The sample grid's captured loop (``p_sample_loop``, T=10, float32,
    TF32 off): its replays equal the eager body on the model's own weights
    and on a weight dict given per call (as EMA weights are), and a
    replay after the given weights change equals the eager body with the
    new ones."""
    saved = _no_tf32()
    try:
        model, _, grid = _graph_lane_makers(cuda)
        noise, step_noise = _chain_inputs(cuda, 2, n=4, steps=grid.n_steps)
        ema = {k: p.detach() * 0.99 for k, p in model.named_parameters()}
        for params in (None, ema):
            for _ in range(3):  # eager, capture, replay
                got = grid(noise, step_noise, params)
            want = grid.loop(noise, step_noise, params, eager=True)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        assert len(grid.loop.graphs.graphs) == 2
        assert all(isinstance(g.graph, torch.cuda.CUDAGraph)
                   for g in grid.loop.graphs.graphs.values())
        ema = {k: v * 1.02 for k, v in ema.items()}
        got = grid(noise, step_noise, ema)
        assert torch.equal(got, grid.loop(noise, step_noise, ema, eager=True))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_bench_chain_maker_replays_its_eager_body(cuda):
    """The benches' single-seed maker (``sampling.make_chain_fn``, T=10,
    float32, TF32 off): a CFG chain whose one graph serves guidance 2.0,
    3.0 and 7.5, and a guided student's chain whose one graph serves two
    values of its ``w`` tensor, set in place; each replay equal to the
    eager body bit for bit, 9 kernel launches counted a replay, the plain
    version never called."""
    from distillation_trajectories_torch.diffusion import get_diffusion_params, sampling
    from distillation_trajectories_torch.ops import cfg_update
    from distillation_trajectories_torch.training import make_eval_model_fn
    from distillation_trajectories_torch.training.progressive import make_guided_eval_fn
    from distillation_trajectories_torch.utils.graphs import sampler_lane_captures

    plain = []
    saved = _no_tf32()
    try:
        model, _, _ = _graph_lane_makers(cuda)
        alphas = get_diffusion_params(10)["alphas"]
        noise, step_noise = _chain_inputs(cuda, 3)
        w = torch.zeros((), device=cuda)
        chains = {
            "cfg": (sampling.make_chain_fn(make_eval_model_fn(model), 10, alphas,
                                           captures=sampler_lane_captures), (2.0, 3.0, 7.5)),
            "guided": (sampling.make_chain_fn(make_guided_eval_fn(model, w), 10, alphas,
                                              captures=sampler_lane_captures), (2.0, 4.5)),
        }

        def call(name, fn, g, eager=False):
            w.fill_(g)
            return fn(noise, 0, g if name == "cfg" else None, step_noise=step_noise, eager=eager)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cfg_update, "cfg_engine_update_reference",
                       lambda *args: plain.append(args))
            for name, (chain, values) in chains.items():
                call(name, chain, values[0])
                assert not chain.graphs.graphs, name  # the first call runs eagerly
                for g in values:
                    before = cfg_update.cfg_engine_update.launches
                    got = call(name, chain, g)
                    made = cfg_update.cfg_engine_update.launches - before
                    want = call(name, chain, g, eager=True)
                    torch.cuda.synchronize()
                    assert made == 9 and torch.equal(got, want), (name, g)
                (graph,) = chain.graphs.graphs.values()
                assert isinstance(graph.graph, torch.cuda.CUDAGraph) and \
                    graph.launches == [9, 0, 0]  # the CFG update's; no adaLN kernel
            assert not plain
        a, b = (call("guided", chains["guided"][0], g) for g in (2.0, 4.5))
        assert not torch.equal(a, b)  # each replay read w where it was set
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_maker_calls_record_warmup_then_capture_and_replay_then_replay(cuda):
    """The sweep maker's first three calls for one key (T=10, float32) under
    the span recorder: ``graph.warmup``; ``graph.capture`` then
    ``graph.replay``; ``graph.replay``, each with the call's key, and the
    step-noise draw before each."""
    from distillation_trajectories_torch.diffusion.sampling import CFG_COND_PAIRS
    from distillation_trajectories_torch.utils.profiling import recording

    _, sweep, _ = _graph_lane_makers(cuda)
    noises, _ = _chain_inputs(cuda, 2)
    names = []
    for _ in range(3):
        with recording() as rec:
            sweep(noises, list(range(4)), CFG_COND_PAIRS, 3.0)
        torch.cuda.synchronize()
        spans = sorted(rec.spans, key=lambda s: s.start_ns)
        names.append([s.name for s in spans])
        graph = [s for s in spans if s.name.startswith("graph.")]
        assert all(s.attrs["key"] == CFG_COND_PAIRS.tobytes() for s in graph)
    assert names == [["draws", "graph.warmup"], ["draws", "graph.capture", "graph.replay"],
                     ["draws", "graph.replay"]]


def test_sweep_calls_replay_resident_makers(cuda):
    """Three sweep calls with the same three models (16x16x1, T=10, float32,
    TF32 off, scales 1, 2, 3 and 5) under the span recorder: the first
    warms each model up on its first CFG scale, captures its CFG chain on
    the second and its CFG-off chain on its one run, so the next two only
    replay, every chain of them; the third call's metric means equal those
    of a call on freshly built models with the same draws (NaN where
    ``trajectory_mse`` is, on both sides), and the third call reserves no
    more than the second (which reserves a little more than the first,
    whose captures emptied the allocator's cache)."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.trajectories import sweep_compare_trajectories_multi
    from distillation_trajectories_torch.utils.profiling import recording

    scales = (1.0, 2.0, 3.0, 5.0)
    cfg = Config(device="cuda", image_size=16, channels=1, timesteps=10, sample_steps=10,
                 compute_dtype="float32")

    def call(teacher, students):
        job = {"students": students, "guidance_scales": scales, "num_samples": 4,
               "base_seed": 3, "timesteps": 10}
        with recording() as rec:
            out = sweep_compare_trajectories_multi(teacher, [job], cfg, verbose=False)[0]
        torch.cuda.synchronize()
        names = [s.name for s in rec.spans]
        return out, tuple(names.count(n) for n in ("graph.warmup", "graph.capture",
                                                   "graph.replay"))

    def models():
        return (make_unet(cfg, size_factor=0.2, seed=5),
                {sf: make_unet(cfg, size_factor=sf, seed=i) for i, sf in enumerate((0.1, 0.2))})

    saved = _no_tf32()
    try:
        teacher, students = models()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs, counts, peaks = [], [], []
        for _ in range(3):
            out, n = call(teacher, students)
            outs.append(out)
            counts.append(n)
            peaks.append(torch.cuda.max_memory_reserved())
        cfg_scales = len(scales) - 1
        assert counts == [(3, 6, 3 * (cfg_scales - 1) + 3), (0, 0, 3 * len(scales)),
                          (0, 0, 3 * len(scales))]
        assert peaks[2] == peaks[1]  # the steady calls reserve nothing more
        np.testing.assert_equal(outs[2], call(*models())[0])  # NaN equals NaN
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sweep_between_replayed_epochs_sees_the_trained_weights(cuda, quant):
    """An epoch of an sf-0.1 teacher on the epoch lane (2 eager steps, the
    capture, 4 replays), a sweep, an epoch of 6 replays alone (the weights
    change in place and no ``_version`` rises), then a sweep (16x16x1,
    T=10, float32, TF32 off, scales 1, 2 and 3): the plain makers stay
    resident and their replays read the trained weights in place; the int8
    ones, which fold the weights, are built anew.  Either way the second
    sweep's metric means equal those of a sweep on fresh copies of the
    trained models."""
    import copy

    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.data.datasets import DataLoader
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.models import make_unet
    from distillation_trajectories_torch.training import state as st
    from distillation_trajectories_torch.training.loop import run_train_epoch
    from distillation_trajectories_torch.trajectories import sweep_compare_trajectories_multi
    from distillation_trajectories_torch.utils.profiling import recording

    cfg = Config(device="cuda", image_size=16, channels=1, batch_size=8, timesteps=10,
                 sample_steps=10, compute_dtype="float32", dropout=0.3, sampler_quant=quant)
    images = np.random.default_rng(0).uniform(-1, 1, (48, 16, 16, 1)).astype(np.float32)
    dataset = torch.from_numpy(images).to(cuda)
    loader = DataLoader(images, np.zeros(48, np.int32), 8, shuffle=True, seed=7)
    fn = st.make_teacher_epoch_fn(get_diffusion_params(10), 10)
    state = st.create_train_state(make_unet(cfg, 0.1, seed=3), cfg, st.TorchDraws(11, cuda))
    students = {0.2: make_unet(cfg, 0.2, seed=5)}

    def epoch(state):
        state, _, _ = run_train_epoch(
            state, train_step=fn, loader=loader, config=cfg, device=cuda, progress_desc="",
            log_label="", log_every=0, use_scan=True, epoch_fn=fn, dataset_dev=dataset,
            reduce_loss=False)
        torch.cuda.synchronize()
        return state

    def sweep(teacher, students):
        job = {"students": students, "guidance_scales": (1.0, 2.0, 3.0), "num_samples": 4,
               "base_seed": 3, "timesteps": 10}
        with recording() as rec:
            out = sweep_compare_trajectories_multi(teacher, [job], cfg, verbose=False)[0]
        (makers,) = [s.attrs["built"] for s in rec.spans if s.name == "sweep.makers"]
        return out, makers

    saved = _no_tf32()
    try:
        state = epoch(state)
        first, built = sweep(state.model, students)
        assert built == 2
        versions = [p._version for p in state.model.parameters()]
        state = epoch(state)
        assert [p._version for p in state.model.parameters()] == versions
        second, built = sweep(state.model, students)
        assert built == (0 if quant == "none" else 2)
        endpoint = lambda out: out[0.2]["student_metrics"][3.0]["endpoint_distance"]
        assert endpoint(second) != endpoint(first)
        fresh = copy.deepcopy(state.model), {sf: copy.deepcopy(m) for sf, m in students.items()}
        np.testing.assert_equal(second, sweep(*fresh)[0])  # NaN equals NaN
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_epoch_records_two_warmups_one_capture_and_one_replay_span(cuda):
    """An epoch of 6 batches on the epoch lane under the span recorder:
    ``epoch.warmup`` for each of the 2 eager steps, ``epoch.capture`` once
    and one ``epoch.replay`` over the 4 replays (no span a replay), all
    inside ``train.epoch``; the next epoch records its replay span alone."""
    from distillation_trajectories_torch.utils.profiling import recording

    with recording() as rec:
        _epochs(cuda, "graph", "teacher", epochs=2)
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    epochs = [s for s in spans if s.name == "train.epoch"]
    assert [s.attrs["batches"] for s in epochs] == [6, 6]
    inside = [[s.name for s in spans if s.call == e.id and s is not e] for e in epochs]
    assert inside == [["epoch.warmup", "epoch.warmup", "epoch.capture", "epoch.replay",
                       "train.loss_fetch"], ["epoch.replay", "train.loss_fetch"]]
    assert [s.attrs["batches"] for s in spans if s.name == "epoch.replay"] == [4, 6]


def _dit(cuda, seed, dtype=torch.bfloat16, **sizes):
    from distillation_trajectories_torch.models.dit import DiT, init_dit_

    sizes = {"depth": 2, "hidden_size": 384, "num_heads": 6, **sizes}
    model = DiT(input_size=32, in_channels=4, dtype=dtype, **sizes).to(cuda)
    return init_dit_(model, torch.Generator(device=cuda).manual_seed(seed)).eval()


@pytest.mark.parametrize("hidden, heads", [(384, 6), (1152, 16)])  # head dims 64 and 72
def test_dit_forward_launches_fused_attention(cuda, hidden, heads):
    """A two-block DiT forward on the card (bf16 autocast, 32x32x4, 256
    tokens) under the profiler, at DiT-S/2's width and head dim 64 and at
    DiT-XL/2's width and head dim 72 (not a power of two): its attention
    runs in PyTorch's fused kernels (flash, cuDNN or memory-efficient), and
    no math-path softmax kernel is launched."""
    from torch.profiler import ProfilerActivity, profile

    model = _dit(cuda, 0, hidden_size=hidden, num_heads=heads)
    x = torch.randn((8, 32, 32, 4), device=cuda)
    t = torch.full((8,), 17.0, device=cuda)
    ones = torch.ones((8, 1), device=cuda)
    labels = torch.arange(8, device=cuda)
    with torch.no_grad():  # the adaLN kernels have no backward
        model(x, t, ones, ones, labels)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = model(x, t, ones, ones, labels)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    fused = [n for n in names if any(k in n for k in ("flash", "fmha", "sdpa", "attention"))]
    assert fused, names
    assert not [n for n in names if "softmax" in n.lower()], names
    assert out.shape == (8, 32, 32, 4) and out.dtype == torch.float32
    assert torch.isfinite(out).all()


def test_dit_chain_replay_equals_its_eager_body(cuda):
    """The sweep maker's captured chain of a DiT (bf16 autocast, 32x32x4,
    T=10): the labels ride in as a graph input, so one graph serves two
    label sets and two guidance scales, each replay equal to the eager body
    bit for bit; the graph's inputs are the noises, the step noise, the
    scalar table and the labels.  Every eager forward runs the fused adaLN
    kernels (its span says "fused"), and a replay counts the launches of
    its eager body: 18 forwards of one ``ln_modulate`` and four
    ``gate_add_ln_modulate`` each."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.diffusion.sampling import CFG_COND_PAIRS
    from distillation_trajectories_torch.ops.adaln import gate_add_ln_modulate, ln_modulate
    from distillation_trajectories_torch.trajectories.engine import make_sweep_trajectory_fn
    from distillation_trajectories_torch.utils.profiling import recording

    def launches():
        return ln_modulate.launches, gate_add_ln_modulate.launches

    cfg = Config(device="cuda", image_size=32, channels=4, timesteps=10, architecture="dit")
    model = _dit(cuda, 1)
    sweep = make_sweep_trajectory_fn(model, 10, cfg)
    gen = torch.Generator(device=cuda).manual_seed(2)
    noises = torch.randn((4, 32, 32, 4), device=cuda, generator=gen)
    step_noise = torch.randn((9, 4, 32, 32, 4), device=cuda, generator=gen)
    seeds = list(range(4))
    a, b = torch.tensor([1, 2, 3, 999], device=cuda), torch.tensor([7, 7, 0, 5], device=cuda)
    with recording() as rec:
        sweep(noises, seeds, CFG_COND_PAIRS, 4.0, step_noise=step_noise, labels=a)
        outs = []
        for labels, gs in ((a, 4.0), (b, 4.0), (a, 1.5)):
            start = launches()
            got = sweep(noises, seeds, CFG_COND_PAIRS, gs, step_noise=step_noise, labels=labels)
            replayed = launches()
            want = sweep(noises, seeds, CFG_COND_PAIRS, gs, step_noise=step_noise,
                         labels=labels, eager=True)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (labels, gs)
            outs.append(got)
            assert [n - m for n, m in zip(replayed, start)] == [18, 72]
            assert [n - m for n, m in zip(launches(), replayed)] == [18, 72]
    forwards = [s.attrs["adaln"] for s in rec.spans if s.name == "dit.forward"]
    assert len(forwards) > 18 and set(forwards) == {"fused"}
    assert not torch.equal(outs[0], outs[1])  # the labels reach the graph
    (graph,) = sweep.graphs.graphs.values()
    assert [tuple(i.shape) for i in graph.inputs] == [(4, 32, 32, 4), (9, 4, 32, 32, 4),
                                                      (9, 4), (4,)]


def _adaln_operands(cuda, width, b, n, low, seed=0):
    """Float32 residual rows ``[b, n, width]``, a branch output and the
    ``(gate, shift, scale)`` chunks (strided views) of two ``[b, 6D]``
    adaLN outputs, the last three in ``low`` (the autocast dtype)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, n, width), device=cuda, generator=gen) * 3 + 0.5
    y = torch.randn((b, n, width), device=cuda, generator=gen).to(low)
    first = torch.randn((b, 6 * width), device=cuda, generator=gen).to(low).chunk(6, dim=1)
    second = torch.randn((b, 6 * width), device=cuda, generator=gen).to(low).chunk(6, dim=1)
    return x, y, first[2], second[0], second[1]


def _bf16_ulp(v):
    """One bf16 ulp of each value of float32 ``v`` (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs())) - 7)


@pytest.mark.parametrize("gated", [False, True], ids=["ln_modulate", "gate_add_ln_modulate"])
@pytest.mark.parametrize("width", [384, 768, 1152])
@pytest.mark.parametrize("b, n", [(32, 256), (3, 100)], ids=["8192rows", "300rows"])
@pytest.mark.parametrize("low", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_adaln_kernel_matches_its_plain_composition(cuda, gated, width, b, n, low):
    """Each fused adaLN kernel against its plain composition on the same
    operands (the modulations strided chunks, bf16 under autocast with a
    bf16 branch output, or float32 throughout): under autocast ``x'``
    equals the composition's bit for bit (the kernel rounds ``gate·y`` to
    bf16 as PyTorch does, then sums in float32) and ``h`` lies within one
    bf16 ulp of the composition's float32 result (within 1e-5 near zero,
    where the statistics' float32 rounding shows); in float32 ``h`` lies
    within float32 rounding of its statistics (1e-5) and ``x'`` within two
    float32 roundings of ``|x| + 2|gate·y|`` (the kernel may contract the
    product and the sum into one fused multiply-add).  ``x'`` is written
    over ``x``; ``ln_modulate`` leaves ``x`` as it was."""
    from distillation_trajectories_torch.ops.adaln import (
        gate_add_ln_modulate,
        gate_add_ln_modulate_reference,
        ln_modulate,
        ln_modulate_reference,
    )

    x, y, gate, shift, scale = _adaln_operands(cuda, width, b, n, low)
    x0 = x.clone()
    counter = gate_add_ln_modulate if gated else ln_modulate
    before = counter.launches
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16,
                                         enabled=low == torch.bfloat16):
        if gated:
            got_x, got_h = gate_add_ln_modulate(x, y, gate, shift, scale)
        else:
            got_h = ln_modulate(x, shift, scale)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    if gated:
        want_x, want_h = gate_add_ln_modulate_reference(x0, y, gate, shift, scale)
        assert got_x is x  # the residual stream updated in place
        if low == torch.bfloat16:
            assert torch.equal(got_x, want_x)
        else:
            tol = 2.0 ** -23 * (x0.abs() + 2 * (gate.unsqueeze(1) * y).abs())
            assert ((got_x - want_x).abs() <= tol).all()
    else:
        want_h = ln_modulate_reference(x0, shift, scale)
        assert torch.equal(x, x0)
    assert want_h.dtype == torch.float32
    assert got_h.dtype == low and got_h.shape == x.shape and got_h.is_contiguous()
    if low == torch.bfloat16:
        assert ((got_h.float() - want_h).abs() <= _bf16_ulp(want_h) + 1e-5).all()
    else:
        torch.testing.assert_close(got_h, want_h, rtol=1e-5, atol=1e-5)


def _bad_adaln_calls(cuda):
    from distillation_trajectories_torch.ops.adaln import gate_add_ln_modulate, ln_modulate

    x, y, gate, shift, scale = _adaln_operands(cuda, 384, 2, 16, torch.bfloat16)
    wide = _adaln_operands(cuda, 2064, 2, 16, torch.bfloat16)
    leaf = x.clone().requires_grad_()
    col_strided = torch.randn((384, 2), device=cuda).bfloat16().t()
    return {
        "x not contiguous": lambda: ln_modulate(x.transpose(0, 1).contiguous().transpose(0, 1),
                                                shift, scale),
        "x bf16": lambda: ln_modulate(x.bfloat16(), shift, scale),
        "x 2-D": lambda: ln_modulate(x.reshape(-1, 384), shift, scale),
        "width over 2048": lambda: ln_modulate(wide[0], wide[3], wide[4]),
        "shift shape": lambda: ln_modulate(x, shift[:1], scale),
        "scale column stride": lambda: ln_modulate(x, shift, col_strided),
        "scale float16": lambda: ln_modulate(x, shift, scale.half()),
        "y shape": lambda: gate_add_ln_modulate(x, y[:, :8], gate, shift, scale),
        "y on the CPU": lambda: gate_add_ln_modulate(x, y.cpu(), gate, shift, scale),
        "y not of gate's dtype": lambda: gate_add_ln_modulate(x, y.float(), gate, shift, scale),
        "gate on the CPU": lambda: gate_add_ln_modulate(x, y, gate.cpu(), shift, scale),
        "autograd records": lambda: ln_modulate(leaf, shift, scale),
    }


BAD_ADALN_CALLS = ["x not contiguous", "x bf16", "x 2-D", "width over 2048", "shift shape",
                   "scale column stride", "scale float16", "y shape", "y on the CPU",
                   "y not of gate's dtype", "gate on the CPU", "autograd records"]


@pytest.mark.parametrize("call", BAD_ADALN_CALLS)
def test_adaln_wrappers_raise_on_what_the_kernel_does_not_take(cuda, call):
    """On the card a wrapper launches its kernel or raises: no fallback to
    the plain composition for any operand the kernel does not take."""
    from distillation_trajectories_torch.ops.adaln import gate_add_ln_modulate, ln_modulate

    before = ln_modulate.launches + gate_add_ln_modulate.launches
    with pytest.raises(ValueError):
        _bad_adaln_calls(cuda)[call]()
    assert ln_modulate.launches + gate_add_ln_modulate.launches == before


# Relative L2 of a DiT-S/2 forward (bf16 autocast) fused against plain.  The
# two round alike and differ only by float32 reordering in the statistics,
# which flips a few of h's bf16 roundings; twelve bf16 blocks spread those
# to their own noise floor: 2.9e-3 measured on the H100, where the plain
# forward lies 4.9e-3 from the float32 one.
DIT_FUSED_VS_PLAIN = 1e-2


def test_dit_forward_runs_the_fused_kernels_and_matches_the_plain_one(cuda):
    """A DiT-S/2 forward on the card (12 blocks of width 384, bf16
    autocast, 8 samples of 256 tokens): under ``torch.no_grad()`` it runs
    the fused kernels, one ``ln_modulate`` and two ``gate_add_ln_modulate``
    a block, its ``dit.forward`` span says "fused", and it lies within
    ``DIT_FUSED_VS_PLAIN`` relative L2 of the same forward through the
    plain compositions (the model's adaLN calls patched to them), which
    launches neither kernel; both lie as close to the float32 model.  A
    forward on the card that autograd would record raises."""
    from unittest import mock

    from distillation_trajectories_torch.models import dit
    from distillation_trajectories_torch.models.dit import DIT_VARIANTS
    from distillation_trajectories_torch.ops.adaln import (
        gate_add_ln_modulate,
        gate_add_ln_modulate_reference,
        ln_modulate,
        ln_modulate_reference,
    )
    from distillation_trajectories_torch.utils.profiling import recording

    sizes = {k: DIT_VARIANTS["DiT-S/2"][k] for k in ("depth", "hidden_size", "num_heads")}
    model = _dit(cuda, 3, **sizes)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((8, 32, 32, 4), device=cuda, generator=gen)
    t = torch.full((8,), 250.0, device=cuda)
    ones = torch.ones((8, 1), device=cuda)
    labels = torch.arange(8, device=cuda) * 97

    def launches():
        return ln_modulate.launches, gate_add_ln_modulate.launches

    before = launches()
    with torch.no_grad():
        with recording() as rec:
            fused = model(x, t, ones, ones, labels)
        after = launches()
        with mock.patch.object(dit, "ln_modulate", ln_modulate_reference), \
                mock.patch.object(dit, "gate_add_ln_modulate", gate_add_ln_modulate_reference):
            plain = model(x, t, ones, ones, labels)
    assert after == (before[0] + 1, before[1] + 2 * sizes["depth"])
    assert launches() == after
    assert [s.attrs["adaln"] for s in rec.spans if s.name == "dit.forward"] == ["fused"]
    with pytest.raises(ValueError, match="no backward"):
        model(x, t, ones, ones, labels)
    assert launches() == after
    model.dtype = torch.float32
    with torch.no_grad():
        exact = model(x, t, ones, ones, labels)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    gap = rel(fused, plain)
    print(f"DiT-S/2 fused vs plain {gap:.3e}, fused vs float32 {rel(fused, exact):.3e}, "
          f"plain vs float32 {rel(plain, exact):.3e}")
    assert gap < DIT_FUSED_VS_PLAIN
    assert rel(fused, exact) < 1.1 * rel(plain, exact)
