"""The port on a CUDA GPU (skipped without one): the Triton kernel against
its plain version, and a train step, the InceptionV3 trunk, AlexNet-LPIPS,
the noise-prediction compute half, the sweep function's averaged chains,
the editing chain, the progressive steps, the int8 lane's padded
``torch._int_mm`` product, its conv and forward, and the sliding-window
sampler on the card against the CPU; the engine's kernel launches under
either value of ``Config.pallas_cfg_update``; and a CFG chain sharded over two
ranks that share the card against the unsharded chain there.

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
