"""The plain reference against the port in float32 on the CPU, and the
draws it works out against the program's own."""

import numpy as np
import pytest
import torch

from h100_bench.reference import chain as ref_chain
from h100_bench.reference import metrics as ref_metrics
from h100_bench.reference import unet as ref_unet
from h100_bench.reference.train import TeacherSteps
from h100_bench.yardstick import draws as D
from h100_bench.yardstick.schedule import linear_schedule
from h100_bench.yardstick.weights import make_weights, param_count


def _port_unet(sf, channels, weights, dropout=0.0):
    from distillation_trajectories_torch.models.unet import DiffusionUNet

    m = DiffusionUNet(channels=channels, size_factor=sf, dtype=torch.float32, dropout=dropout)
    m.load_state_dict(weights, strict=True)
    return m.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("sf, channels, params", [
    (1.0, 3, 9_816_451), (0.5, 3, 2_458_819), (0.1, 3, 153_049), (1.0, 1, 9_813_633)])
def test_weights_have_the_published_shapes(sf, channels, params):
    assert param_count(make_weights(sf, channels, 3, "cpu")) == params


@pytest.mark.parametrize("sf", [0.1, 0.5])
def test_forward_matches_the_port(sf):
    w = make_weights(sf, 3, 11, "cpu")
    model = _port_unet(sf, 3, w).eval()
    x = torch.randn(3, 16, 16, 3)
    t = torch.tensor([1.0, 20.0, 99.0])
    cond, mask = torch.tensor([[1.0], [0.0], [1.0]]), torch.tensor([[1.0], [1.0], [0.0]])
    with torch.no_grad():
        got = model(x, t, cond, mask)
        want = ref_unet.forward(w, x, t, cond, mask, sf)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_chain_and_metrics_match_the_port():
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.metrics.trajectory_metrics import batch_metrics_core
    from distillation_trajectories_torch.trajectories.engine import make_batch_trajectory_fn

    cfg = Config(image_size=16, channels=3, compute_dtype="float32", device="cpu",
                 base_dir="/nonexistent")
    T, seeds, shape = 6, [5, 6], (16, 16, 3)
    wt, ws = make_weights(0.1, 3, 1, "cpu"), make_weights(0.1, 3, 2, "cpu")
    noises = D.seeded_normal([(s, 0) for s in seeds], shape, "cpu")
    sn = D.step_noise(seeds, T, shape, "cpu")
    alphas = linear_schedule(T, 1e-4, 0.02)["alphas"]
    trajs = {}
    for key, w in (("t", wt), ("s", ws)):
        fn = make_batch_trajectory_fn(_port_unet(0.1, 3, w), T, cfg, use_cfg=True, device="cpu")
        got = fn(noises, seeds, 3.0)  # the port draws its own step noise from the seeds
        want = ref_chain.chain(lambda x, t, c, m: ref_unet.forward(w, x, t, c, m, 0.1),
                               noises, sn, alphas, T, True, 3.0)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        trajs[key] = want
    u = D.sweep_uniforms(9, 2, T, 16 * 16 * 3, "cpu")
    got = batch_metrics_core(trajs["t"], trajs["s"], u)
    want = ref_metrics.scalar_metrics(trajs["t"], trajs["s"], u)
    for name, v in want.items():
        torch.testing.assert_close(got[name], v, rtol=1e-5, atol=1e-7, equal_nan=True)


def test_draws_match_the_program():
    from distillation_trajectories_torch.data.native import shuffle_indices
    from distillation_trajectories_torch.diffusion.sampling import draw_step_noise, seeded_normal

    assert torch.equal(D.seeded_normal([(3, 0), (2 ** 31 + 5, 7)], (4, 4, 1), "cpu"),
                       seeded_normal([(3, 0), (2 ** 31 + 5, 7)], (4, 4, 1), "cpu"))
    assert torch.equal(D.step_noise([1, 2], 5, (4, 4, 1), "cpu"),
                       draw_step_noise([1, 2], 5, (4, 4, 1), "cpu"))
    for n, seed in ((10, 3), (4097, (2 ** 33 + 7) * 1_000_003 + 2)):
        np.testing.assert_array_equal(D.shuffle_indices(n, seed),
                                      shuffle_indices(n, seed & D.MASK64))


def test_mt19937_64_known_output():
    rng = D.MT19937_64(5489)
    for _ in range(9999):
        rng()
    assert rng() == 9981545732273789042  # the C++ standard's check value


def test_teacher_steps_match_the_ports_trainer():
    """Three steps of the port's epoch lane (eager on the CPU) against the
    reference's, from the same weights, rows and draw stream."""
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.diffusion.schedules import get_diffusion_params
    from distillation_trajectories_torch.training.state import (
        TorchDraws, create_train_state, make_teacher_epoch_fn)

    T, B = 8, 4
    cfg = Config(image_size=32, channels=1, compute_dtype="float32", dropout=0.3, device="cpu",
                 base_dir="/nonexistent")
    w = make_weights(0.1, 1, 4, "cpu")
    state = create_train_state(_port_unet(0.1, 1, w, dropout=0.3), cfg, TorchDraws(77, "cpu"))
    epoch = make_teacher_epoch_fn(get_diffusion_params(T, cfg), T)
    images = torch.rand(12, 32, 32, 1) * 2 - 1
    idx = np.arange(12).reshape(3, B)
    state, losses = epoch(state, images, idx)
    steps = TeacherSteps(w, 0.1, linear_schedule(T, 1e-4, 0.02), T, 1e-4, 0.3,
                         torch.Generator().manual_seed(77))
    with torch.enable_grad():
        want = [steps.step(images[torch.as_tensor(r)]) for r in idx]
    np.testing.assert_allclose(losses.numpy(), want, rtol=1e-5)
    # Each moving leaf's change (a convolution's bias ahead of BatchNorm has
    # no gradient but rounding, and Adam moves it by +-lr on that alone).
    # Adam's first steps move an element by about +-lr whatever the size of
    # its gradient, so elements whose gradient is near zero carry float32
    # rounding into the change: a leaf's norm agrees to about 1e-3.
    norms = {k: float(g.norm()) for k, g in steps.grads[0].items()}
    median = np.median(list(norms.values()))
    for name, p in state.model.named_parameters():
        if norms[name] >= 1e-3 * median:
            got = float((p.detach() - w[name]).norm())
            want_change = float((steps.params[name].detach() - w[name]).norm())
            assert got == pytest.approx(want_change, rel=1e-2), name
