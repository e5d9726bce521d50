"""DiT teacher training on a CUDA GPU (skipped without one): the adaLN
passes' Triton backward against autograd of their plain compositions at
the published widths, the gated pass writing ``x'`` in place only without
autograd, the backward launches of a DiT-XL/2 step counted through the
epoch lane's replays, and a captured DiT-S/2 epoch against its eager
per-batch steps.

Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dit_train.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _operands(cuda, width, b, n, low, seed=0):
    """Float32 residual rows, a branch output, the ``(gate, shift, scale)``
    chunks (strided views) of two ``[b, 6D]`` adaLN outputs, and the
    gradients of ``h`` (in h's dtype) and of ``x'`` (float32)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, n, width), device=cuda, generator=gen) * 3 + 0.5
    y = torch.randn((b, n, width), device=cuda, generator=gen).to(low)
    first = torch.randn((b, 6 * width), device=cuda, generator=gen).to(low).chunk(6, dim=1)
    second = torch.randn((b, 6 * width), device=cuda, generator=gen).to(low).chunk(6, dim=1)
    dh = torch.randn((b, n, width), device=cuda, generator=gen).to(low)
    dxs = torch.randn((b, n, width), device=cuda, generator=gen)
    return x, y, first[2], second[0], second[1], dh, dxs


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# A float32 gradient against autograd's: LayerNorm's backward and the column
# sums add in other orders (measured up to ~1e-6 relative L2 on the H100).
F32_REL = 1e-5
# A bf16 gradient: rounded from float32 values that differ as above, so a
# few elements round to the neighbouring bf16 value (one ulp, 2^-8 relative).
BF16_REL = 2e-3


@pytest.mark.parametrize("pass_", ["ln", "gated", "gated_no_dxs"])
@pytest.mark.parametrize("width", [384, 768, 1152])
@pytest.mark.parametrize("b, n", [(32, 256), (3, 100)], ids=["8192rows", "300rows"])
@pytest.mark.parametrize("low", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_adaln_backward_kernel_matches_autograd_of_the_composition(cuda, pass_, width, b, n,
                                                                   low):
    """Each wrapper under autograd on the card (the forward kernel, then the
    backward kernel) against autograd of the ``*_reference`` composition on
    the same operands, ``h`` cast to ``low`` as the next ``Linear`` reads
    it, under bf16 autocast or in float32: every gradient in its operand's
    dtype and shape, float32 ones within ``F32_REL`` and bf16 ones within
    ``BF16_REL`` relative L2, and each backward launch counted once."""
    from distillation_trajectories_torch.ops import adaln

    x, y, gate, shift, scale, dh, dxs = _operands(cuda, width, b, n, low)
    gated = pass_ != "ln"
    ops = (x, y, gate, shift, scale) if gated else (x, shift, scale)
    counter = adaln.gate_add_ln_modulate_backward if gated else adaln.ln_modulate_backward
    mine = [a.clone().requires_grad_() for a in ops]
    ref = [a.clone().requires_grad_() for a in ops]
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=low == torch.bfloat16):
        if gated:
            got_x, got_h = adaln.gate_add_ln_modulate(*mine)
        else:
            got_h = adaln.ln_modulate(*mine)
    if gated:
        want_x, want_h = adaln.gate_add_ln_modulate_reference(*ref)
        with_dxs = pass_ == "gated"
        outs, wants = ([got_h, got_x], [want_h.to(low), want_x]) if with_dxs else \
            ([got_h], [want_h.to(low)])
        grads = [dh, dxs] if with_dxs else [dh]
    else:
        outs, wants, grads = [got_h], [adaln.ln_modulate_reference(*ref).to(low)], [dh]
    before = counter.launches
    got = torch.autograd.grad(outs, mine, grads)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = torch.autograd.grad(wants, ref, grads)
    gaps = []
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        gaps.append(_rel(g, w))
        assert gaps[-1] <= (F32_REL if w.dtype == torch.float32 else BF16_REL)
    print(f"{pass_} {width} {b}x{n} {low}: relative L2 gaps {['%.2e' % v for v in gaps]}")


def test_gated_pass_writes_x_in_place_only_without_autograd(cuda):
    """Under ``torch.no_grad()`` the gated pass writes ``x'`` over ``x``, as
    the samplers run it; where autograd records it, ``x'`` is a new tensor
    of the same values and ``x`` is left as it was."""
    from distillation_trajectories_torch.ops.adaln import gate_add_ln_modulate

    x, y, gate, shift, scale, _, _ = _operands(cuda, 1152, 4, 256, torch.bfloat16)
    x0 = x.clone()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        leaf = x0.clone().requires_grad_()
        rec_x, rec_h = gate_add_ln_modulate(leaf, y, gate, shift, scale)
        with torch.no_grad():
            got_x, got_h = gate_add_ln_modulate(x, y, gate, shift, scale)
    assert got_x is x and rec_x is not leaf and torch.equal(leaf.detach(), x0)
    assert torch.equal(rec_x.detach(), got_x) and torch.equal(rec_h.detach(), got_h)
    assert rec_x.requires_grad and rec_h.requires_grad


def _dit_state(cuda, variant, seed, batch, n=None):
    from distillation_trajectories_torch.config import Config
    from distillation_trajectories_torch.models import make_model
    from distillation_trajectories_torch.training import state as st

    cfg = Config(device="cuda", image_size=32, channels=4, timesteps=1000, lr=1e-4,
                 batch_size=batch, compute_dtype="bfloat16", architecture="dit")
    model = make_model(cfg, variant, device=cuda, seed=seed)
    return cfg, st.create_train_state(model, cfg, st.TorchDraws(seed + 1, cuda), use_ema=True)


def _latents(cuda, n, seed=3):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    latents = torch.randn((n, 32, 32, 4), device=cuda, generator=gen)
    labels = torch.randint(0, 1000, (n,), device=cuda, generator=gen)
    return latents.cpu().numpy(), labels.cpu().numpy().astype(np.int32)


def _run_epoch(state, cfg, fn, loader, data, scan):
    from distillation_trajectories_torch.training.loop import run_train_epoch

    state, losses, n = run_train_epoch(
        state, train_step=None if scan else fn, loader=loader, config=cfg, device="cuda",
        progress_desc="", log_label="", log_every=0, use_scan=scan, epoch_fn=fn,
        dataset_dev=data, reduce_loss=False, labels=True)
    torch.cuda.synchronize()
    return state, losses


def test_dit_xl2_step_counts_57_backward_launches_through_the_replays(cuda):
    """DiT-XL/2 (bf16 autocast, batch 8 of 32x32x4) on the epoch lane, 6
    steps (2 eager, the capture, 4 replays): every step, eager or replayed,
    counts one ``ln_modulate`` and 56 ``gate_add_ln_modulate`` launches
    forward and as many backward (57 a step), the capture none; the losses
    are finite."""
    from distillation_trajectories_torch.data.datasets import DataLoader
    from distillation_trajectories_torch.diffusion.vlb import dit_schedule
    from distillation_trajectories_torch.ops import adaln
    from distillation_trajectories_torch.training import loop, state as st

    cfg, state = _dit_state(cuda, "DiT-XL/2", 0, 8)
    latents, labels = _latents(cuda, 48)
    loader = DataLoader(latents, labels, 8, seed=5)
    fn = st.make_dit_teacher_epoch_fn(dit_schedule(1000, 1e-4, 0.02), 1000, ema_rate=0.9999)
    data = loop.upload_dataset(loader, cuda, labels=True)
    counted = (adaln.ln_modulate, adaln.gate_add_ln_modulate, adaln.ln_modulate_backward,
               adaln.gate_add_ln_modulate_backward)
    before = [c.launches for c in counted]
    state, losses = _run_epoch(state, cfg, fn, loader, data, scan=True)
    made = [c.launches - b for c, b in zip(counted, before)]
    assert fn.captured[0].graph is not None and len(losses) == 6
    assert made == [6, 6 * 56, 6, 6 * 56], made
    assert np.isfinite(losses).all()


def _change_gaps(initial, got, want):
    """Each leaf's change since ``initial`` in ``got`` against its change
    in ``want``: ``|Δgot - Δwant| / |Δwant|``, leaving out the key bias (the
    middle third of ``qkv.bias``), which shifts each query's scores by a
    constant that the softmax takes out, so that Adam moves it by ±lr on
    rounding alone."""
    gaps = {}
    with torch.no_grad():
        for name, w0 in initial.items():
            d_got, d_want = got[name] - w0, want[name] - w0
            if name.endswith("attn.qkv.bias"):
                d = w0.shape[0] // 3
                d_got, d_want = (torch.cat([v[:d], v[2 * d:]]) for v in (d_got, d_want))
            gaps[name] = float((d_got - d_want).norm() / d_want.norm())
    return gaps


# A leaf's change after 6 steps, captured against eager: equal on the H100
# (read 0 for every leaf, captured against eager twice, captured against
# captured and eager against eager), where a fault reads 0.82 or more (the
# variational bound dropped 0.82, half the batch 0.94, every class dropped
# 1.28).  The bound leaves room for sums in another order (float32
# rounding, ~1e-7), not for Adam's ±lr on a gradient element of another
# sign (one such element in a 384-wide bias reads 0.1).
CHANGE_REL = 1e-3


def _dit_s2_lane(cuda, lane):
    """DiT-S/2 (bf16 autocast, batch 8) for 6 steps from seed 7 on the
    captured epoch lane (``"graph"``) or in the per-batch loop
    (``"loop"``): ``(initial weights, losses, state)``."""
    from distillation_trajectories_torch.data.datasets import DataLoader
    from distillation_trajectories_torch.diffusion.vlb import dit_schedule
    from distillation_trajectories_torch.training import loop, state as st

    latents, labels = _latents(cuda, 48)
    cfg, state = _dit_state(cuda, "DiT-S/2", 7, 8)
    initial = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    loader = DataLoader(latents, labels, 8, seed=5)
    make = st.make_dit_teacher_epoch_fn if lane == "graph" else st.make_dit_teacher_train_step
    fn = make(dit_schedule(1000, 1e-4, 0.02), 1000, ema_rate=0.9999)
    data = loop.upload_dataset(loader, cuda, labels=True) if lane == "graph" else None
    state, losses = _run_epoch(state, cfg, fn, loader, data, scan=lane == "graph")
    return initial, np.asarray(losses), state


def test_captured_dit_s2_epoch_equals_its_eager_steps(cuda):
    """DiT-S/2 (bf16 autocast, batch 8) for 6 steps on the captured epoch
    lane and in the per-batch loop from one seed: the draw generators end
    in the same state, each loss agrees to 1e-3 relative and each leaf's
    change since the start to ``CHANGE_REL`` of the eager lane's change
    (:func:`_change_gaps`)."""
    initial, g_losses, g = _dit_s2_lane(cuda, "graph")
    _, l_losses, l_ = _dit_s2_lane(cuda, "loop")
    assert torch.equal(g.draws.generator.get_state(), l_.draws.generator.get_state())
    np.testing.assert_allclose(g_losses, l_losses, rtol=1e-3)
    gaps = _change_gaps(initial, dict(g.model.named_parameters()),
                        dict(l_.model.named_parameters()))
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    print(f"DiT-S/2 captured vs eager: losses {g_losses} vs {l_losses}; widest leaf "
          f"changes apart {worst}")
    assert max(gaps.values()) <= CHANGE_REL, worst
