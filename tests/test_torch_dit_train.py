"""DiT teacher training in the port on the CPU, against the plain reference
``h100_bench/reference/dit_train.py``: a small DiT (depth 2, width 64, 4
heads, 8x8x4 latents, batch 4, T = 1000, seeded weights, every adaLN and
final weight nonzero), float32 on both sides:

* the loss, ε-MSE plus the variational bound, with ``t`` forced to 0 in one
  sample (the decoder term) and above 0 in the others;
* the step's draws (``t``, ``ε``, the class dropout's uniforms) and the
  classes they drop;
* every leaf's gradient, and the bound's gradient reaching only the
  variance half of the output;
* two Adam steps and the EMA;
* the epoch lane (labels gathered beside the latents) against the
  per-batch loop;
* ``train_teacher`` end to end on a tiny DiT;
* the adaLN passes' backward: the kernels' plain versions and the
  wrappers under autograd against autograd of the ``*_reference``
  compositions.

Tolerances, float32 against float32: the port's fused CPU attention and
the reference's written-out softmax sum in other orders (2.6e-7 of a
forward's scale, ``test_torch_dit.py``), which the backward and Adam carry
into the gradients and the weights; each bound below states its reading.
"""

import os

import numpy as np
import pytest
import torch

from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.data.datasets import DataLoader
from distillation_trajectories_torch.diffusion.vlb import dit_schedule, hybrid_terms
from distillation_trajectories_torch.models.dit import DiT
from distillation_trajectories_torch.ops import adaln
from distillation_trajectories_torch.training import loop, state as S
from distillation_trajectories_torch.utils.profiling import recording
from h100_bench.reference import dit as R
from h100_bench.reference import dit_train as RT
from torch_parity import tmp_path  # noqa: F401  (each test's outputs removed when it ends)

torch.set_num_threads(2)
SIZES = dict(depth=2, hidden_size=64, num_heads=4)
B, T, LR = 4, 1000, 1e-4
S_REF = R.sizes(2, 64, 4, input_size=8)


def _model(seed=5):
    model = DiT(input_size=8, in_channels=4, variant="tiny", **SIZES)
    missing, unexpected = model.load_state_dict(R.make_weights(S_REF, seed, "cpu"), strict=False)
    assert missing == ["pos_embed"] and not unexpected
    return model


def _batch(seed=0, n=B):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, 8, 8, 4), generator=gen), torch.randint(0, 1000, (n,), generator=gen)


def _state(model, seed=11, ema=False):
    cfg = Config(device="cpu", lr=LR, architecture="dit", base_dir="/nonexistent-unused")
    return S.create_train_state(model, cfg, S.TorchDraws(seed, "cpu"), use_ema=ema)


def _cfg(tmp_path, **kw):
    return Config(base_dir=str(tmp_path), device="cpu", architecture="dit", lr=LR,
                  dataset="imagenet256_latents", image_size=8, channels=4, timesteps=T,
                  batch_size=B, compute_dtype="float32", **kw)


TABLES = dit_schedule(T, 1e-4, 0.02)
TAB = {k: torch.from_numpy(v) for k, v in TABLES.items()}
REF_TAB = {k: torch.from_numpy(v) for k, v in RT.schedule(T, 1e-4, 0.02).items()}


def test_schedule_tables_are_ddpms_in_float64():
    """The port's tables equal the reference's; the clipped posterior
    log-variance repeats β̃_1 at t = 0; both are float64 arithmetic cast to
    float32 (the float32 cumulative product differs at late t)."""
    names = {"sqrt_alphas_cumprod": "sqrt_ac", "sqrt_one_minus_alphas_cumprod": "sqrt_omac",
             "sqrt_recip_alphas_cumprod": "sqrt_recip_ac",
             "sqrt_recipm1_alphas_cumprod": "sqrt_recipm1_ac", "posterior_mean_coef1": "coef1",
             "posterior_mean_coef2": "coef2", "posterior_log_variance_clipped": "log_var_clipped",
             "log_betas": "log_betas"}
    for port, ref in names.items():
        assert torch.equal(TAB[port], REF_TAB[ref]), port
    assert TAB["posterior_log_variance_clipped"][0] == TAB["posterior_log_variance_clipped"][1]
    ac32 = np.cumprod(1 - np.linspace(1e-4, 0.02, T, dtype=np.float32), dtype=np.float32)
    assert not np.array_equal(np.sqrt(ac32), TABLES["sqrt_alphas_cumprod"])


def _forced_draws(latents, t):
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn(latents.shape, generator=gen)
    u = torch.tensor([0.05, 0.5, 0.95, 0.3])  # the first sample's class dropped
    return S.StepDraws(t, (noise,), None, drop=u)


@pytest.mark.parametrize("t", [[0, 1, 500, 999], [3, 0, 999, 250]], ids=["t0-first", "t0-second"])
def test_loss_matches_the_reference_with_the_decoder_term(t):
    """The step's loss (through the train step's body) against the
    reference's, with ``t = 0`` in one sample: 1e-6 relative (readings 0);
    each term per sample at 1e-5, and the t = 0 sample's bound is
    the decoder's negative log-likelihood, the others' the KL."""
    model = _model()
    latents, labels = _batch()
    t = torch.tensor(t)
    draws = _forced_draws(latents, t)
    st = _state(model)
    body = S._dit_teacher_body(TABLES, T, None)
    with recording() as rec:
        loss = float(body(st, (latents, labels), draws))
    assert [sp.attrs for sp in rec.spans if sp.name == "dit.loss"] == [
        {"terms": "mse+vb", "batch": B}]
    forwards = [sp.attrs for sp in rec.spans if sp.name == "dit.forward"]
    assert len(forwards) == 1 and forwards[0]["grad"] is True
    w = R.make_weights(S_REF, 5, "cpu")
    y = RT.drop_classes(labels, draws.drop, 1000)
    assert y[0] == 1000 and torch.equal(y[1:], labels[1:])
    x_t = REF_TAB["sqrt_ac"][t].view(-1, 1, 1, 1) * latents \
        + REF_TAB["sqrt_omac"][t].view(-1, 1, 1, 1) * draws.noises[0]
    pos = R.pos_embed(64, 4)
    with torch.no_grad():
        out = RT.forward(w, x_t, t, y, S_REF, pos)
        mse, vb = RT.loss_terms(out, latents, x_t, t, draws.noises[0], REF_TAB)
        p_mse, p_vb = hybrid_terms(out, latents, x_t, t, draws.noises[0], TAB)
    torch.testing.assert_close(p_mse, mse, rtol=1e-5, atol=0)
    torch.testing.assert_close(p_vb, vb, rtol=1e-5, atol=0)
    zero = int((t == 0).nonzero())
    nll = -RT._log_likelihood(latents, *(a for a in _model_mean_logscale(out, latents, x_t, t))
                              ).mean(dim=(1, 2, 3)) / np.log(2.0)
    torch.testing.assert_close(vb[zero], nll[zero], rtol=1e-6, atol=0)
    assert abs(vb[zero] - nll[zero]) < abs(vb[zero]) and not torch.allclose(vb, nll)
    assert loss == pytest.approx(float((mse + vb).mean()), rel=1e-6)


def _model_mean_logscale(out, x0, x_t, t):
    at = lambda k: REF_TAB[k][t].view(-1, 1, 1, 1)
    eps, v = out[..., :4], out[..., 4:]
    frac = (v + 1) / 2
    logvar = frac * at("log_betas") + (1 - frac) * at("log_var_clipped")
    x0_hat = at("sqrt_recip_ac") * x_t - at("sqrt_recipm1_ac") * eps
    return at("coef1") * x0_hat + at("coef2") * x_t, 0.5 * logvar


def test_draws_and_class_dropout_follow_the_documented_stream():
    """``TorchDraws.dit_teacher_step`` draws ``t``, ``ε`` and the dropout's
    uniforms in that order from its generator, as the reference works them
    out; a tenth of the classes fall to the null class, as DiT's
    ``token_drop``."""
    latents, labels = _batch(n=4096)
    d = S.TorchDraws(77, "cpu").dit_teacher_step(latents, T)
    t, noise, u = RT.step_draws(torch.Generator().manual_seed(77), 4096, (8, 8, 4), T, "cpu")
    assert torch.equal(d.t, t) and torch.equal(d.noises[0], noise) and torch.equal(d.drop, u)
    model = _model()
    y = model.drop_classes(labels, d.drop)
    assert torch.equal(y, RT.drop_classes(labels, u, 1000))
    dropped = (y == 1000).float().mean()
    assert 0.08 < dropped < 0.12 and torch.equal(y[y != 1000], labels[y != 1000])
    assert model.class_dropout_prob == RT.CLASS_DROPOUT_PROB == 0.1


def _ref_steps(seed=11, ema_rate=None, block=None):
    return RT.DiTTeacherSteps(R.make_weights(S_REF, 5, "cpu"), S_REF, RT.schedule(T, 1e-4, 0.02),
                              T, LR, torch.Generator().manual_seed(seed), block=block,
                              ema_rate=ema_rate)


@pytest.mark.parametrize("block", [None, 3], ids=["whole", "blocks-of-3"])
def test_gradients_match_the_reference_on_every_leaf(block):
    """The first step's gradient of every leaf against the reference's
    autograd (whole batch, or in blocks of samples summed, as on the card):
    within 1e-4 of each leaf's norm (readings up to 3.4e-7)."""
    model = _model()
    latents, labels = _batch()
    st = _state(model)
    S.make_dit_teacher_train_step(TABLES, T)(st, (latents, labels))
    ref = _ref_steps(block=block)
    ref.step(latents, labels)
    for name, p in model.named_parameters():
        g, want = p.grad, ref.first_grads[name]
        assert float((g - want).norm()) <= 1e-4 * float(want.norm()) + 1e-12, name
    assert all(float(g.norm()) > 0 for g in ref.first_grads.values())


def test_the_bound_reaches_only_the_variance_half():
    """``vb``'s gradient with respect to the output is zero on the noise
    half and nonzero on the variance half; ``mse``'s is the reverse."""
    latents, _ = _batch()
    t = torch.tensor([0, 4, 300, 999])
    noise = torch.randn(latents.shape, generator=torch.Generator().manual_seed(2))
    x_t = TAB["sqrt_alphas_cumprod"][t].view(-1, 1, 1, 1) * latents \
        + TAB["sqrt_one_minus_alphas_cumprod"][t].view(-1, 1, 1, 1) * noise
    out = torch.randn((B, 8, 8, 8), generator=torch.Generator().manual_seed(4)).requires_grad_()
    mse, vb = hybrid_terms(out, latents, x_t, t, noise, TAB)
    g_vb, = torch.autograd.grad(vb.sum(), out)
    g_mse, = torch.autograd.grad(mse.sum(), out)
    assert torch.count_nonzero(g_vb[..., :4]) == 0 and torch.count_nonzero(g_vb[..., 4:]) > 0
    assert torch.count_nonzero(g_mse[..., 4:]) == 0 and torch.count_nonzero(g_mse[..., :4]) > 0


def _moving(name, p):
    """The elements of a leaf whose gradient is not rounding alone: all but
    the key bias (the middle third of ``qkv.bias``), which shifts each
    query's scores by a constant that the softmax takes out, so that Adam
    moves it by ±lr on noise."""
    keep = torch.ones_like(p, dtype=torch.bool)
    if name.endswith("attn.qkv.bias"):
        d = p.shape[0] // 3
        keep[d: 2 * d] = False
    return keep


def test_two_adam_steps_and_the_ema_match_the_reference():
    """Two steps with the EMA at DiT's 0.9999: each loss at 1e-6, each
    weight's change since the start and each EMA leaf's change within 1e-3
    of the reference's change (Adam's first steps move each weight by about
    ±lr whatever its gradient's size, so a gradient of rounding alone would
    read 1, as the key bias's does: it is left out; readings up to 7.1e-5)."""
    model = _model()
    w0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    st = _state(model, ema=True)
    step = S.make_dit_teacher_train_step(TABLES, T, ema_rate=0.9999)
    ref = _ref_steps(ema_rate=0.9999)
    for i in range(2):
        latents, labels = _batch(seed=i)
        st, loss = step(st, (latents, labels))
        assert float(loss) == pytest.approx(ref.step(latents, labels), rel=1e-6)
    assert st.step == 2
    for name, p in model.named_parameters():
        for got, want in ((p.detach(), ref.params[name].detach()), (st.ema[name], ref.ema[name])):
            keep = _moving(name, want)
            change = (want - w0[name])[keep].norm()
            assert float((got - want)[keep].norm()) <= 1e-3 * float(change), name
        assert not torch.equal(st.ema[name], w0[name]) and not torch.equal(st.ema[name], p)


def test_epoch_lane_equals_the_per_batch_loop(tmp_path):
    """Two epochs of 3 batches on 12 latents through ``run_train_epoch``,
    the epoch lane (latents and labels uploaded, gathered by each row)
    against the per-batch loop: equal losses, weights and EMA, bit for bit
    (both run the same operations on the CPU)."""
    latents, labels = _batch(seed=9, n=12)
    cfg = _cfg(tmp_path)
    out = {}
    for lane in ("scan", "loop"):
        model = _model()
        st = _state(model, ema=True)
        epoch = S.make_dit_teacher_epoch_fn(TABLES, T, ema_rate=0.9999)
        step = S.make_dit_teacher_train_step(TABLES, T, ema_rate=0.9999)
        loader = DataLoader(latents.numpy(), labels.numpy().astype(np.int32), B, seed=4)
        data = loop.upload_dataset(loader, "cpu", labels=True)
        assert isinstance(data, tuple)
        assert data[1].dtype == torch.int64 and torch.equal(data[1], labels)
        losses = []
        for _ in range(2):
            st, ls, n = loop.run_train_epoch(
                st, train_step=step if lane == "loop" else None, loader=loader, config=cfg,
                device="cpu", progress_desc="", log_label="", log_every=0,
                use_scan=lane == "scan", epoch_fn=epoch, dataset_dev=data, reduce_loss=False,
                labels=True)
            assert n == 3
            losses.append(ls)
        out[lane] = (np.concatenate(losses), dict(model.named_parameters()), st.ema, st.step)
    (l1, p1, e1, s1), (l2, p2, e2, s2) = out["scan"], out["loop"]
    assert s1 == s2 == 6 and np.array_equal(l1, l2)
    assert all(torch.equal(p1[k], p2[k]) and torch.equal(e1[k], e2[k]) for k in p1)


def test_upload_dataset_leaves_the_unet_lane_as_it_was():
    """Without labels the device dataset is the image tensor alone, as the
    U-Net's epoch lanes gather it."""
    loader = DataLoader(np.zeros((8, 4, 4, 1), np.float32), np.arange(8), 4)
    data = loop.upload_dataset(loader, "cpu")
    assert isinstance(data, torch.Tensor) and data.shape == (8, 4, 4, 1)


class _TinyDraws(S.TorchDraws):
    def init_model(self, config):
        assert config.architecture == "dit"
        return _model(seed=self.seed)


def test_train_teacher_trains_a_tiny_dit(tmp_path):
    """``train_teacher`` with ``architecture="dit"``: stand-in latents and
    labels on the epoch lane, DiT's loss, the EMA, DiT's checkpoint payload
    and a sample grid of the seed's classes."""
    cfg = _cfg(tmp_path, epochs=2, limit_batches_per_epoch=3, num_samples_to_generate=4,
               sample_steps=4, use_ema=True, ema_rate=0.9999)
    from distillation_trajectories_torch.training.teacher import train_teacher

    st = train_teacher(cfg, seed=3, draws=_TinyDraws)
    assert st.step == 6 and isinstance(st.model, DiT) and st.ema is not None
    path = os.path.join(cfg.teacher_models_dir, "model_epoch_2.pt")
    payload = torch.load(path, weights_only=False)
    assert set(payload) == {"epoch", "model", "ema", "opt"} and payload["epoch"] == 2
    assert all(torch.equal(payload["model"][k], v) for k, v in st.model.state_dict().items())
    assert os.path.getsize(os.path.join(cfg.results_dir, "samples_epoch_2.png")) > 1000
    from distillation_trajectories_torch.training.checkpoints import available_epochs

    assert available_epochs(cfg.teacher_models_dir) == [1, 2]


# --- The adaLN passes' backward ----------------------------------------------


def _operands(low, seed=7, b=3, n=10, d=48):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, n, d), generator=gen) * 2
    y = torch.randn((b, n, d), generator=gen).to(low)
    gate, shift, scale = torch.randn((b, 6 * d), generator=gen).to(low).chunk(6, dim=1)[:3]
    dh = torch.randn((b, n, d), generator=gen).to(low)
    dxs = torch.randn((b, n, d), generator=gen)
    return x, y, gate, shift, scale, dh, dxs


CASES = [(low, pass_) for low in (torch.float32, torch.bfloat16)
         for pass_ in ("ln", "gated", "gated_no_dxs")]


@pytest.mark.parametrize("low, pass_", CASES,
                         ids=[f"{str(lo).split('.')[-1]}-{p}" for lo, p in CASES])
def test_adaln_backward_matches_autograd_of_the_reference(low, pass_):
    """The backward kernels' plain versions and the wrappers under autograd
    (on the CPU, the reference composition recorded) against autograd of
    the ``*_reference`` functions, ``h`` cast to the branch dtype as the
    next ``Linear`` reads it: every gradient in its operand's dtype; float32
    ones within 1e-6 of their scale (LayerNorm's backward sums in another
    order), bf16 ones equal (the roundings are autograd's).  The wrappers
    leave ``x`` unwritten under autograd."""
    x, y, gate, shift, scale, dh, dxs = _operands(low)
    if pass_ == "gated_no_dxs":
        dxs = None
    leaves = [a.clone().requires_grad_() for a in ((x, shift, scale) if pass_ == "ln"
                                                   else (x, y, gate, shift, scale))]
    if pass_ == "ln":
        outs, grads_out = [adaln.ln_modulate_reference(*leaves).to(low)], [dh]
        mine = adaln.ln_modulate_backward_reference(x, shift, scale, dh)
        wrapped = [adaln.ln_modulate(*[a.clone().requires_grad_() for a in (x, shift, scale)])]
    else:
        xs, h = adaln.gate_add_ln_modulate_reference(*leaves)
        outs, grads_out = ([h.to(low), xs], [dh, dxs]) if dxs is not None else ([h.to(low)], [dh])
        mine = adaln.gate_add_ln_modulate_backward_reference(
            xs.detach(), y, gate, shift, scale, dh, dxs)
    want = torch.autograd.grad(outs, leaves, grads_out)
    for got, ref in zip(mine, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if ref.dtype == torch.float32:
            assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
        else:
            assert torch.equal(got, ref)
    if pass_ != "ln":
        x_in = x.clone()
        wl = [x_in.requires_grad_()] + [a.clone().requires_grad_() for a in (y, gate, shift,
                                                                           scale)]
        xs2, h2 = adaln.gate_add_ln_modulate(*wl)
        assert xs2 is not x_in and torch.equal(x_in.detach(), x)
        wrapped = [h2]
        outs2 = [h2.to(low)] + ([xs2] if dxs is not None else [])
        got = torch.autograd.grad(outs2, wl, grads_out)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(w.requires_grad for w in wrapped)
