"""Port parity: the int8 sampler lane (``models/quantized.py``).

The fold-only float twin pins the re-implemented forward and the BatchNorm
fold against the port's plain forward (1e-4, as ``test_quantized.py`` holds
JAX's).  The int8 pieces are then held to JAX's on the same weights:

- ``_qconv`` bit for bit on equal int8 operands and scales (int32
  accumulation is exact; the dequantization is the same two float32 ops),
  with and without the zero padding ``torch._int_mm`` needs on CUDA;
- the weight codes equal and the scales and folded biases within 1e-6
  relative (the fold's ``rsqrt`` rounds apart by an ulp in XLA and torch);
- whole forwards (dynamic, static and mixed) within a relative L2 of 1e-4,
  and a T=6 CFG chain with JAX's step noise within 1e-3: an ulp of
  difference upstream can move an activation across a rounding tie and
  flip one int8 code, so bitwise equality is not owed there.  Both bounds
  are far tighter than int8's own error against float (0.15,
  ``test_quantized.py:90``), which is checked too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.diffusion import get_diffusion_params as jax_params
from distillation_trajectories_tpu.diffusion.sampling import (
    generate_trajectory_scan as jax_scan,
)
from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_tpu.models import quantized as jq
from distillation_trajectories_tpu.training.progressive import (
    make_guided_eval_fn as jax_guided,
)
from distillation_trajectories_torch.diffusion import get_diffusion_params
from distillation_trajectories_torch.diffusion.sampling import (
    CFG_COND_PAIRS,
    draw_step_noise,
    generate_trajectory_scan,
)
from distillation_trajectories_torch.models import quantized as tq
from distillation_trajectories_torch.training.progressive import make_guided_eval_fn
from distillation_trajectories_torch.trajectories import (
    generate_trajectory,
    make_sweep_trajectory_fn,
)
from torch_parity import as_torch, configs, jax_step_noise, numpy_tree, port_model

torch.set_num_threads(2)
T = 6


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))


_SETUPS = {}


def _setup(full_res_head=False):
    """(JAX model, variables with non-trivial BN statistics, port model in
    eval mode, port Config), once per head."""
    if full_res_head not in _SETUPS:
        jcfg, tcfg = configs(timesteps=T, full_res_head=full_res_head)
        jmodel = jax_make_unet(jcfg, size_factor=0.1)
        variables = numpy_tree(jax_init_unet(jmodel, jcfg, jax.random.PRNGKey(0)))
        rng = np.random.RandomState(1)
        for blk in variables["batch_stats"].values():  # init's mean 0 / var 1 would hide a bad fold
            for nrm in blk.values():
                nrm["mean"] = rng.normal(0.0, 0.3, nrm["mean"].shape).astype(np.float32)
                nrm["var"] = (0.5 + rng.rand(*nrm["var"].shape)).astype(np.float32)
        _SETUPS[full_res_head] = (jmodel, variables, port_model(tcfg, 0.1, variables).eval(), tcfg)
    return _SETUPS[full_res_head]


def _inputs(b=2, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 16, 16, 1)).astype(np.float32)
    t = np.array([1.0, 4.0], np.float32)[:b]
    cond = rng.uniform(size=(b, 1)).astype(np.float32)
    return x, t, cond, np.ones((b, 1), np.float32)


def _torch(*arrays):
    return [as_torch(a) for a in arrays]


@pytest.mark.parametrize("full_res_head", [False, True])
def test_fold_only_twin_matches_plain_forward(full_res_head):
    _, _, model, _ = _setup(full_res_head)
    x, t, cond, mask = _torch(*_inputs())
    qvars = tq.quantize_unet_variables(model, nbits=None)
    with torch.no_grad():
        for c, m in ((cond, mask), (None, None)):  # cond=None: mask-0 semantics
            want = model(x, t, c, m)
            got = tq.quantized_unet_apply(model, qvars, x, t, c, m)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b, hw, cin, cout, ksize", [
    (2, 16, 3, 16, 3),   # enc1's K = 27: K padded, M = 512 and N = 16 are not
    (1, 2, 32, 32, 3),   # a batch-1 bottleneck: M = 4 rows, padded to 32
    (1, 2, 48, 20, 1),   # 1x1 residual: M and N padded
    (1, 7, 16, 16, 3),   # M = 49: padded to 56, a multiple of 8
    (3, 4, 16, 24, 3),   # M = 48, K = 144, N = 24: no padding
])
def test_qconv_matches_jax_bit_for_bit(b, hw, cin, cout, ksize):
    rng = np.random.default_rng(b * 100 + cin)
    xq = rng.integers(-127, 128, (b, hw, hw, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (ksize, ksize, cin, cout)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    s_x = np.float32(rng.uniform(0.01, 0.1))
    pad = ksize // 2
    want = np.asarray(jq._qconv({"w_int8": wq, "scale": scale, "bias": bias}, jnp.asarray(xq),
                                jnp.asarray(s_x), ((pad, pad), (pad, pad))))
    q = {"w_int8": torch.from_numpy(wq), "scale": torch.from_numpy(scale),
         "bias": torch.from_numpy(bias)}
    got = tq._qconv(q, torch.from_numpy(xq), torch.tensor(s_x), pad).numpy()
    np.testing.assert_array_equal(got, want)
    # The padded product equals the exact int32 product of the patches.
    a = tq._im2col(torch.from_numpy(xq), ksize, ksize, pad)
    bmat = torch.from_numpy(wq).reshape(-1, cout)
    exact = a.to(torch.int64) @ bmat.to(torch.int64)
    got_acc = tq.int8_matmul(a, bmat)
    assert got_acc.dtype == torch.int32 and torch.equal(got_acc.to(torch.int64), exact)
    assert torch.equal(tq.int8_matmul(a, bmat.t().contiguous().t()), got_acc)  # column-major b


def test_int8_weight_codes_and_scales_match_jax():
    jmodel, variables, model, _ = _setup()
    want = jax.device_get(jq.quantize_unet_variables(jmodel, variables))["blocks"]
    got = tq.quantize_unet_variables(model)["blocks"]
    assert set(got) == set(want)
    for name, blk in want.items():
        assert set(got[name]) == set(blk), name
        for conv in ("conv1", "conv2", "residual"):
            if conv not in blk:
                continue
            g, w = got[name][conv], blk[conv]
            assert g["w_int8"].dtype == torch.int8 and g["scale"].dtype == torch.float32
            np.testing.assert_array_equal(g["w_int8"].numpy(), w["w_int8"], err_msg=f"{name} {conv}")
            k_n = g["w_int8"].reshape(-1, g["w_int8"].shape[-1])
            assert k_n.t().is_contiguous() and k_n.data_ptr() == g["w_int8"].data_ptr()
            np.testing.assert_allclose(g["scale"].numpy(), w["scale"], rtol=1e-6)
            np.testing.assert_allclose(g["bias"].numpy(), w["bias"], rtol=1e-6, atol=1e-7)
    assert "residual" in got["enc2"] and "residual" not in got["enc4"]


def test_int8_forward_matches_jax_and_stays_near_float():
    jmodel, variables, model, _ = _setup()
    x, t, cond, mask = _inputs()
    want = np.asarray(jq.make_quantized_eval_fn(jmodel, variables)(x, t, cond, mask))
    got = tq.make_quantized_eval_fn(model)(*_torch(x, t, cond, mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) < 1e-4
    float_out = np.asarray(jmodel.apply(variables, x, t, cond=cond, cond_mask=mask, train=False))
    assert 1e-3 < _rel(got, float_out) < 0.15  # quantized, and within int8's own bound


def _calibration_set(n=3):
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((n, 2, 16, 16, 1)).astype(np.float32)
    ts = np.stack([np.array([1.0, 4.0], np.float32) + i for i in range(n)])
    return xs, ts, np.ones((n, 2, 1), np.float32), np.ones((n, 2, 1), np.float32)


def test_static_scales_and_mixed_blocks_match_jax():
    jmodel, variables, model, _ = _setup()
    calib = _calibration_set()
    want = jq.calibrate_activation_scales(jmodel, variables, *calib)
    got = tq.calibrate_activation_scales(model, *_torch(*calib))
    assert set(got) == set(want) == {"enc1", "enc2", "enc3", "enc4", "bottleneck",
                                     "dec3", "dec2", "dec1"}
    for name, sites in want.items():
        assert set(got[name]) == {"in", "mid"}
        for site, s in sites.items():
            assert isinstance(got[name][site], float)
            np.testing.assert_allclose(got[name][site], s, rtol=1e-6, err_msg=f"{name}:{site}")
    x, t, cond, mask = _inputs()
    keep = {"enc1", "enc2", "dec2", "dec1"}
    for kw in (dict(act_scales=want), dict(quant_blocks=keep),
               dict(act_scales=want, quant_blocks=keep)):
        ref = np.asarray(jq.make_quantized_eval_fn(jmodel, variables, **kw)(x, t, cond, mask))
        tkw = dict(kw, act_scales=got) if "act_scales" in kw else kw
        out = tq.make_quantized_eval_fn(model, **tkw)(*_torch(x, t, cond, mask))
        assert _rel(out, ref) < 1e-4, sorted(kw)
    qvars = tq.quantize_unet_variables(model, quant_blocks=keep)
    for name, blk in qvars["blocks"].items():
        assert ("w_int8" if name in keep else "w") in blk["conv1"], name


def test_group_norm_raises():
    _, tcfg = configs(norm="group")
    from distillation_trajectories_torch.models import make_unet

    with pytest.raises(ValueError, match="norm='batch'"):
        tq.quantize_unet_variables(make_unet(tcfg, size_factor=0.1, device="cpu"))


def test_guided_eval_fn_int8_matches_jax():
    jmodel, variables, model, _ = _setup()
    x, t, _, _ = _inputs()
    want = np.asarray(jax_guided(jmodel, variables, 3.0, quant="int8")(x, t, None, None))
    got = make_guided_eval_fn(model, 3.0, quant="int8")(*_torch(x, t), None, None)
    assert _rel(got, want) < 1e-4
    keep = {"enc1", "dec1"}
    want = np.asarray(jax_guided(jmodel, variables, 3.0, quant="int8", quant_blocks=keep)(
        x, t, None, None))
    got = make_guided_eval_fn(model, 3.0, quant="int8", quant_blocks=keep)(*_torch(x, t), None, None)
    assert _rel(got, want) < 1e-4


def test_int8_chain_matches_jax_with_its_step_noise():
    jmodel, variables, model, tcfg = _setup()
    noise = np.random.default_rng(7).standard_normal((2, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, n: jax_scan(
        jq.make_quantized_eval_fn(jmodel, v), n, T, jax_params(T)["alphas"], 5,
        guidance_scale=3.0))(variables, noise))
    step_noise = as_torch(jax_step_noise([5], T, noise.shape)[:, 0])
    qcfg = dataclasses.replace(tcfg, sampler_quant="int8")
    got = generate_trajectory(model, as_torch(noise), T, seed=5, guidance_scale=3.0,
                              config=qcfg, step_noise=step_noise)
    assert tuple(got.shape) == want.shape == (T + 1, 2, 16, 16, 1)
    np.testing.assert_array_equal(got[0].numpy(), noise)
    assert _rel(got[-1], want[-1]) < 1e-3
    plain = generate_trajectory(model, as_torch(noise), T, seed=5, guidance_scale=3.0,
                                config=tcfg, step_noise=step_noise)
    assert 0 < _rel(got[-1], plain[-1]) < 0.5  # int8 drift against the float chain


def test_sampler_quant_int8_runs_through_the_sweep():
    from distillation_trajectories_torch.training import make_eval_fn_from_config

    _, _, model, tcfg = _setup()
    qcfg = dataclasses.replace(tcfg, sampler_quant="int8")
    with pytest.raises(ValueError, match="cannot combine"):
        make_eval_fn_from_config(model, dataclasses.replace(qcfg, spatial_shape=(1, 2)))
    seeds = np.array([0, 1])
    noises = torch.randn((2, 16, 16, 1), generator=torch.Generator().manual_seed(9))
    trajs = make_sweep_trajectory_fn(model, T, qcfg)(noises, seeds, CFG_COND_PAIRS, 3.0)
    assert tuple(trajs.shape) == (2, T + 1, 16, 16, 1) and torch.isfinite(trajs).all()
    # The sweep is the batch int8 chain (dynamic scales are per tensor, so
    # the batch, not a sample alone) on the sweep's (seed, t) draws.
    chain = generate_trajectory_scan(
        tq.make_quantized_eval_fn(model), noises, T, get_diffusion_params(T)["alphas"], seed=0,
        guidance_scale=3.0, step_noise=draw_step_noise(seeds, T, (16, 16, 1), "cpu"))
    assert torch.equal(trajs, chain.transpose(0, 1))
