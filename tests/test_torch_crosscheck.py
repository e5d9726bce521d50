"""Cross-framework value parity for the Inception-FID and LPIPS ports.

The reference defines FID on torchvision ``inception_v3`` activations
(``/root/reference/analysis/metrics/fid_score.py:19-59``) and LPIPS on the
lpips-package AlexNet features (``/root/reference/evaluation/metrics.py:14-49``).
No egress means no pretrained weights in this environment, but torch IS
installed — so these tests push the same synthetic weights through
independent torch-functional reimplementations of each trunk stage and
assert the Flax forwards match to float32 tolerance.  That proves the
port's NUMERICS (conv layout/orientation, BN eps, pooling semantics,
asymmetric padding, branch concat order), so real weights produce
reference-parity FID/LPIPS the day they appear.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax  # noqa: E402

from distillation_trajectories_tpu.models.inception import (  # noqa: E402
    BasicConv2d,
    InceptionA,
    InceptionC,
    InceptionE,
    InceptionV3Features,
    load_torchvision_weights,
)
from torch_parity import tmp_path  # noqa: E402, F401  (each test's outputs removed when it ends)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_nhwc).transpose(0, 3, 1, 2)))


def _nhwc(x_nchw):
    return x_nchw.detach().numpy().transpose(0, 2, 3, 1)


def _synthetic_torch_state(variables, rng):
    """Torch-convention state dict (numpy) covering a Flax inception-style
    variable tree: conv kernels OIHW, BN scale/bias/mean/var per channel."""
    flat = flax.traverse_util.flatten_dict(variables, sep="/")
    state = {}
    for key, val in flat.items():
        parts = key.split("/")
        col, leaf = parts[0], parts[-1]
        tname = ".".join(parts[1:-1])
        shape = val.shape
        if col == "params" and leaf == "kernel":
            h, w, i, o = shape
            state[f"{tname}.weight"] = rng.standard_normal(
                (o, i, h, w)
            ).astype(np.float32) * 0.1
        elif col == "params" and leaf == "scale":
            state[f"{tname}.weight"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif col == "params" and leaf == "bias":
            state[f"{tname}.bias"] = rng.standard_normal(shape).astype(np.float32) * 0.1
        elif col == "batch_stats" and leaf == "mean":
            state[f"{tname}.running_mean"] = rng.standard_normal(shape).astype(
                np.float32
            ) * 0.1
        elif col == "batch_stats" and leaf == "var":
            state[f"{tname}.running_var"] = rng.uniform(0.5, 2.0, shape).astype(
                np.float32
            )
        else:
            raise AssertionError(f"unexpected leaf {key}")
    return state


def _p(prefix, sub):
    """Join torch module-path segments, tolerating an empty prefix (a
    standalone Flax ``init`` has no enclosing module name)."""
    return f"{prefix}.{sub}" if prefix else sub


def _tbasic(state, name, x, stride=1, padding=0):
    """torch BasicConv2d: conv(bias=False) + BN(eps=1e-3, eval) + relu —
    mirrors torchvision.models.inception.BasicConv2d."""
    x = F.conv2d(
        x, torch.from_numpy(state[_p(name, "conv.weight")]),
        stride=stride, padding=padding,
    )
    x = F.batch_norm(
        x,
        torch.from_numpy(state[_p(name, "bn.running_mean")]),
        torch.from_numpy(state[_p(name, "bn.running_var")]),
        torch.from_numpy(state[_p(name, "bn.weight")]),
        torch.from_numpy(state[_p(name, "bn.bias")]),
        training=False,
        eps=1e-3,
    )
    return F.relu(x)


def _port(model, variables, state, tmp_path):
    """Round-trip the synthetic torch state through the production loader
    (npz branch) so the test also covers the OIHW→HWIO orientation."""
    path = str(tmp_path / "weights.npz")
    np.savez(path, **state)
    return load_torchvision_weights(path, variables)


def test_basic_conv2d_matches_torch(tmp_path):
    rng = np.random.default_rng(0)
    model = BasicConv2d(8, (3, 3), strides=(2, 2))
    x = rng.standard_normal((2, 17, 17, 5)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    state = _synthetic_torch_state(variables, rng)
    variables = _port(model, variables, state, tmp_path)

    ours = np.asarray(model.apply(variables, jnp.asarray(x)))
    theirs = _nhwc(_tbasic(state, "", _nchw(x), stride=2))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_pool_semantics_match_torch():
    """Flax avg_pool divides by the FULL window (count_include_pad=True),
    matching torchvision's F.avg_pool2d default in the Inception branches;
    max_pool 3x3/2 valid matches torch's no-padding max pool."""
    import flax.linen as fnn

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    ours_avg = np.asarray(
        fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                     padding=((1, 1), (1, 1)))
    )
    theirs_avg = _nhwc(F.avg_pool2d(_nchw(x), 3, stride=1, padding=1))
    np.testing.assert_allclose(ours_avg, theirs_avg, rtol=1e-6, atol=1e-6)

    ours_max = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2)))
    theirs_max = _nhwc(F.max_pool2d(_nchw(x), 3, stride=2))
    np.testing.assert_allclose(ours_max, theirs_max, rtol=1e-6, atol=1e-6)


def _torch_inception_a(state, prefix, x, pool_features):
    b1 = _tbasic(state, _p(prefix, "branch1x1"), x)
    b5 = _tbasic(state, _p(prefix, "branch5x5_1"), x)
    b5 = _tbasic(state, _p(prefix, "branch5x5_2"), b5, padding=2)
    b3 = _tbasic(state, _p(prefix, "branch3x3dbl_1"), x)
    b3 = _tbasic(state, _p(prefix, "branch3x3dbl_2"), b3, padding=1)
    b3 = _tbasic(state, _p(prefix, "branch3x3dbl_3"), b3, padding=1)
    bp = F.avg_pool2d(x, 3, stride=1, padding=1)
    bp = _tbasic(state, _p(prefix, "branch_pool"), bp)
    return torch.cat([b1, b5, b3, bp], 1)


def _torch_inception_b(state, prefix, x):
    b3 = _tbasic(state, _p(prefix, "branch3x3"), x, stride=2)
    bd = _tbasic(state, _p(prefix, "branch3x3dbl_1"), x)
    bd = _tbasic(state, _p(prefix, "branch3x3dbl_2"), bd, padding=1)
    bd = _tbasic(state, _p(prefix, "branch3x3dbl_3"), bd, stride=2)
    bp = F.max_pool2d(x, 3, stride=2)
    return torch.cat([b3, bd, bp], 1)


def _torch_inception_c(state, prefix, x):
    b1 = _tbasic(state, _p(prefix, "branch1x1"), x)
    b7 = _tbasic(state, _p(prefix, "branch7x7_1"), x)
    b7 = _tbasic(state, _p(prefix, "branch7x7_2"), b7, padding=(0, 3))
    b7 = _tbasic(state, _p(prefix, "branch7x7_3"), b7, padding=(3, 0))
    bd = _tbasic(state, _p(prefix, "branch7x7dbl_1"), x)
    bd = _tbasic(state, _p(prefix, "branch7x7dbl_2"), bd, padding=(3, 0))
    bd = _tbasic(state, _p(prefix, "branch7x7dbl_3"), bd, padding=(0, 3))
    bd = _tbasic(state, _p(prefix, "branch7x7dbl_4"), bd, padding=(3, 0))
    bd = _tbasic(state, _p(prefix, "branch7x7dbl_5"), bd, padding=(0, 3))
    bp = F.avg_pool2d(x, 3, stride=1, padding=1)
    bp = _tbasic(state, _p(prefix, "branch_pool"), bp)
    return torch.cat([b1, b7, bd, bp], 1)


def _torch_inception_d(state, prefix, x):
    b3 = _tbasic(state, _p(prefix, "branch3x3_1"), x)
    b3 = _tbasic(state, _p(prefix, "branch3x3_2"), b3, stride=2)
    b7 = _tbasic(state, _p(prefix, "branch7x7x3_1"), x)
    b7 = _tbasic(state, _p(prefix, "branch7x7x3_2"), b7, padding=(0, 3))
    b7 = _tbasic(state, _p(prefix, "branch7x7x3_3"), b7, padding=(3, 0))
    b7 = _tbasic(state, _p(prefix, "branch7x7x3_4"), b7, stride=2)
    bp = F.max_pool2d(x, 3, stride=2)
    return torch.cat([b3, b7, bp], 1)


def _torch_inception_e(state, prefix, x):
    b1 = _tbasic(state, _p(prefix, "branch1x1"), x)
    b3 = _tbasic(state, _p(prefix, "branch3x3_1"), x)
    b3 = torch.cat(
        [
            _tbasic(state, _p(prefix, "branch3x3_2a"), b3, padding=(0, 1)),
            _tbasic(state, _p(prefix, "branch3x3_2b"), b3, padding=(1, 0)),
        ],
        1,
    )
    bd = _tbasic(state, _p(prefix, "branch3x3dbl_1"), x)
    bd = _tbasic(state, _p(prefix, "branch3x3dbl_2"), bd, padding=1)
    bd = torch.cat(
        [
            _tbasic(state, _p(prefix, "branch3x3dbl_3a"), bd, padding=(0, 1)),
            _tbasic(state, _p(prefix, "branch3x3dbl_3b"), bd, padding=(1, 0)),
        ],
        1,
    )
    bp = F.avg_pool2d(x, 3, stride=1, padding=1)
    bp = _tbasic(state, _p(prefix, "branch_pool"), bp)
    return torch.cat([b1, b3, bd, bp], 1)


@pytest.mark.parametrize(
    "block,build_torch,in_ch",
    [
        (InceptionA(32), lambda s, x: _torch_inception_a(s, "", x, 32), 192),
        (InceptionC(128), lambda s, x: _torch_inception_c(s, "", x), 768),
        (InceptionE(), lambda s, x: _torch_inception_e(s, "", x), 1280),
    ],
    ids=["InceptionA", "InceptionC", "InceptionE"],
)
def test_inception_block_matches_torch(tmp_path, block, build_torch, in_ch):
    """Branch wiring, asymmetric 1×7/7×1 padding, and concat order of each
    mixed-block family match the torch semantics."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 9, 9, in_ch)).astype(np.float32) * 0.5
    variables = block.init(jax.random.PRNGKey(0), jnp.asarray(x))
    state = _synthetic_torch_state(variables, rng)
    variables = _port(block, variables, state, tmp_path)

    ours = np.asarray(block.apply(variables, jnp.asarray(x)))
    theirs = _nhwc(build_torch(state, _nchw(x)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)


def _torch_inception_trunk(state, x):
    """Full torchvision inception_v3 forward through the global average
    pool, reimplemented functionally (torchvision/models/inception.py
    _forward, eval mode, no aux head)."""
    x = _tbasic(state, "Conv2d_1a_3x3", x, stride=2)
    x = _tbasic(state, "Conv2d_2a_3x3", x)
    x = _tbasic(state, "Conv2d_2b_3x3", x, padding=1)
    x = F.max_pool2d(x, 3, stride=2)
    x = _tbasic(state, "Conv2d_3b_1x1", x)
    x = _tbasic(state, "Conv2d_4a_3x3", x)
    x = F.max_pool2d(x, 3, stride=2)
    x = _torch_inception_a(state, "Mixed_5b", x, 32)
    x = _torch_inception_a(state, "Mixed_5c", x, 64)
    x = _torch_inception_a(state, "Mixed_5d", x, 64)
    x = _torch_inception_b(state, "Mixed_6a", x)
    x = _torch_inception_c(state, "Mixed_6b", x)
    x = _torch_inception_c(state, "Mixed_6c", x)
    x = _torch_inception_c(state, "Mixed_6d", x)
    x = _torch_inception_c(state, "Mixed_6e", x)
    x = _torch_inception_d(state, "Mixed_7a", x)
    x = _torch_inception_e(state, "Mixed_7b", x)
    x = _torch_inception_e(state, "Mixed_7c", x)
    return x.mean(dim=(2, 3))


@pytest.mark.slow
def test_full_inception_trunk_matches_torch(tmp_path):
    """End-to-end trunk parity: same synthetic weights through the Flax
    extractor and the torch-functional torchvision forward agree on the
    2048-d pooled features (75×75 input keeps the CPU compile fast; every
    stage still executes)."""
    rng = np.random.default_rng(3)
    model = InceptionV3Features()
    x = rng.standard_normal((2, 75, 75, 3)).astype(np.float32) * 0.5
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3)))
    state = _synthetic_torch_state(variables, rng)
    variables = _port(model, variables, state, tmp_path)

    ours = np.asarray(model.apply(variables, jnp.asarray(x)))
    theirs = _torch_inception_trunk(state, _nchw(x)).numpy()
    assert ours.shape == theirs.shape == (2, 2048)
    np.testing.assert_allclose(ours, theirs, rtol=5e-3, atol=5e-4)


def test_bilinear_resize_matches_torch():
    """jax.image.resize 'bilinear' (half-pixel centers) matches torch
    F.interpolate(align_corners=False) — the torchvision preprocessing
    convention the reference FID inherits."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ours = np.asarray(
        jax.image.resize(jnp.asarray(x), (2, 75, 75, 3), method="bilinear")
    )
    theirs = _nhwc(
        F.interpolate(_nchw(x), size=(75, 75), mode="bilinear",
                      align_corners=False)
    )
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


def test_lpips_alex_matches_torch(tmp_path):
    """Full LPIPS pipeline parity vs a torch-functional reimplementation of
    the lpips-package forward (scaling layer → alexnet relu taps → unit
    normalize → nonneg 1×1 heads → spatial average → sum over taps) with
    the same synthetic weights."""
    from distillation_trajectories_tpu.metrics.lpips import (
        _ALEX_CONVS,
        _SCALE,
        _SHIFT,
        AlexFeatures,
        LPIPSAlex,
        load_lpips_weights,
    )

    rng = np.random.default_rng(5)
    model = AlexFeatures()
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))

    state = {}
    for i, (ch, k, s, p, tname) in enumerate(_ALEX_CONVS):
        kshape = variables["params"][f"conv{i}"]["kernel"].shape  # HWIO
        h, w, ic, oc = kshape
        state[f"{tname}.weight"] = rng.standard_normal((oc, ic, h, w)).astype(
            np.float32
        ) * 0.05
        state[f"{tname}.bias"] = rng.standard_normal((oc,)).astype(np.float32) * 0.05
        state[f"lin{i}.model.1.weight"] = np.abs(
            rng.standard_normal((1, oc, 1, 1)).astype(np.float32)
        )
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **state)
    variables, lin = load_lpips_weights(path, variables)
    scorer = LPIPSAlex(variables, lin)

    x = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    ours = scorer(x, y)

    def torch_taps(a):
        t = (_nchw(a) - torch.from_numpy(_SHIFT).view(1, 3, 1, 1)) / (
            torch.from_numpy(_SCALE).view(1, 3, 1, 1)
        )
        taps = []
        for i, (ch, k, s, p, tname) in enumerate(_ALEX_CONVS):
            t = F.conv2d(
                t, torch.from_numpy(state[f"{tname}.weight"]),
                torch.from_numpy(state[f"{tname}.bias"]), stride=s, padding=p,
            )
            t = F.relu(t)
            taps.append(t)
            if i in (0, 1):
                t = F.max_pool2d(t, 3, stride=2)
        return taps

    with torch.no_grad():
        fx, fy = torch_taps(x), torch_taps(y)
        total = torch.zeros(3)
        for tx, ty, (i, _) in zip(fx, fy, enumerate(_ALEX_CONVS)):
            nx = tx / torch.sqrt((tx * tx).sum(dim=1, keepdim=True) + 1e-10)
            ny = ty / torch.sqrt((ty * ty).sum(dim=1, keepdim=True) + 1e-10)
            d = (nx - ny) ** 2
            w = torch.from_numpy(state[f"lin{i}.model.1.weight"]).clamp(min=0)
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
    np.testing.assert_allclose(ours, total.numpy(), rtol=1e-4, atol=1e-5)
