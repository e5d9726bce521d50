"""Port parity for the FID featurizer: the InceptionV3 trunk against the
JAX trunk (JAX variables carried across by
``inception_state_dict_from_variables``), ``preprocess_for_inception``
against ``jax.image.resize``, the torchvision name contract, weight files
(``.npz``/``.pth``, the missing-key ``KeyError``) and the seeded init.

The JAX trunk runs eagerly on the CPU at 95x95 (the smallest input that
survives its stride-2 stages), batch 2.  Features agree to 1e-4 of the
largest feature; the preprocessing to 1e-5."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.models.inception import InceptionV3Features as JaxInception
from distillation_trajectories_tpu.models.inception import (
    preprocess_for_inception as jax_preprocess_for_inception,
)
from distillation_trajectories_torch.metrics.fid import InceptionModel
from distillation_trajectories_torch.models import inception_state_dict_from_variables
from distillation_trajectories_torch.models.inception import (
    create_inception,
    load_torchvision_weights,
    preprocess_for_inception,
)

torch.set_num_threads(2)

# Shapes of the real torchvision inception_v3 state dict (facts, not
# derived from the port's code).
TORCHVISION_SHAPES = {
    "Conv2d_1a_3x3.conv.weight": (32, 3, 3, 3),
    "Conv2d_2a_3x3.conv.weight": (32, 32, 3, 3),
    "Conv2d_2b_3x3.conv.weight": (64, 32, 3, 3),
    "Conv2d_3b_1x1.conv.weight": (80, 64, 1, 1),
    "Conv2d_4a_3x3.conv.weight": (192, 80, 3, 3),
    "Mixed_5b.branch1x1.conv.weight": (64, 192, 1, 1),
    "Mixed_5b.branch5x5_2.conv.weight": (64, 48, 5, 5),
    "Mixed_6a.branch3x3.conv.weight": (384, 288, 3, 3),
    "Mixed_6b.branch7x7_2.conv.weight": (128, 128, 1, 7),
    "Mixed_6b.branch7x7_3.conv.weight": (192, 128, 7, 1),
    "Mixed_7a.branch3x3_2.conv.weight": (320, 192, 3, 3),
    "Mixed_7b.branch3x3_2a.conv.weight": (384, 384, 1, 3),
    "Mixed_7c.branch_pool.conv.weight": (192, 2048, 1, 1),
    "Mixed_5b.branch1x1.bn.weight": (64,),
    "Mixed_5b.branch1x1.bn.running_mean": (64,),
}


@pytest.fixture(scope="module")
def jax_variables():
    """Random JAX trunk variables at realistic scales: He-scaled kernels,
    BN scales near 1, small shifts and means, variances near 1."""
    shapes = jax.eval_shape(
        lambda: JaxInception().init(jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3))))
    rng = np.random.default_rng(0)
    out = {}
    for key, s in flax.traverse_util.flatten_dict(shapes, sep="/").items():
        leaf = key.rsplit("/", 1)[1]
        if leaf == "kernel":
            w = rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif leaf == "scale":
            w = rng.uniform(0.8, 1.2, s.shape)
        elif leaf == "var":
            w = rng.uniform(0.5, 1.5, s.shape)
        else:  # bias, mean
            w = rng.normal(0.0, 0.1, s.shape)
        out[tuple(key.split("/"))] = np.asarray(w, np.float32)
    return flax.traverse_util.unflatten_dict(out)


@pytest.fixture(scope="module")
def port_model():
    return create_inception(weights_path="/nonexistent/inception_v3.npz", device="cpu")[0]


def test_trunk_matches_jax(jax_variables, port_model):
    x = np.random.default_rng(3).standard_normal((2, 95, 95, 3)).astype(np.float32)
    want = np.asarray(JaxInception().apply(jax_variables, x))
    port_model.load_state_dict(inception_state_dict_from_variables(jax_variables), strict=True)
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("shape", [(2, 16, 16, 1), (2, 32, 32, 3)])
def test_preprocess_matches_jax_resize(shape):
    images = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jax_preprocess_for_inception(jnp.asarray(images)))
    got = preprocess_for_inception(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _torchvision_state(model, seed):
    """A torchvision-shaped state dict: the port's names and shapes with
    random values, plus the classifier, aux head and BN counters a real
    file carries."""
    rng = np.random.default_rng(seed)
    state = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
             for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    state["fc.weight"] = rng.standard_normal((1000, 2048)).astype(np.float32)
    state["fc.bias"] = np.zeros(1000, np.float32)
    state["AuxLogits.conv0.conv.weight"] = rng.standard_normal((128, 768, 1, 1)).astype(np.float32)
    state["Conv2d_1a_3x3.bn.num_batches_tracked"] = np.asarray(1, np.int64)
    return state


def test_torchvision_name_contract(port_model):
    own = port_model.state_dict()
    for k, shape in TORCHVISION_SHAPES.items():
        assert tuple(own[k].shape) == shape, k
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in _torchvision_state(port_model, 0).items()}
    result = port_model.load_state_dict(state, strict=False)
    assert all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    assert result.unexpected_keys and all(
        k.startswith(("fc.", "AuxLogits.")) for k in result.unexpected_keys)


@pytest.mark.parametrize("suffix", [".npz", ".pth"])
def test_weight_file_round_trip(port_model, tmp_path, suffix):
    state = _torchvision_state(port_model, 2)
    path = str(tmp_path / f"inception_v3{suffix}")
    if suffix == ".npz":
        np.savez(path, **state)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, path)
    loaded, pretrained = create_inception(weights_path=path, device="cpu")
    assert pretrained
    for k, v in loaded.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def test_missing_weight_raises_and_leaves_seeded_features(port_model, tmp_path):
    state = _torchvision_state(port_model, 3)
    del state["Mixed_7c.branch_pool.conv.weight"]
    broken = str(tmp_path / "broken.npz")
    np.savez(broken, **state)
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool.conv.weight"):
        load_torchvision_weights(broken, port_model)
    # An incomplete file leaves the seeded features, as no file does.
    model, pretrained = create_inception(weights_path=broken, device="cpu")
    assert pretrained is False and not any(p.requires_grad for p in model.parameters())
    w = model.Mixed_7c.branch_pool.conv.weight  # fan-in 2048
    std = (1.0 / 2048) ** 0.5
    assert abs(float(w.std()) - std) < 0.02 * std
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-7
    bn = model.Mixed_5b.branch1x1.bn
    assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.running_var, torch.ones(64))
    assert torch.equal(bn.bias, torch.zeros(64)) and torch.equal(bn.running_mean, torch.zeros(64))


def test_featurizer_is_seeded_and_batch_independent(monkeypatch, tmp_path):
    monkeypatch.setenv("INCEPTION_WEIGHTS", str(tmp_path / "absent.npz"))
    reference, _ = create_inception(device="cpu")
    featurizer = InceptionModel(batch_size=2, device="cpu")
    assert featurizer.pretrained is False
    for k, v in featurizer.model.state_dict().items():
        assert torch.equal(v, reference.state_dict()[k]), k
    images = np.random.default_rng(4).uniform(-1, 1, (3, 16, 16, 1)).astype(np.float32)
    feats = featurizer.get_features(images)  # batches of 2 and 1
    with torch.no_grad():
        whole = reference(preprocess_for_inception(torch.from_numpy(images))).numpy()
    assert feats.shape == (3, 2048) and np.isfinite(feats).all()
    np.testing.assert_allclose(feats, whole, rtol=1e-5, atol=1e-6)
