"""Port parity for LPIPS and the evaluation helpers: AlexNet-LPIPS
distances against the JAX scorer at 64x64 (one weights file read by both,
and JAX's seeded variables carried across by
``alexnet_lpips_state_dict_from_variables``), ``compute_lpips`` with
weights and its 0.5 placeholder without, and
``compute_trajectory_divergence``.  Distances at rtol 1e-4."""

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.metrics import evaluation as jax_evaluation
from distillation_trajectories_tpu.metrics.lpips import create_lpips as jax_create_lpips
from distillation_trajectories_torch.metrics import evaluation
from distillation_trajectories_torch.metrics.lpips import create_lpips, load_lpips_weights
from distillation_trajectories_torch.models import alexnet_lpips_state_dict_from_variables

torch.set_num_threads(2)

# torchvision alexnet `features` conv shapes (OIHW) and lpips head widths.
ALEX_SHAPES = {0: (64, 3, 11, 11), 3: (192, 64, 5, 5), 6: (384, 192, 3, 3),
               8: (256, 384, 3, 3), 10: (256, 256, 3, 3)}


def _weights_file(path, seed=0):
    rng = np.random.default_rng(seed)
    state = {}
    for index, shape in ALEX_SHAPES.items():
        state[f"features.{index}.weight"] = rng.standard_normal(shape).astype(np.float32) * 0.05
        state[f"features.{index}.bias"] = rng.normal(0, 0.05, shape[0]).astype(np.float32)
    for i, shape in enumerate(ALEX_SHAPES.values()):
        # Some negative head weights: both packages clip them at zero.
        state[f"lin{i}.model.1.weight"] = rng.normal(0.1, 0.1, (1, shape[0], 1, 1)).astype(
            np.float32)
    np.savez(path, **state)
    return str(path)


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_scorer_from_a_weights_file_matches_jax(tmp_path):
    path = _weights_file(tmp_path / "lpips_alex.npz")
    jscorer, jpre = jax_create_lpips(path)
    scorer, pretrained = create_lpips(path, device="cpu")
    assert jpre and pretrained
    for shape in ((4, 64, 64, 3), (2, 64, 64, 1)):
        x, y = _images(shape, 1), _images(shape, 2)
        want = jscorer(x, y)
        with torch.no_grad():
            got = scorer(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        assert got.shape == (shape[0],) and (got > 0).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=str(shape))
    with torch.no_grad():
        same = scorer(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_seeded_scorer_matches_jax_through_the_bridge(monkeypatch, tmp_path):
    """JAX's seeded variables and uniform 1/C heads, carried into the port."""
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    jscorer, jpre = jax_create_lpips(seed=3)
    scorer, pretrained = create_lpips(device="cpu")
    assert not jpre and not pretrained
    variables = jax.tree_util.tree_map(np.asarray, jscorer.variables)
    lin = [np.asarray(w) for w in jscorer.lin]
    scorer.load_state_dict(alexnet_lpips_state_dict_from_variables(variables, lin), strict=True)
    x, y = _images((8, 64, 64, 3), 3), _images((8, 64, 64, 3), 4)
    with torch.no_grad():
        got = scorer(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, jscorer(x, y), rtol=1e-4)
    # The port's own seeded heads are the same uniform 1/C.
    fresh, _ = create_lpips(device="cpu")
    for i, w in enumerate(lin):
        np.testing.assert_array_equal(fresh.state_dict()[f"lin{i}.model.1.weight"].reshape(-1), w)


def test_weights_file_contract(tmp_path):
    scorer, _ = create_lpips(str(tmp_path / "absent.npz"), device="cpu")
    names = {k: tuple(v.shape) for k, v in scorer.state_dict().items()}
    for index, shape in ALEX_SHAPES.items():
        assert names[f"net.features.{index}.weight"] == shape
    assert names["lin4.model.1.weight"] == (1, 256, 1, 1)
    path = _weights_file(tmp_path / "lpips.npz")
    state = dict(np.load(path))
    del state["lin2.model.1.weight"]
    np.savez(tmp_path / "broken.npz", **state)
    with pytest.raises(KeyError, match="lin2.model.1.weight"):
        load_lpips_weights(str(tmp_path / "broken.npz"), scorer)
    assert create_lpips(str(tmp_path / "broken.npz"), device="cpu")[1] is False


def test_compute_lpips_backends_match_jax(monkeypatch, tmp_path):
    """With a weights file both packages score with AlexNet-LPIPS (the
    ``lpips`` package is absent here); without one both return the
    reference's placeholder 0.5 per pair."""
    a = np.random.default_rng(5).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    b = np.random.default_rng(6).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    path = _weights_file(tmp_path / "lpips_alex.npz", seed=1)
    got = evaluation.compute_lpips(a, b, weights_path=path, device="cpu")
    want = jax_evaluation.compute_lpips(a, b, weights_path=path)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert evaluation.compute_lpips(a, b[:2], device="cpu") == [0.5, 0.5]
    assert evaluation._LPIPS_CACHE.get("torch", "unset") is None  # tried once


def test_compute_trajectory_divergence_matches_jax():
    rng = np.random.default_rng(8)
    t1 = np.cumsum(rng.normal(size=(11, 8, 8, 3)), axis=0).astype(np.float32)
    t2 = (t1 + rng.normal(scale=0.3, size=t1.shape)).astype(np.float32)
    got = evaluation.compute_trajectory_divergence(t1, list(t2[:9]), device="cpu")
    want = jax_evaluation.compute_trajectory_divergence(t1, list(t2[:9]))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
