"""The port's PNG figures against the JAX package's, decoded with the port's
``utils/viz.py::read_png`` and held to equal pixels: the sample grid of
``save_image_grid`` (grey and RGB, ``nrow`` 4, two figure sizes) and the
FID comparison figure of ``metrics/fid.py::_write_artifacts`` against JAX's
``_fid_report`` (given the features, so that no Inception runs).  Without
matplotlib both write the raw grid and say so (its pixels are held to
JAX's ``make_grid`` in ``test_torch_trainers.py``)."""

import collections
import sys

import numpy as np
import pytest

from distillation_trajectories_tpu.metrics import fid as jax_fid
from distillation_trajectories_tpu.utils import viz as jax_viz
from distillation_trajectories_torch.metrics import fid
from distillation_trajectories_torch.utils import viz
from torch_parity import tmp_path  # noqa: F401  (each test's outputs removed when it ends)


@pytest.fixture()
def writes(monkeypatch):
    """A fresh count of this process's PNG writes."""
    monkeypatch.setattr(viz, "png_writes", collections.Counter())
    return viz.png_writes


@pytest.mark.parametrize("figsize", [(10, 10), (3, 2)], ids=["10x10", "3x2"])
@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "rgb"])
def test_save_image_grid_pixels_equal_jax(tmp_path, writes, channels, figsize):
    images = np.random.default_rng(channels).uniform(-1.2, 1.2, (16, 32, 32, channels))
    images = images.astype(np.float32)
    jax_viz.save_image_grid(images, str(tmp_path / "jax.png"), nrow=4, figsize=figsize)
    viz.save_image_grid(images, str(tmp_path / "port.png"), nrow=4, figsize=figsize)
    want, got = viz.read_png(str(tmp_path / "jax.png")), viz.read_png(str(tmp_path / "port.png"))
    assert got.shape == want.shape and got.shape[-1] == 4
    np.testing.assert_array_equal(got, want)
    assert writes == {viz.MATPLOTLIB_WRITER: 1}


@pytest.mark.parametrize("channels, n", [(1, 1), (3, 2)], ids=["grey-1", "rgb-2"])
def test_fid_figure_pixels_equal_jax(tmp_path, writes, channels, n):
    """One shown pair (the 2 x 1 panel JAX transposes) in grey, two in RGB;
    the student set is one sample longer than the teacher's."""
    rng = np.random.default_rng(n)
    teacher = rng.uniform(-1, 1, (n, 16, 16, channels)).astype(np.float32)
    student = rng.uniform(-1, 1, (n + 1, 16, 16, channels)).astype(np.float32)
    features = rng.standard_normal((6, 4))
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    score = jax_fid._fid_report(teacher, student, 0.1, str(jax_dir),
                                teacher_features=features, student_features=features + 1.0)
    fid._write_artifacts(teacher, student, 0.1, str(port_dir), score["fid_score"])
    for name in ("fid_samples_size_0.1.png", "fid_score_size_0.1.txt"):
        assert (port_dir / name).exists(), name
    want = viz.read_png(str(jax_dir / "fid_samples_size_0.1.png"))
    got = viz.read_png(str(port_dir / "fid_samples_size_0.1.png"))
    assert got.shape == want.shape == (1800, 900 * n, 4)
    np.testing.assert_array_equal(got, want)
    assert (port_dir / "fid_score_size_0.1.txt").read_text() == \
        (jax_dir / "fid_score_size_0.1.txt").read_text()
    assert writes == {viz.MATPLOTLIB_WRITER: 1}


def test_without_matplotlib_the_raw_writer_runs_and_says_so(tmp_path, writes, monkeypatch,
                                                            capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    images = np.random.default_rng(0).uniform(-1, 1, (3, 8, 8, 1)).astype(np.float32)
    viz.save_image_grid(images, str(tmp_path / "grid.png"), nrow=2, figsize=(4, 4))
    assert viz.read_png(str(tmp_path / "grid.png")).shape == (2 * 10 + 2, 2 * 10 + 2, 3)
    fid._write_artifacts(images, images[:2], 0.5, str(tmp_path), 1.25)
    assert viz.read_png(str(tmp_path / "fid_samples_size_0.5.png")).shape == (2 * 10 + 2,
                                                                            2 * 10 + 2, 3)
    assert writes == {viz.RAW_WRITER: 2}
    out = capsys.readouterr().out
    assert out.count(f"[viz] PNG writer: {viz.RAW_WRITER}") == 1
