"""The port's last entry points against their JAX counterparts, on the CPU:

- ``run_on_cpu``: the child's command line and masked environment for each
  choice, its exit code passed on, and ``run_on_cpu train_teacher`` at
  tiny flags writing the same checkpoint as ``train_teacher --device cpu``
  with the same flags, exactly (both as subprocesses);
- ``smoke_diffusion``: the seven stages pass on ``--device cpu``; a stage
  forced to fail shows the critical abort (or, for a non-critical stage,
  the next stages running) and exit 1; ``cuda`` without a card fails device
  setup, critically;
- ``analyze_latest_sample``: ``structure_score`` equals the JAX script's
  (loaded by path) on the same arrays, exactly, and ``run`` prints the JAX
  script's text for the same grids;
- ``utils/viz.py::read_png`` equals ``np.array(PIL.Image.open(...))`` on PNGs
  written by ``write_png``, by PIL (L, RGB, RGBA), by JAX's matplotlib
  ``save_image_grid`` and by a hand encoder using each of the five row
  filters; other PNGs raise;
- ``show_real_samples.run`` picks the same 16 images as JAX's
  ``get_real_images`` on the same data root, bit for bit.
"""

import importlib.util
import os
import struct
import subprocess
import sys
import zlib
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.data import datasets as jax_datasets
from distillation_trajectories_tpu.utils import viz as jax_viz
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.data import datasets
from distillation_trajectories_torch.scripts import (
    analyze_latest_sample,
    run_on_cpu,
    show_real_samples,
    smoke_diffusion,
)
from distillation_trajectories_torch.training.checkpoints import load_checkpoint
from distillation_trajectories_torch.utils.viz import read_png, save_image_grid, write_png
from torch_parity import tmp_path  # noqa: F401  (each test's outputs removed when it ends)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("--epochs 1 --limit_batches 2 --dataset MNIST --image_size 16 --timesteps 10 "
        "--num_samples 0 --batch_size 8")


def _jax_script(name):
    """A module of the repository's ``scripts/``, loaded by path (its
    ``_common`` puts the checkout on ``sys.path``; restored after)."""
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


# --- run_on_cpu --------------------------------------------------------------

@pytest.mark.parametrize("script", run_on_cpu.SCRIPTS)
def test_run_on_cpu_dispatches_a_masked_child(script, capsys):
    calls = []

    def fake_run(cmd, env):
        calls.append((cmd, env))
        return subprocess.CompletedProcess(cmd, 3)

    with mock.patch.object(run_on_cpu.subprocess, "run", fake_run):
        code = run_on_cpu.main([script, "--args", "--epochs 1  --base_dir /data/run"])
    assert code == 3
    (cmd, env), = calls
    assert cmd == [sys.executable, "-m", f"distillation_trajectories_torch.scripts.{script}",
                   "--device", "cpu", "--epochs", "1", "--base_dir", "/data/run"]
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert ROOT in env["PYTHONPATH"].split(os.pathsep)
    assert f"Running {script} on CPU..." in capsys.readouterr().out


def _tree_equal(a, b, path="") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_run_on_cpu_train_teacher_equals_the_direct_cli(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    direct = subprocess.run(
        [sys.executable, "-m", "distillation_trajectories_torch.scripts.train_teacher",
         "--device", "cpu", *TINY.split(), "--base_dir", str(tmp_path / "direct")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert direct.returncode == 0, direct.stderr[-2000:]
    dispatched = subprocess.run(
        [sys.executable, "-m", "distillation_trajectories_torch.scripts.run_on_cpu",
         "train_teacher", "--args", f"{TINY} --base_dir {tmp_path / 'dispatched'}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert dispatched.returncode == 0, dispatched.stderr[-2000:]
    assert "RUNNING ON CPU" in dispatched.stdout
    assert "[device] cpu; torch.cuda.is_available()=False" in dispatched.stdout
    got, want = (load_checkpoint(Config(base_dir=str(tmp_path / d)).teacher_models_dir, 1)
                 for d in ("dispatched", "direct"))
    _tree_equal(got, want)


# --- smoke_diffusion -----------------------------------------------------------

def test_smoke_suite_passes_on_the_cpu(tmp_path, capsys):
    assert smoke_diffusion.main(["--device", "cpu", "--base_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "7/7 smoke tests passed" in out
    assert [line.strip() for line in out.splitlines() if line.strip().startswith("✓")] == [
        f"✓ {name}" for name, _, _ in smoke_diffusion.STAGES]
    results = Config(base_dir=str(tmp_path)).results_dir
    for name in ("forward_diffusion_test.png", "data_loader_test.png"):
        assert os.path.getsize(os.path.join(results, name)) > 0


@pytest.mark.parametrize("failing, device, passed, aborted", [
    ("stage_model_forward", "cpu", 1, True),        # critical: the rest do not run
    ("stage_forward_diffusion", "cpu", 6, False),   # not critical: the rest run
    (None, "cuda", 0, True),                        # no card: device setup fails
])
def test_smoke_suite_failures(tmp_path, capsys, monkeypatch, failing, device, passed, aborted):
    if failing is not None:
        def boom(cfg, state):
            raise RuntimeError("forced failure")

        monkeypatch.setattr(smoke_diffusion, "STAGES", tuple(
            (name, boom if stage.__name__ == failing else stage, critical)
            for name, stage, critical in smoke_diffusion.STAGES))
    if device == "cuda":
        monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    argv = ["--device", "cpu", "--base_dir", str(tmp_path)] if device == "cpu" else []
    assert smoke_diffusion.main(argv) == 1
    out = capsys.readouterr().out
    assert f"{passed}/7 smoke tests passed" in out
    assert ("critical failure — aborting" in out) is aborted
    if device == "cuda":  # the default base_dir is a fresh temporary directory
        assert "smoke suite on cuda, writing under" in out and ROOT not in out.splitlines()[0]


# --- analyze_latest_sample -------------------------------------------------------

def _images():
    rng = np.random.default_rng(4)
    smooth = np.repeat(np.linspace(0, 255, 64)[:, None], 64, axis=1)
    return {
        "rgb noise": rng.integers(0, 256, (50, 70, 3)).astype(np.uint8),
        "rgba grid": rng.integers(0, 256, (64, 48, 4)).astype(np.uint8),
        "grey": rng.integers(0, 256, (40, 40)).astype(np.uint8),
        "smooth": (smooth[..., None] + rng.normal(0, 4, (64, 64, 3))).clip(0, 255).astype(np.uint8),
        "constant patches": np.full((48, 48, 3), 7, np.uint8),
        "smaller than a patch": rng.integers(0, 256, (10, 12, 3)).astype(np.uint8),
        "float": rng.normal(size=(33, 65, 3)),
    }


@pytest.mark.parametrize("kind", list(_images()))
def test_structure_score_equals_jax_script(kind):
    jax_script = _jax_script("analyze_latest_sample")
    img = _images()[kind]
    for patch in (16, 8):
        got = analyze_latest_sample.structure_score(img, patch)
        assert got == jax_script.structure_score(img, patch), (kind, patch)


@pytest.mark.parametrize("epochs, kind", [((2, 10, 9), "rgb noise"), ((60,), "smooth"),
                                          ((), None)])
def test_analyze_latest_sample_prints_the_jax_text(tmp_path, capsys, monkeypatch, epochs, kind):
    cfg = Config(base_dir=str(tmp_path)).create_directories()
    for e in epochs:
        write_png(os.path.join(cfg.results_dir, f"samples_epoch_{e}.png"), _images()[kind])
    got = analyze_latest_sample.main(["--base_dir", str(tmp_path)])
    port_out = capsys.readouterr().out
    jax_script = _jax_script("analyze_latest_sample")
    monkeypatch.setattr("distillation_trajectories_tpu.Config", lambda: cfg)
    jax_script.main()
    assert port_out == capsys.readouterr().out
    if not epochs:
        assert got is None
    else:
        assert got["epoch"] == max(epochs)
        assert got["file"] == os.path.join(cfg.results_dir, f"samples_epoch_{max(epochs)}.png")
        np.testing.assert_array_equal(got["image"], _images()[kind])


# --- read_png ----------------------------------------------------------------------

def _png_chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _encode_filtered(img, filters, colour=6, depth=8, interlace=0):
    """An 8-bit PNG whose row ``y`` uses row filter ``filters[y % len]``."""
    h, w, c = img.shape
    bpp, raw, prior = c, b"", np.zeros(w * c, np.int32)
    for y in range(h):
        row = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        kind = filters[y % len(filters)]
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw += bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
            + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


def _write_case(path, case, rng):
    if case == "write_png":
        write_png(path, rng.integers(0, 256, (21, 17, 3)).astype(np.uint8))
    elif case.startswith("PIL "):
        mode = case.split()[1]
        shape = {"L": (23, 31), "RGB": (19, 29, 3), "RGBA": (27, 13, 4)}[mode]
        img = np.cumsum(rng.integers(0, 40, shape), axis=0).astype(np.uint8)  # smooth: filters vary
        Image.fromarray(img, mode).save(path)
    elif case == "jax save_image_grid":
        jax_viz.save_image_grid(rng.uniform(-1, 1, (4, 8, 8, 1)).astype(np.float32), path,
                                nrow=2, figsize=(2, 2))
    else:  # "filters": every row filter, RGBA rows cycling through 0-4
        img = np.cumsum(rng.integers(0, 30, (15, 11, 4)), axis=1).astype(np.uint8)
        with open(path, "wb") as f:
            f.write(_encode_filtered(img, [0, 1, 2, 3, 4]))


@pytest.mark.parametrize("case", ["write_png", "PIL L", "PIL RGB", "PIL RGBA",
                                  "jax save_image_grid", "filters"])
def test_read_png_equals_pil(tmp_path, case):
    path = str(tmp_path / "x.png")
    _write_case(path, case, np.random.default_rng(len(case)))
    got, want = read_png(path), np.array(Image.open(path))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "jax save_image_grid":
        assert got.shape[-1] == 4  # matplotlib writes RGBA


@pytest.mark.parametrize("kwargs, match", [
    (dict(depth=16), "unsupported"),
    (dict(colour=3), "unsupported"),
    (dict(interlace=1), "unsupported"),
])
def test_read_png_rejects_other_pngs(tmp_path, kwargs, match):
    path = tmp_path / "x.png"
    path.write_bytes(_encode_filtered(np.zeros((2, 2, 4), np.uint8), [0], **kwargs))
    with pytest.raises(ValueError, match=match):
        read_png(str(path))
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(path))


# --- show_real_samples -------------------------------------------------------------

@pytest.mark.parametrize("files", [True, False])
def test_show_real_samples_picks_jax_images(tmp_path, monkeypatch, files):
    """The idx files at their native 28x28 (the resize is held to JAX's at
    atol 1e-5 in ``test_torch_data.py``), the synthetic stand-in at 16x16."""
    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [])
    monkeypatch.setattr(datasets, "_EXTRA_DATA_ROOTS", [])
    size = 28 if files else 16
    kw = dict(base_dir=str(tmp_path), dataset="MNIST", image_size=size, channels=1)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    if files:  # a t10k idx pair of 20 images under the shared data root
        raw = os.path.join(cfg.data_dir, "MNIST", "raw")
        os.makedirs(raw)
        images = np.random.default_rng(0).integers(0, 256, (20, 28, 28), dtype=np.uint8)
        with open(os.path.join(raw, "t10k-images-idx3-ubyte"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, 20, 28, 28) + images.tobytes())
        with open(os.path.join(raw, "t10k-labels-idx1-ubyte"), "wb") as f:
            f.write(struct.pack(">II", 2049, 20) + (np.arange(20) % 10).astype(np.uint8).tobytes())
    path, got = show_real_samples.run(cfg)
    want = jax_datasets.get_real_images(jcfg, num_images=16)
    assert got.shape == want.shape == (16, size, size, 1) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert path == os.path.join(cfg.results_dir, "real_images.png")
    grid = read_png(path)
    save_image_grid(want, str(tmp_path / "want.png"), nrow=4)
    np.testing.assert_array_equal(grid, read_png(str(tmp_path / "want.png")))


@pytest.mark.parametrize("plots", [True, False])
def test_show_real_samples_main(tmp_path, capsys, plots):
    modules = {} if plots else {"matplotlib": None}
    with mock.patch.dict(sys.modules, modules):
        show_real_samples.main(["--base_dir", str(tmp_path)])
    results = Config(base_dir=str(tmp_path)).results_dir
    singles = sorted(f for f in os.listdir(results) if f.startswith("real_image_"))
    assert os.path.getsize(os.path.join(results, "real_images.png")) > 0
    assert singles == ([f"real_image_{i}.png" for i in range(1, 6)] if plots else [])
    assert ("plots skipped" in capsys.readouterr().out) is not plots
