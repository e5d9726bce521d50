"""Port parity: the data layer — the synthetic stand-in (bit-exact), the
MNIST / CIFAR-10 readers and the bilinear resize against
``jax.image.resize``, the shuffle stream and loader batches — and the
native build into ``build/native`` that leaves ``native/`` untouched."""

import os
import pickle
import struct
import subprocess

import numpy as np
import pytest

from distillation_trajectories_tpu.data import datasets as jax_datasets
from distillation_trajectories_tpu.data import native as jax_native
from distillation_trajectories_torch.data import datasets, native
from torch_parity import configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _native_mtimes():
    d = os.path.join(REPO, "native")
    return {n: os.stat(os.path.join(d, n)).st_mtime_ns for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("size, channels, seed", [(16, 1, 0), (32, 3, 1)])
def test_synthetic_dataset_is_bit_exact(size, channels, seed):
    got = datasets._synthetic_dataset(40, size, channels, seed)
    want = jax_datasets._synthetic_dataset(40, size, channels, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("in_size, out_size", [(28, 32), (32, 16), (28, 16), (32, 32)])
def test_resize_matches_jax_image_resize(in_size, out_size):
    x = np.random.default_rng(in_size).integers(0, 256, (4, in_size, in_size, 3)).astype(np.uint8)
    got = datasets.resize_bilinear(x, out_size)
    want = jax_datasets._resize_batch(x, out_size)
    assert got.shape == want.shape == (4, out_size, out_size, 3) and got.dtype == np.float32
    # Compared on the [-1, 1] scale the loaders deliver.
    np.testing.assert_allclose(got / 255.0 * 2 - 1, want / 255.0 * 2 - 1, rtol=0, atol=1e-5)


def _write_mnist(root, n=12):
    rng = np.random.default_rng(0)
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw)
    images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    with open(os.path.join(raw, "t10k-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with open(os.path.join(raw, "t10k-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + (np.arange(n) % 10).astype(np.uint8).tobytes())


def _write_cifar(root, n=6):
    rng = np.random.default_rng(1)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": list(rng.integers(0, 10, n))}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(batch, f)


@pytest.mark.parametrize("dataset, image_size, channels, train", [
    ("MNIST", 32, 1, True),   # test split stands in for train: 28 -> 32
    ("MNIST", 16, 3, False),  # 28 -> 16, one channel repeated
    ("CIFAR10", 32, 3, True),
    ("CIFAR10", 16, 3, False),
    ("CIFAR10", 16, 1, True),  # first channel kept
])
def test_load_dataset_matches_jax(tmp_path, monkeypatch, dataset, image_size, channels, train):
    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [])
    jcfg, tcfg = configs(tmp_path, dataset=dataset, image_size=image_size, channels=channels)
    (_write_mnist if dataset == "MNIST" else _write_cifar)(tcfg.data_dir)
    got_x, got_y = datasets.load_dataset(tcfg, train=train)
    want_x, want_y = jax_datasets.load_dataset(jcfg, train=train)
    assert got_x.shape == want_x.shape and got_x.dtype == np.float32
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-5)


def test_synthetic_fallback_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [])
    jcfg, tcfg = configs(tmp_path, dataset="CIFAR10", image_size=8, channels=3)
    got = datasets.get_real_images(tcfg, 5)
    np.testing.assert_array_equal(got, jax_datasets.get_real_images(jcfg, 5))
    with pytest.raises(ValueError, match="not supported"):
        datasets.load_dataset(configs(tmp_path, dataset="SVHN")[1])


def test_shuffle_stream_and_batches_match_jax_loader():
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's native library did not build: its loader "
                    "shuffles with numpy's stream instead")
    rng = np.random.default_rng(1)
    images = rng.standard_normal((19, 4, 4, 1)).astype(np.float32)
    labels = np.arange(19, dtype=np.int32)
    for n, seed in ((19, 11), (10_000, 0), (10_000, 3)):
        np.testing.assert_array_equal(native.shuffle_indices(n, seed * 1_000_003 + 1),
                                      jax_native.shuffle_indices(n, seed * 1_000_003 + 1))
    ours = datasets.DataLoader(images, labels, 4, seed=11)
    theirs = jax_datasets.DataLoader(images, labels, 4, seed=11)
    for _ in range(2):
        np.testing.assert_array_equal(ours.epoch_indices(), theirs.epoch_indices())
    ours = datasets.DataLoader(images, labels, 4, seed=11)
    theirs = jax_datasets.DataLoader(images, labels, 4, seed=11)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 4
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_loader_stops_its_prefetch_thread_when_closed():
    images = np.zeros((64, 2, 2, 1), np.float32)
    loader = datasets.DataLoader(images, np.zeros(64), 2, seed=0, prefetch=1)
    batches = iter(loader)
    next(batches)
    batches.close()  # returns only after the producer has stopped
    assert len(list(loader)) == 32


def test_native_builds_into_build_dir_and_never_writes_native(tmp_path, monkeypatch):
    assert native.LIBRARY == os.path.join(REPO, "build", "native", "libdtt_data.so")
    assert native.SOURCE == os.path.join(REPO, "native", "dtt_data.cpp")
    before = _native_mtimes()
    target = str(tmp_path / "build" / "libdtt_data.so")
    monkeypatch.setattr(native, "LIBRARY", target)
    monkeypatch.setattr(native, "_lib", None)
    lib = native.get_lib()  # a fresh build
    assert os.path.exists(target) and lib._name == target
    assert sorted(native.shuffle_indices(50, 1).tolist()) == list(range(50))
    assert _native_mtimes() == before


def test_native_build_failure_raises(tmp_path, monkeypatch):
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "libdtt_data.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(subprocess, "run", no_compiler)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.shuffle_indices(4, 0)


@pytest.mark.parametrize("dataset, image_size, channels", [("MNIST", 28, 1), ("CIFAR10", 32, 3)])
def test_extra_data_roots_match_jax_bit_for_bit(tmp_path, monkeypatch, dataset, image_size,
                                                channels):
    """The readers search ``config.data_dir`` and then the extra roots, as
    the JAX package does: with the files only under an extra root (a t10k
    idx pair, a one-batch CIFAR pickle) both give the same arrays, bit for
    bit (native size, so no resize)."""
    mount = tmp_path / "mount"
    monkeypatch.setattr(jax_datasets, "_EXTRA_DATA_ROOTS", [str(mount)])
    monkeypatch.setattr(datasets, "_EXTRA_DATA_ROOTS", [str(mount)])
    if dataset == "MNIST":
        _write_mnist(str(mount), n=20)
    else:
        d = mount / "cifar-10-batches-py"
        d.mkdir(parents=True)
        rng = np.random.default_rng(2)
        with open(d / "test_batch", "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (7, 3072), dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 7))}, f)
    jcfg, tcfg = configs(tmp_path / "run", dataset=dataset, image_size=image_size,
                         channels=channels)
    for sub in ("MNIST", "cifar-10-batches-py"):  # nothing under config.data_dir
        assert not os.path.exists(os.path.join(tcfg.data_dir, sub))
    got_x, got_y = datasets.load_dataset(tcfg, train=False)
    want_x, want_y = jax_datasets.load_dataset(jcfg, train=False)
    assert got_x.shape == want_x.shape == ((20,) if dataset == "MNIST" else (7,)) + (
        image_size, image_size, channels)
    assert got_x.dtype == want_x.dtype == np.float32
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_y, want_y)

