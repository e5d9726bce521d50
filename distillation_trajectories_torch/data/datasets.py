"""Data layer (port of ``distillation_trajectories_tpu/data/datasets.py``).

numpy readers of the raw MNIST idx files and CIFAR-10 python batches under
``config.data_dir``, a bilinear resize to ``config.image_size``, scaling to
[−1, 1], NHWC float32 batches.  When the dataset files are absent a
deterministic procedural stand-in is used (logged), bit-identical to the
JAX package's.  The loader's shuffle stream is the JAX loader's:
``shuffle_indices(n, seed * 1_000_003 + epoch)``.
"""

from __future__ import annotations

import gzip
import os
import pickle
import queue
import struct
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from .native import gather_f32, shuffle_indices


def _read_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx magic {magic} in {path}")
        return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int32)


def _find(*relpaths: str, root: str) -> Optional[str]:
    for rel in relpaths:
        p = os.path.join(root, rel)
        if os.path.exists(p):
            return p
    return None


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in, out]`` bilinear weights with half-pixel centres and, when
    downsampling, a triangle kernel widened by in/out (antialiasing) — the
    weights ``jax.image.resize(method="bilinear")`` builds, in float32."""
    inv_scale = 1.0 / (out_size / in_size)  # Python floats, as in JAX
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize_bilinear(images: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of an NHWC batch to ``(size, size)``, float32."""
    images = np.asarray(images, dtype=np.float32)
    if images.shape[1] == size and images.shape[2] == size:
        return images
    wh = _resize_weights(images.shape[1], size).astype(np.float64)
    ww = _resize_weights(images.shape[2], size).astype(np.float64)
    out = np.einsum("nhwc,hH,wW->nHWc", images.astype(np.float64), wh, ww, optimize=True)
    return out.astype(np.float32)


def _synthetic_dataset(
    n: int, size: int, channels: int, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic procedural stand-in when dataset files are absent:
    gaussian blobs on gradients, 10 pseudo-classes, uint8 NHWC."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    images = np.zeros((n, size, size, channels), dtype=np.float32)
    for i in range(n):
        k = labels[i]
        cx, cy = np.cos(2 * np.pi * k / 10) * 0.4, np.sin(2 * np.pi * k / 10) * 0.4
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (0.08 + 0.02 * (k % 3))))
        grad = 0.3 * (xx * np.cos(k) + yy * np.sin(k))
        base = blob + grad + 0.05 * rng.standard_normal((size, size))
        for c in range(channels):
            images[i, :, :, c] = base * (0.7 + 0.3 * np.cos(k + c))
    images = np.clip((images - images.min()) / (np.ptp(images) + 1e-8), 0, 1)
    return (images * 255).astype(np.uint8), labels


def load_mnist(data_dir: str, train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """MNIST from ``data_dir/MNIST/raw`` (plain or gzipped idx files); the
    test split stands in for absent train images, as in the JAX package."""
    root = os.path.join(data_dir, "MNIST", "raw")
    prefix = "train" if train else "t10k"
    img_path = _find(f"{prefix}-images-idx3-ubyte", f"{prefix}-images-idx3-ubyte.gz", root=root)
    lbl_path = _find(f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels-idx1-ubyte.gz", root=root)
    if img_path is None and train:
        img_path = _find("t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz", root=root)
        lbl_path = _find("t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz", root=root)
        if img_path is not None:
            print("[data] MNIST train images unavailable; using test split as "
                  "training data")
    if img_path is None or lbl_path is None:
        return None
    return _read_idx_images(img_path), _read_idx_labels(lbl_path)


def load_cifar10(data_dir: str, train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """CIFAR-10 from ``data_dir/cifar-10-batches-py`` (python pickles)."""
    root = os.path.join(data_dir, "cifar-10-batches-py")
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    images, labels = [], []
    for name in names:
        path = _find(name, root=root)
        if path is None:
            return None
        with open(path, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        images.append(batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.append(np.asarray(batch[b"labels"], dtype=np.int32))
    return np.concatenate(images), np.concatenate(labels)


def load_dataset(config, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Images in [−1, 1] float32 NHWC at ``config.image_size``, and labels."""
    name = config.dataset.lower()
    if name == "mnist":
        raw = load_mnist(config.data_dir, train)
    elif name == "cifar10":
        raw = load_cifar10(config.data_dir, train)
    else:
        raise ValueError(f"Dataset {config.dataset} not supported")
    if raw is None:
        print(f"[data] {config.dataset} blobs not found; using deterministic "
              "synthetic stand-in dataset")
        images, labels = _synthetic_dataset(
            10000 if train else 2000, config.image_size, config.channels,
            seed=0 if train else 1,
        )
    else:
        images, labels = raw
    images = resize_bilinear(images, config.image_size)
    if images.shape[-1] != config.channels:
        if images.shape[-1] == 1:
            images = np.repeat(images, config.channels, axis=-1)
        else:
            images = images[..., : config.channels]
    images = images / 255.0 * 2.0 - 1.0
    return images.astype(np.float32), labels


class DataLoader:
    """Epoch-reshuffled NHWC float32 batches with drop-last semantics; a
    background thread prefetches up to ``prefetch`` batches."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2):
        self.images = np.ascontiguousarray(images, dtype=np.float32)
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.images) // self.batch_size

    def epoch_indices(self, n_batches: Optional[int] = None) -> np.ndarray:
        """Advance one epoch and return its batch indices ``[n_batches, B]``
        — the iterator's batches of that epoch."""
        self._epoch += 1
        idx = self._epoch_perm()
        nb = len(self) if n_batches is None else min(n_batches, len(self))
        return idx[: nb * self.batch_size].reshape(nb, self.batch_size).astype(np.int32)

    def _epoch_perm(self) -> np.ndarray:
        n = len(self.images)
        if self.shuffle:
            return shuffle_indices(n, self.seed * 1_000_003 + self._epoch)
        return np.arange(n, dtype=np.int64)

    def _epoch_batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._epoch_perm()
        for i in range(len(self)):
            sel = idx[i * self.batch_size : (i + 1) * self.batch_size]
            yield gather_f32(self.images, sel), self.labels[sel]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        self._epoch += 1
        if self.prefetch <= 0:
            yield from self._epoch_batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            # Every producer exception reaches the consumer, which would
            # otherwise wait on q.get() forever.
            try:
                for batch in self._epoch_batches():
                    if not put(batch):
                        return
                put(done)
            except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # A consumer that stops early (limit_batches_per_epoch) closes
            # the generator: release the producer and wait for it.
            stop.set()
            thread.join()


def get_data_loader(config, train: bool = True, seed: int = 0) -> DataLoader:
    """Training data loader."""
    images, labels = load_dataset(config, train=train)
    return DataLoader(images, labels, config.batch_size, shuffle=True, seed=seed)


def get_real_images(config, num_images: int = 100) -> np.ndarray:
    """The first ``num_images`` test images, for evaluation."""
    images, _ = load_dataset(config, train=False)
    return images[:num_images]
