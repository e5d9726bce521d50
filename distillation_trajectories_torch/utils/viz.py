"""Sample-grid images (port of the JAX package's ``utils/viz.py``).

The JAX package renders its grid through a matplotlib figure.  The port
writes the grid itself as an 8-bit RGB PNG with the standard library
(``zlib`` + ``struct``), one image pixel per PNG pixel, so the trainers need
no plotting package.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 4, padding: int = 2) -> np.ndarray:
    """Tile NHWC images into one grid image, ``nrow`` images per row."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    nrows = (n + nrow - 1) // nrow
    grid = np.zeros(
        (nrows * (h + padding) + padding, nrow * (w + padding) + padding, c),
        dtype=images.dtype,
    )
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[i]
    return grid


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an ``[H, W, 3]`` uint8 array as a PNG (no filtering)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected an RGB image, got {c} channels")

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(png)
    os.replace(tmp, path)


def save_image_grid(images, path: str, nrow: int = 4, denormalize: bool = True) -> None:
    """Save NHWC images (numpy or a tensor on any device) in [−1, 1] (or
    [0, 1] without ``denormalize``) as a grid PNG: clipped, tiled, rounded
    to 8 bits, one channel repeated to three."""
    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy()
    images = np.asarray(images, dtype=np.float32)
    if denormalize:
        images = (images + 1.0) / 2.0
    grid = make_grid(np.clip(images, 0.0, 1.0), nrow=nrow)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    write_png(path, np.round(grid * 255.0).astype(np.uint8))
