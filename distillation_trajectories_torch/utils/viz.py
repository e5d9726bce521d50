"""Sample-grid images (port of the JAX package's ``utils/viz.py``).

The JAX package renders its grid through a matplotlib figure.  The port
writes the grid itself as an 8-bit RGB PNG with the standard library
(``zlib`` + ``struct``), one image pixel per PNG pixel, so the trainers need
no plotting package; ``read_png`` reads such files back, and the 8-bit
PNGs other writers make, without PIL.
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type: grey, RGB, grey + alpha, RGBA


def _unfilter_row(kind: int, row: bytearray, prior: bytes, bpp: int) -> None:
    """Undo one PNG row filter in place (``prior``: the row above, decoded)."""
    n = len(row)
    if kind == 1:  # Sub
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 0xFF
    elif kind == 2:  # Up
        for i in range(n):
            row[i] = (row[i] + prior[i]) & 0xFF
    elif kind == 3:  # Average
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif kind == 4:  # Paeth
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF
    elif kind != 0:
        raise ValueError(f"unknown PNG row filter {kind}")


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG of colour type 0, 2, 4 or 6 as the uint8
    array ``np.array(PIL.Image.open(path))`` gives: ``[H, W]`` for grey,
    ``[H, W, C]`` otherwise, alpha included.  Any other PNG raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: chunk {kind!r} is truncated or fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or compression or filtering or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}); only 8-bit non-interlaced types 0/2/4/6")
    c = _PNG_CHANNELS[colour]
    stride = w * c
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of pixel data, expected {h * (stride + 1)}")
    out = bytearray(h * stride)
    prior = bytes(stride)
    for y in range(h):
        start = y * (stride + 1)
        row = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter_row(raw[start], row, prior, c)
        out[y * stride:(y + 1) * stride] = row
        prior = row
    image = np.frombuffer(bytes(out), dtype=np.uint8).reshape(h, w, c)
    return image[..., 0] if c == 1 else image


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
