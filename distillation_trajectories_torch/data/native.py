"""ctypes binding of the native host data pipeline (``native/dtt_data.cpp``).

The port builds the shared object from the repository's source with ``g++``
into ``build/native/`` on first use and never writes into ``native/``.
Epoch shuffles come from its ``std::mt19937_64`` Fisher-Yates stream, the
stream the JAX package uses when its own build succeeds; no numpy fallback
exists here, because a different permutation would silently change every
batch, so a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "dtt_data.cpp")
LIBRARY = os.path.join(_ROOT, "build", "native", "libdtt_data.so")

_lock = threading.Lock()
_lib = None


def _build() -> None:
    """Compile into a per-process temporary name, then rename: parallel
    test workers may build at once."""
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SOURCE, "-lpthread"],
            check=True, capture_output=True, text=True,
        )
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: cannot build {SOURCE}") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {SOURCE} failed:\n{e.stderr}") from e
    os.replace(tmp, LIBRARY)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first when missing or older than its
    source; raises when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(LIBRARY) or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE):
            _build()
        lib = ctypes.CDLL(LIBRARY)
        lib.dtt_shuffle_indices.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint64,
        ]
        lib.dtt_shuffle_indices.restype = None
        lib.dtt_gather_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ]
        lib.dtt_gather_normalize.restype = None
        lib.dtt_gather_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ]
        lib.dtt_gather_f32.restype = None
        _lib = lib
        return lib


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """Deterministic epoch permutation of ``range(n)`` (Fisher-Yates on
    ``std::mt19937_64(seed)``)."""
    idx = np.arange(n, dtype=np.int64)
    get_lib().dtt_shuffle_indices(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
    )
    return idx


def _check_rows(idx: np.ndarray, n: int) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError("gather index out of range")


def gather_normalize(images_u8: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Multi-threaded gather of uint8 images by index, normalized to
    float32 in [−1, 1] (``u8 / 255 * 2 - 1``)."""
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    _check_rows(idx, images_u8.shape[0])
    out = np.empty((idx.shape[0],) + images_u8.shape[1:], dtype=np.float32)
    get_lib().dtt_gather_normalize(
        images_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.shape[0],
        int(np.prod(images_u8.shape[1:])),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def gather_f32(images_f32: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Multi-threaded gather of float32 images by index."""
    images_f32 = np.ascontiguousarray(images_f32, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    _check_rows(idx, images_f32.shape[0])
    out = np.empty((idx.shape[0],) + images_f32.shape[1:], dtype=np.float32)
    get_lib().dtt_gather_f32(
        images_f32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.shape[0],
        int(np.prod(images_f32.shape[1:])),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
