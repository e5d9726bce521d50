"""Checkpoints as ``model_epoch_{e}.msgpack`` files, read and written.

Port of ``distillation_trajectories_tpu/training/checkpoints.py``: the same
filename contract, latest-epoch discovery and payload keys (``epoch``,
``params``, ``batch_stats``, ``opt_state``, ``ema_params``, ``extra``), in
flax's msgpack format, encoded and decoded with the ``msgpack`` package
alone.  Flax packs an ndarray as ext type 1 and a numpy scalar as ext type 3,
each holding a msgpack ``(shape, dtype_name, buffer)`` triple; arrays above
2**30 bytes are split into ``__msgpack_chunked_array__`` dicts (read here;
the port's arrays never reach that size, and writing one raises).  Trees are
in the JAX package's layout (:mod:`..models.convert`), so either package
reads the other's checkpoints.  Files are written to a temporary name and
renamed, so a half-written file never shows under its final name.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Any, Dict, Optional

import msgpack
import numpy as np
import torch

from ..models.convert import (
    optax_adam_state,
    params_tree_from_named,
    variables_from_unet_state_dict,
)

CKPT_RE = re.compile(r"model_epoch_(\d+)\.(msgpack|pt)$")

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_CHUNK_BYTES = 2**30


def checkpoint_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"model_epoch_{epoch}.msgpack")


def available_epochs(directory: str):
    """All epochs with checkpoints in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    epochs = {
        int(m.group(1))
        for m in (CKPT_RE.search(name) for name in os.listdir(directory))
        if m
    }
    return sorted(epochs)


def latest_epoch(directory: str) -> Optional[int]:
    """Latest checkpoint epoch by filename parse."""
    epochs = available_epochs(directory)
    return epochs[-1] if epochs else None


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the bit patterns to float32.
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()))
    return arr.reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.nbytes > _MAX_CHUNK_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes needs flax's chunked encoding")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ext_pack(obj):
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(obj))
    if isinstance(obj, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    raise TypeError(f"cannot serialize {type(obj).__name__} in a checkpoint")


def msgpack_serialize(tree: Dict[str, Any]) -> bytes:
    """Encode a tree of dicts, numpy arrays and Python scalars as flax's
    ``serialization.msgpack_serialize`` does."""
    return msgpack.packb(tree, default=_ext_pack, strict_types=True, use_bin_type=True)


def msgpack_restore(encoded: bytes) -> Dict[str, Any]:
    """Decode flax ``serialization.msgpack_serialize`` bytes to numpy trees."""
    return _unchunk(msgpack.unpackb(encoded, ext_hook=_ext_hook, raw=False))


def load_checkpoint(directory: str, epoch: Optional[int] = None) -> Dict[str, Any]:
    """Load ``model_epoch_{epoch}.msgpack`` (the latest when ``epoch`` is
    None) as a payload dict of numpy arrays."""
    if epoch is None:
        epoch = latest_epoch(directory)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints found in {directory}")
    path = checkpoint_path(directory, epoch)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found (orbax sharded checkpoints are not ported yet)"
        )
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def variables_from_checkpoint(payload: Dict[str, Any]) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` variables from a checkpoint payload."""
    variables = {"params": payload["params"]}
    if "batch_stats" in payload:
        variables["batch_stats"] = payload["batch_stats"]
    return variables


def _snapshot(model, optimizer=None, ema=None) -> Dict[str, Any]:
    """Device-side copies of everything a checkpoint holds: the caller's
    next train step updates the originals in place, and the copies are
    queued on the same stream before it."""
    clone = lambda t: t.detach().clone()
    snap = {"state": {k: clone(v) for k, v in model.state_dict().items()}}
    if optimizer is not None:
        snap["adam"] = (
            list(model.named_parameters()),
            {p: {k: clone(v) for k, v in optimizer.state.get(p, {}).items()}
             for _, p in model.named_parameters()},
        )
    if ema is not None:
        snap["ema"] = {k: clone(v) for k, v in ema.items()}
    return snap


def _payload(epoch: int, snap: Dict[str, Any], extra=None) -> Dict[str, Any]:
    variables = variables_from_unet_state_dict(snap["state"])
    payload = {"epoch": epoch, "params": variables["params"],
               "batch_stats": variables["batch_stats"]}
    if "adam" in snap:
        payload["opt_state"] = optax_adam_state(*snap["adam"])
    if "ema" in snap:
        payload["ema_params"] = params_tree_from_named(snap["ema"])
    if extra:
        payload["extra"] = extra
    return payload


def _write(directory: str, epoch: int, payload: Dict[str, Any]) -> str:
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, epoch)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(tmp, path)
    return path


def save_checkpoint(directory: str, epoch: int, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    ema: Optional[Dict[str, torch.Tensor]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``{directory}/model_epoch_{epoch}.msgpack``: the model's
    weights and BatchNorm statistics, the Adam state when ``optimizer`` is
    given, EMA weights (by parameter name) when ``ema`` is."""
    return _write(directory, epoch, _payload(epoch, _snapshot(model, optimizer, ema), extra))


def _raise_first(futures) -> None:
    """Read every future's result, then raise the first failure (later
    ones are printed)."""
    errors = []
    for fut in futures:
        try:
            fut.result()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
    if errors:
        for extra_exc in errors[1:]:
            print(f"[checkpoints] additional async save failure: {extra_exc!r}")
        raise errors[0]


class AsyncCheckpointWriter:
    """Overlap checkpoint fetch + serialization with training.

    ``save()`` snapshots with device-side clones (so the caller may go on
    training at once) and hands the copy to host, encoding and writing to a
    thread pool.  A failed save or task raises on the next ``save()``,
    ``submit()`` or ``flush()``; ``flush()`` waits for every pending one
    first, and ``close()`` shuts the pool down even after a failure.
    """

    def __init__(self, max_workers: int = 2):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="ckpt"
        )
        self._futures = []

    def _enqueue(self, fn, *args) -> None:
        done, pending = [], []
        for f in self._futures:  # one done() call per future
            (done if f.done() else pending).append(f)
        self._futures = pending
        self._futures.append(self._pool.submit(fn, *args))
        _raise_first(done)

    def save(self, directory: str, epoch: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None,
             ema: Optional[Dict[str, torch.Tensor]] = None,
             extra: Optional[Dict[str, Any]] = None) -> None:
        snap = _snapshot(model, optimizer, ema)
        self._enqueue(lambda: _write(directory, epoch, _payload(epoch, snap, extra)))

    def submit(self, fn, *args) -> None:
        """Run a host task (e.g. fetching and saving a sample grid) on the
        pool, under the same error contract as saves."""
        self._enqueue(fn, *args)

    def flush(self) -> None:
        futures, self._futures = self._futures, []
        concurrent.futures.wait(futures)
        _raise_first(futures)

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)
