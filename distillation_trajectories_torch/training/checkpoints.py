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

The sharded lane (JAX ``training/checkpoints.py:236-353``, orbax there)
writes ``model_epoch_{e}.dcp/`` with ``torch.distributed.checkpoint``:
every rank writes its own shards of a model partitioned by
``parallel.shard_train_state``, into a temporary directory renamed once
all have finished, with ``{"epoch", "extra"}`` in a ``.meta.json``
sidecar beside it.  Read back without a target it needs no topology and
gives the msgpack payload.  :func:`available_epochs` and
:func:`load_checkpoint` take either format.  A JAX ``.orbax`` directory
cannot be read without JAX: its route into the port is JAX's
``scripts/export_reference_checkpoint.py``, then the port's
``import_reference_checkpoint``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import msgpack
import numpy as np
import torch

from ..models.convert import (
    optax_adam_state,
    params_tree_from_named,
    variables_from_unet_state_dict,
)
from ..parallel.collectives import (
    gather_named,
    gather_optimizer_state,
    gather_state_dict,
    sharded_state_names,
)
from ..parallel.distributed import barrier, is_main_process

CKPT_RE = re.compile(r"model_epoch_(\d+)\.(msgpack|pt)$")
SHARDED_CKPT_RE = re.compile(r"model_epoch_(\d+)\.dcp$")
ORBAX_RE = re.compile(r"model_epoch_(\d+)\.orbax$")

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_CHUNK_BYTES = 2**30


def checkpoint_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"model_epoch_{epoch}.msgpack")


def available_epochs(directory: str):
    """All epochs with checkpoints in ``directory``, ascending: msgpack
    files and complete sharded directories alike."""
    if not os.path.isdir(directory):
        return []
    return sorted({int(m.group(1)) for m in (CKPT_RE.search(name) for name in os.listdir(directory))
                   if m} | set(available_epochs_sharded(directory)))


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


def _orbax_route(directory: str) -> str:
    names = [n for n in os.listdir(directory) if ORBAX_RE.search(n)] if os.path.isdir(directory) else []
    if not names:
        return ""
    return (f"; {directory} holds JAX orbax checkpoints ({', '.join(sorted(names))}), which "
            "need JAX to read: export one with the JAX package's "
            "scripts/export_reference_checkpoint.py, then bring it in with "
            "python -m distillation_trajectories_torch.scripts.import_reference_checkpoint")


def load_checkpoint(directory: str, epoch: Optional[int] = None) -> Dict[str, Any]:
    """Load ``model_epoch_{epoch}`` (the latest when ``epoch`` is None) as
    a payload dict of numpy arrays: the msgpack file, else the sharded
    directory of that epoch."""
    if epoch is None:
        epoch = latest_epoch(directory)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints found in {directory}{_orbax_route(directory)}")
    path = checkpoint_path(directory, epoch)
    if not os.path.exists(path):
        if epoch in available_epochs_sharded(directory):
            return load_checkpoint_sharded(directory, epoch)
        raise FileNotFoundError(f"{path} not found{_orbax_route(directory)}")
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
    queued on the same stream before it.  A model sharded over a mesh is
    gathered whole first (every rank of the mesh takes part)."""
    if getattr(model, "mesh", None) is not None:
        return _gathered_snapshot(model, optimizer, ema)
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


def _gathered_snapshot(model, optimizer=None, ema=None) -> Dict[str, Any]:
    state = gather_state_dict(model)
    snap = {"state": state}
    if optimizer is not None:
        adam = gather_optimizer_state(model, optimizer)
        named = [(name, state[name]) for name, _ in model.named_parameters()]
        snap["adam"] = (named, {t: adam[name] for name, t in named})
    if ema is not None:
        snap["ema"] = gather_named(model, ema)
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
    given, EMA weights (by parameter name) when ``ema`` is.  A sharded
    model is gathered on every rank and written by rank 0 alone."""
    snap = _snapshot(model, optimizer, ema)
    path = checkpoint_path(directory, epoch)
    if is_main_process():
        _write(directory, epoch, _payload(epoch, snap, extra))
    return path


def save_epoch(writer, config, directory: str, epoch: int, model: torch.nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None,
               ema: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """A trainer's checkpoint of ``epoch``: the sharded lane when
    ``config.checkpoint_sharded`` (every rank writes its shards, now),
    else ``writer``'s async msgpack save."""
    if config.checkpoint_sharded:
        save_checkpoint_sharded(directory, epoch, model, optimizer=optimizer, ema=ema)
    else:
        writer.save(directory, epoch, model, optimizer=optimizer, ema=ema)


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
        """Snapshot now, write in the background; a sharded model is
        gathered on every rank and written by rank 0 alone."""
        snap = _snapshot(model, optimizer, ema)
        if is_main_process():
            self._enqueue(lambda: _write(directory, epoch, _payload(epoch, snap, extra)))

    def submit(self, fn, *args) -> None:
        """Run a host task (e.g. fetching and saving a sample grid) on the
        pool, under the same error contract as saves; rank 0's alone."""
        if is_main_process():
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


# --- The sharded lane ----------------------------------------------------


def sharded_checkpoint_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"model_epoch_{epoch}.dcp")


def available_epochs_sharded(directory: str):
    """Epochs of the complete sharded checkpoints in ``directory`` (a
    directory is complete once renamed into place with its ``.metadata``;
    a partial one is never listed)."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1))
        for m in (SHARDED_CKPT_RE.search(n) for n in os.listdir(directory))
        if m and os.path.exists(os.path.join(directory, m.group(0), ".metadata"))
    )


def _sharded_entries(model, optimizer=None, ema=None) -> Dict[str, torch.Tensor]:
    """The flat state a sharded checkpoint holds: ``state/<name>``,
    ``adam/<name>/{exp_avg,exp_avg_sq}``, ``adam/step`` and
    ``ema/<name>``.  Entries sharded over the mesh's model axis are
    ``DTensor``s of this rank's slice (dim 0), replicated over data."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = getattr(model, "mesh", None)
    sharded = sharded_state_names(model) if mesh is not None else {}
    placements = tuple(Shard(0) if name == "model" else Replicate()
                       for name in (mesh.mesh_dim_names if mesh is not None else ()))

    def put(name, t):
        t = t.detach().contiguous()
        if name not in sharded:
            return t
        return DTensor.from_local(t, mesh, placements, run_check=False)

    out = {f"state/{k}": put(k, v) for k, v in model.state_dict().items()}
    if optimizer is not None:
        for name, p in model.named_parameters():
            st = optimizer.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"adam/{name}/{k}"] = put(name, st.get(k, torch.zeros_like(p)))
            if "step" in st:
                out["adam/step"] = torch.as_tensor(st["step"]).detach().float().cpu()
        out.setdefault("adam/step", torch.zeros(()))
    if ema is not None:
        out.update({f"ema/{k}": put(k, v) for k, v in ema.items()})
    return out


def abstract_target(model, optimizer=None, ema=None) -> Dict[str, torch.Tensor]:
    """The skeleton of :func:`save_checkpoint_sharded`'s entries for
    ``model`` on its mesh, for :func:`load_checkpoint_sharded` to fill
    each rank's shards in place (no gather, no scatter)."""
    return {k: torch.empty_like(v) for k, v in _sharded_entries(model, optimizer, ema).items()}


def save_checkpoint_sharded(directory: str, epoch: int, model: torch.nn.Module,
                            optimizer: Optional[torch.optim.Optimizer] = None,
                            ema: Optional[Dict[str, torch.Tensor]] = None,
                            extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``{directory}/model_epoch_{epoch}.dcp/`` from every rank of
    ``model``'s mesh (or from this process alone): the same content as
    :func:`save_checkpoint` (weights and statistics, the Adam state when
    ``optimizer`` is given, the EMA), each rank writing its own shards and
    nothing gathered.  The directory is written under a temporary name and
    renamed when every rank has finished; ``{"epoch", "extra"}`` go into
    ``model_epoch_{epoch}.dcp.meta.json`` beside it."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(sharded_checkpoint_path(directory, epoch))
    tmp = path + ".tmp"
    if is_main_process():
        os.makedirs(directory, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
    barrier()
    entries = _sharded_entries(model, optimizer, ema)
    dcp.save(entries, checkpoint_id=tmp, no_dist=not dist.is_initialized())
    barrier()
    if is_main_process():
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        with open(path + ".meta.json", "w") as f:
            json.dump({"epoch": epoch, "extra": extra or {}}, f)
    barrier()
    return path


def load_checkpoint_sharded(directory: str, epoch: Optional[int] = None,
                            target: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """Read a sharded checkpoint (the latest when ``epoch`` is None).

    With ``target`` (:func:`abstract_target`), every rank of the mesh
    fills its shards of it in place; it is returned with ``epoch`` (and
    ``extra``) from the sidecar.  Without, this
    process alone reads the whole tree, whatever mesh wrote it, and gets
    the msgpack payload (``epoch``, ``params``, ``batch_stats``, and
    ``opt_state``, ``ema_params`` and ``extra`` where saved)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    if epoch is None:
        epochs = available_epochs_sharded(directory)
        if not epochs:
            raise FileNotFoundError(f"no sharded checkpoints in {directory}")
        epoch = epochs[-1]
    path = os.path.abspath(sharded_checkpoint_path(directory, epoch))
    extra, meta_path = None, path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            side = json.load(f)
        epoch, extra = side.get("epoch", epoch), side.get("extra")
    if target is not None:
        dcp.load(target, checkpoint_id=path)
        return {**target, "epoch": epoch, **({"extra": extra} if extra else {})}
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
            for k, m in meta.items() if isinstance(m, TensorStorageMetadata)}
    dcp.load(flat, checkpoint_id=path, no_dist=True)
    snap = {"state": {k[len("state/"):]: v for k, v in flat.items() if k.startswith("state/")}}
    adam = {k[len("adam/"):]: v for k, v in flat.items() if k.startswith("adam/")}
    if adam:
        names = [k[:-len("/exp_avg")] for k in adam if k.endswith("/exp_avg")]
        named = [(n, snap["state"][n]) for n in names]
        snap["adam"] = (named, {snap["state"][n]: {"step": adam["step"], "exp_avg": adam[f"{n}/exp_avg"],
                                                   "exp_avg_sq": adam[f"{n}/exp_avg_sq"]}
                                for n in names})
    ema = {k[len("ema/"):]: v for k, v in flat.items() if k.startswith("ema/")}
    if ema:
        snap["ema"] = ema
    return _payload(epoch, snap, extra)
