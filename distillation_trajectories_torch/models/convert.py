"""Carry U-Net weights and Adam state between the JAX package's layout and
the port.

JAX variables → port: the port's own copy of the mapping in
``distillation_trajectories_tpu/models/torch_port.py::
unet_torch_state_dict_from_variables``, with no flax: the JAX variables
arrive as a nested dict of numpy arrays (``{"params": …, "batch_stats":
…}``, e.g. from :func:`..training.checkpoints.variables_from_checkpoint`).

Conv kernels go HWIO → OIHW, Dense kernels (in, out) → (out, in), and
BatchNorm ``scale``/``mean``/``var`` become ``weight``/``running_mean``/
``running_var`` (with a zero ``num_batches_tracked``).  A leaf with no
mapping raises here; a key the model expects and the variables lack raises
in :func:`load_unet_variables` (``strict=True``).

Port → JAX variables: :func:`variables_from_unet_state_dict`, the inverse,
so checkpoints the port writes load in the JAX package.  Adam state:
``torch.optim.Adam``'s per-parameter ``step``/``exp_avg``/``exp_avg_sq``
against optax ``adam``'s state as ``flax.serialization.to_state_dict`` lays
it out, ``{"0": {"count", "mu", "nu"}, "1": {}}`` (``ScaleByAdamState`` then
the learning-rate scale's ``EmptyState``), with ``mu``/``nu`` in the params
layout.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

# Top-level flax Dense modules -> reference Sequential entries.
_DENSE_MAP = {
    "time_dense": "time_mlp.1",
    "cond_dense1": "cond_emb.0",
    "cond_dense2": "cond_emb.2",
}


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def unet_state_dict_from_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX U-Net variables (nested numpy dict) -> the port's state dict."""
    if "params" not in variables:
        raise KeyError("variables have no 'params' collection")
    state: Dict[str, torch.Tensor] = {}
    for key, val in _flatten(variables):
        col, *path, leaf = key
        arr = np.asarray(val, dtype=np.float32)
        name = "weight" if leaf == "kernel" else "bias"
        if col == "params" and len(path) == 1 and path[0] in _DENSE_MAP:
            state[f"{_DENSE_MAP[path[0]]}.{name}"] = _tensor(
                arr.T if leaf == "kernel" else arr
            )
        elif col == "params" and path == ["final"]:
            state[f"final.{name}"] = _tensor(
                arr.transpose(3, 2, 0, 1) if leaf == "kernel" else arr
            )
        elif len(path) == 2 and path[1] in ("conv1", "conv2", "residual_conv"):
            if col != "params":
                raise ValueError(f"no torch mapping for variable {key}")
            state[f"{path[0]}.{path[1]}.{name}"] = _tensor(
                arr.transpose(3, 2, 0, 1) if leaf == "kernel" else arr
            )
        elif len(path) == 2 and path[1] == "time_mlp" and col == "params":
            state[f"{path[0]}.time_mlp.{name}"] = _tensor(
                arr.T if leaf == "kernel" else arr
            )
        elif len(path) == 2 and path[1] in ("norm1", "norm2"):
            prefix = f"{path[0]}.{path[1]}"
            if col == "params" and leaf in ("scale", "bias"):
                state[f"{prefix}.{'weight' if leaf == 'scale' else 'bias'}"] = _tensor(arr)
            elif col == "batch_stats" and leaf in ("mean", "var"):
                tleaf = "running_mean" if leaf == "mean" else "running_var"
                state[f"{prefix}.{tleaf}"] = _tensor(arr)
                if leaf == "var":
                    state[f"{prefix}.num_batches_tracked"] = torch.zeros(
                        (), dtype=torch.int64
                    )
            else:
                raise ValueError(f"no torch mapping for variable {key}")
        else:
            raise ValueError(f"no torch mapping for variable {key}")
    return state


def load_unet_variables(model: torch.nn.Module, variables: Dict[str, Any]) -> torch.nn.Module:
    """Load JAX U-Net variables into ``model`` in place (``strict=True``:
    a missing or surplus key raises)."""
    model.load_state_dict(unet_state_dict_from_variables(variables), strict=True)
    return model


_DENSE_INVERSE = {v: k for k, v in _DENSE_MAP.items()}
_CONVS = ("conv1", "conv2", "residual_conv")


def _flax_leaf(name: str, value: torch.Tensor):
    """``(collection, path, numpy array)`` of one state-dict entry, or None
    for ``num_batches_tracked`` (flax keeps no counter)."""
    *mod, leaf = name.split(".")
    module = ".".join(mod)
    arr = value.detach().to(device="cpu", dtype=torch.float32)
    kernel = "kernel" if leaf == "weight" else "bias"
    if leaf == "num_batches_tracked":
        return None
    if module in _DENSE_INVERSE and leaf in ("weight", "bias"):
        return "params", (_DENSE_INVERSE[module], kernel), arr.T if leaf == "weight" else arr
    conv = module == "final" or (len(mod) == 2 and mod[1] in _CONVS)
    if conv and leaf in ("weight", "bias"):
        return "params", (*mod, kernel), arr.permute(2, 3, 1, 0) if leaf == "weight" else arr
    if len(mod) == 2 and mod[1] == "time_mlp" and leaf in ("weight", "bias"):
        return "params", (*mod, kernel), arr.T if leaf == "weight" else arr
    if len(mod) == 2 and mod[1] in ("norm1", "norm2"):
        flax_leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                     "running_mean": ("batch_stats", "mean"),
                     "running_var": ("batch_stats", "var")}.get(leaf)
        if flax_leaf is not None:
            return flax_leaf[0], (*mod, flax_leaf[1]), arr
    raise ValueError(f"no JAX mapping for state-dict entry {name!r}")


def _nest(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def variables_from_unet_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> JAX U-Net variables (nested float32 numpy
    dicts ``{"params": …, "batch_stats": …}``; ``batch_stats`` is empty
    for GroupNorm models, as in the JAX package)."""
    variables: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, value in state.items():
        leaf = _flax_leaf(name, value)
        if leaf is not None:
            col, path, arr = leaf
            _nest(variables[col], path, np.ascontiguousarray(arr.numpy()))
    return variables


def params_tree_from_named(named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors keyed by parameter name (Adam moments, EMA weights) -> a
    tree in the JAX params layout."""
    tree = variables_from_unet_state_dict(named)
    if tree["batch_stats"]:
        raise ValueError("parameter tree holds BatchNorm running statistics")
    return tree["params"]


def optax_adam_state(named_parameters: Iterable, state: Dict) -> Dict[str, Any]:
    """Adam state in optax ``adam``'s state-dict layout, from a model's
    ``named_parameters()`` and its ``torch.optim.Adam``'s ``state`` (zeros
    and count 0 before the first step, as ``tx.init`` gives)."""
    mu, nu, count = {}, {}, 0
    for name, p in named_parameters:
        st = state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        if "step" in st:
            count = int(st["step"])
    return {
        "0": {
            "count": np.array(count, dtype=np.int32),
            "mu": params_tree_from_named(mu),
            "nu": params_tree_from_named(nu),
        },
        "1": {},
    }


def load_optax_adam_state(
    model: torch.nn.Module, optimizer: torch.optim.Optimizer, opt_state: Dict[str, Any]
) -> None:
    """Set ``optimizer``'s Adam state from an optax ``adam`` state in
    state-dict layout (as checkpoints of either package hold it)."""
    adam = opt_state["0"]
    mu = unet_state_dict_from_variables({"params": adam["mu"]})
    nu = unet_state_dict_from_variables({"params": adam["nu"]})
    step = float(np.asarray(adam["count"]))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype).contiguous(),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype).contiguous(),
        }


_INCEPTION_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def inception_state_dict_from_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``InceptionV3Features`` variables (nested numpy dicts) -> the
    port's (torchvision-named) state dict: ``…/conv/kernel`` HWIO -> OIHW
    ``conv.weight``, ``…/bn/{scale,bias}`` -> ``bn.{weight,bias}``,
    ``batch_stats/…/bn/{mean,var}`` -> ``bn.running_{mean,var}``, and a zero
    ``num_batches_tracked`` per BatchNorm."""
    state: Dict[str, torch.Tensor] = {}
    for (col, *path, leaf), val in _flatten(variables):
        if (col, leaf) not in _INCEPTION_LEAVES:
            raise ValueError(f"no torch mapping for variable {(col, *path, leaf)}")
        arr = np.asarray(val, dtype=np.float32)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        module = ".".join(path)
        state[f"{module}.{_INCEPTION_LEAVES[(col, leaf)]}"] = _tensor(arr)
        if path[-1] == "bn":
            state[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state


def alexnet_lpips_state_dict_from_variables(variables: Dict[str, Any],
                                            lin_weights) -> Dict[str, torch.Tensor]:
    """JAX ``AlexFeatures`` variables (``params/conv{i}/{kernel,bias}``) and
    the five ``[C]`` LPIPS head weights -> the port's ``LPIPSAlex`` state
    dict (``net.features.{0,3,6,8,10}.*``, ``lin{i}.model.1.weight``)."""
    from ..metrics.lpips import _ALEX_CONVS

    state: Dict[str, torch.Tensor] = {}
    for i, (*_, index) in enumerate(_ALEX_CONVS):
        conv = variables["params"][f"conv{i}"]
        state[f"net.features.{index}.weight"] = _tensor(
            np.asarray(conv["kernel"], dtype=np.float32).transpose(3, 2, 0, 1))
        state[f"net.features.{index}.bias"] = _tensor(conv["bias"])
        w = np.asarray(lin_weights[i], dtype=np.float32).reshape(1, -1, 1, 1)
        state[f"lin{i}.model.1.weight"] = _tensor(w)
    return state
