"""A parameter audit of the port against the JAX package, read from source.

For every public module-level function of every JAX module that the port
carries (``test_torch_public_names.py`` lists what it leaves out), each JAX
parameter name is a parameter of the port's function of the same name, or
an entry of ``RENAMED`` below, which gives the idiom that replaces it.  And
every ``Config`` field that some JAX module or CLI reads (an attribute or a
``getattr`` of that name in its code) is read by some module of the port.
"""

import ast
import importlib
import inspect
import os

import pytest

from test_torch_public_names import JAX_ROOT, MODULE_NOT_PORTED, _modules

REPO = os.path.dirname(JAX_ROOT)
PORT_ROOT = os.path.join(REPO, "distillation_trajectories_torch")

# JAX parameter names the port's functions do not take, each with the idiom
# that replaces it.
RENAMED = {
    # Weights: the port passes the torch module, which holds its parameters
    # and buffers, where JAX passes flax variable trees beside the module.
    "variables": "the nn.Module holds its weights",
    "teacher_variables": "the teacher nn.Module holds its weights",
    "student_variables": "the student nn.Module holds its weights",
    "params": "the nn.Module holds its parameters (save_checkpoint, param_count)",
    "batch_stats": "the nn.Module holds its BatchNorm buffers (save_checkpoint)",
    "tree": "the nn.Module is the tree (shard_params, abstract_target)",
    "model": "the train step takes the TrainState, which holds the model",
    "student_model": "the distill step takes the student's TrainState, which holds it",
    # Optimizer: optax's transformation and state become one torch optimizer.
    "tx": "the torch optimizer, built into the TrainState",
    "opt_state": "the torch optimizer (save_checkpoint's optimizer)",
    "ema_params": "save_checkpoint's ema, a state dict",
    # Randomness: torch cannot reproduce threefry, so draws are injected.
    "key": "an injected generator or draw source (draws=, generator=, noise=)",
    # Devices: torch.distributed ranks in place of a JAX device list or mesh.
    "devices": "torch.distributed's ranks and the device type",
    "mesh": "the mesh comes from the Config and torch.distributed",
    # XLA and Pallas machinery with no PyTorch counterpart.
    "compile_workers": "XLA's ahead-of-time compile pool; PyTorch runs eagerly",
    "precompile": "XLA's ahead-of-time compile pool; PyTorch runs eagerly",
    "interpret": "Pallas interpret mode; on a CPU tensor the wrapper runs the plain version",
    "_prebuilt": "a private hand-off of XLA executables between JAX trainers",
    # The samplers' fused-or-unfused switch: the port's one tail is both.
    "use_pallas": ("the port's fused cfg_engine_update computes JAX's unfused tail too "
                   "(bit-equal on the CPU), so there is nothing to pick"),
}


def _jax_functions(module):
    path = os.path.join(JAX_ROOT, *module.split(".")) + ".py"
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            a = node.args
            names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
            names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
            yield node.name, names


def _audited_modules():
    return [m for m in _modules() if MODULE_NOT_PORTED.get(m) != "*"
            and any(True for _ in _jax_functions(m))]


def _missing(module):
    """``{JAX parameter name: [function, ...]}`` of the port's module."""
    port = importlib.import_module(f"distillation_trajectories_torch.{module}")
    skip = MODULE_NOT_PORTED.get(module, set())
    out = {}
    for name, params in _jax_functions(module):
        if name in skip:
            continue
        have = set(inspect.signature(getattr(port, name)).parameters)
        for p in params:
            if p not in have:
                out.setdefault(p, []).append(name)
    return out


@pytest.mark.parametrize("module", _audited_modules())
def test_jax_parameters_are_the_ports(module):
    unexplained = {p: fns for p, fns in _missing(module).items() if p not in RENAMED}
    assert not unexplained, f"{module}: the port lacks these JAX parameters: {unexplained}"


def test_every_rename_is_used_and_has_a_reason():
    used = set()
    for module in _audited_modules():
        used |= set(_missing(module))
    assert not set(RENAMED) - used, f"stale entries: {sorted(set(RENAMED) - used)}"
    assert all(reason.strip() for reason in RENAMED.values())


def _config_fields():
    tree = ast.parse(open(os.path.join(JAX_ROOT, "config.py")).read())
    (cls,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "Config"]
    return [s.target.id for s in cls.body if isinstance(s, ast.AnnAssign)]


def _names_read(*roots):
    """Attribute names and constant ``getattr``/``hasattr`` names in the code
    of the Python files under ``roots`` (docstrings and comments aside)."""
    out = set()
    for root in roots:
        paths = [root] if root.endswith(".py") else [
            os.path.join(d, f) for d, _, files in os.walk(root) for f in files if f.endswith(".py")]
        for path in paths:
            for node in ast.walk(ast.parse(open(path).read())):
                if isinstance(node, ast.Attribute):
                    out.add(node.attr)
                elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                      and node.func.id in ("getattr", "hasattr") and len(node.args) >= 2
                      and isinstance(node.args[1], ast.Constant)):
                    out.add(node.args[1].value)
    return out


def test_config_fields_jax_reads_are_read_by_the_port():
    jax_reads = _names_read(JAX_ROOT, os.path.join(REPO, "scripts"),
                            os.path.join(REPO, "bench.py"), os.path.join(REPO, "run_analysis.py"))
    port_reads = _names_read(PORT_ROOT)
    fields = [f for f in _config_fields() if f in jax_reads]
    assert "pallas_cfg_update" in fields and "samples_figure_size" in fields
    unread = [f for f in fields if f not in port_reads]
    assert not unread, f"Config fields JAX reads and the port does not: {unread}"
