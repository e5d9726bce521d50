"""The JAX package's compiled programs and their lanes in the port.

Every ``jax.jit`` site of ``distillation_trajectories_tpu/`` (and the
``lax.scan`` of ``editing/core.py``, the one scan a caller runs outside a
jitted maker) is read from the sources as text, with the function that
holds it, and must have an entry in :data:`LANES`:

* ``captured``: the port runs the program as a CUDA graph on the card
  (``utils/graphs.py``), replayed for every call after its warm-up; the
  entry names the port callable that does;
* ``eager``: the port runs it eagerly, for the reason the entry gives
  (it runs once or a few times a run, so a capture would not be replayed;
  its collectives run inside it; or it is the per-batch lane), and names
  the port callable that runs it.

A new jit site in the JAX package fails :func:`test_every_jit_site_has_a_lane`
until its lane is decided here.  Imports neither JAX nor the JAX package.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "distillation_trajectories_tpu")
PORT = "distillation_trajectories_torch"

ONE_OFF = "runs once or a few times a run, so a capture would not be replayed"

# "path:line" of the site -> (the function holding it, lane, port callable
# relative to the port package, why).
LANES = {
    "trajectories/engine.py:165": (
        "make_paired_trajectory_fn", "captured", "trajectories.engine.make_paired_trajectory_fn",
        "the paired chain, behind utils.graphs.CapturedCall"),
    "trajectories/engine.py:206": (
        "make_batch_trajectory_fn", "captured", "trajectories.engine.make_batch_trajectory_fn",
        "the batch chain, behind utils.graphs.CapturedCall"),
    "trajectories/engine.py:238": (
        "make_sweep_trajectory_fn", "captured", "trajectories.engine.make_sweep_trajectory_fn",
        "the sweep chain, behind utils.graphs.CapturedCall"),
    "trajectories/manager.py:82": (
        "TrajectoryManager._pair_fn", "captured", "trajectories.manager.TrajectoryManager._pairs",
        "the manager's paired chains, through make_paired_trajectory_fn"),
    "metrics/fid.py:286": (
        "make_sample_fn", "captured", "metrics.fid.make_sample_fn",
        "the FID sampler's chain, behind utils.graphs.CapturedCall"),
    "training/teacher.py:90": (
        "make_grid_fn.grid_fn", "captured", "training.teacher.make_grid_fn",
        "the sample grid's chain (sampling.make_loop_fn)"),
    "training/students.py:186": (
        "_build_student.grid_fn", "captured", "training.teacher.make_grid_fn",
        "each student's sample grid, the teacher's grid maker"),
    "training/state.py:272": (
        "make_teacher_epoch_fn.epoch_fn", "captured", "training.state.make_teacher_epoch_fn",
        "the teacher's epoch lane: one graph replayed a batch"),
    "training/state.py:403": (
        "make_distill_epoch_fn._epoch", "captured", "training.state.make_distill_epoch_fn",
        "the distillation epoch lane: one graph replayed a batch"),
    "training/state.py:470": (
        "make_multi_distill_epoch_fn._epoch", "captured",
        "training.state.make_multi_distill_epoch_fn",
        "the student group's epoch lane: one graph replayed a batch"),
    "training/progressive.py:148": (
        "make_progressive_distill_step._step", "captured",
        "training.progressive.make_progressive_epoch_fn",
        "the progressive round's epoch lane: one graph replayed a batch"),
    "editing/core.py:72": (
        "denoise_with_trajectory", "eager", "editing.core.denoise_with_trajectory",
        f"a scan its caller runs outside a maker: {ONE_OFF}"),
    "editing/latent_manipulation.py:113": (
        "find_semantic_directions", "eager", "editing.latent_manipulation.find_semantic_directions",
        f"one batch of direction samples a call: {ONE_OFF}"),
    "analysis/noise_prediction.py:165": (
        "analyze_noise_prediction.one_timestep", "eager",
        "analysis.noise_prediction.noise_prediction_metrics",
        f"one forward pair a timestep of the analysis: {ONE_OFF}"),
    "metrics/fid.py:46": (
        "InceptionModel.__init__._features", "eager", "metrics.fid.InceptionModel.features_device",
        f"two batches a model at the CLI's 50 samples: {ONE_OFF}"),
    "models/quantized.py:369": (
        "calibrate_activation_scales.one", "eager", "models.quantized.calibrate_activation_scales",
        f"the int8 calibration pass: {ONE_OFF}"),
    "trajectories/engine.py:262": (
        "_sweep_inputs", "eager", "trajectories.engine._sweep_inputs",
        f"the sweep's draws, once a sweep: {ONE_OFF}"),
    "training/checkpoints.py:113": (
        "AsyncCheckpointWriter._device_copy", "eager", "training.checkpoints._snapshot",
        f"the device copy of a checkpoint, once a save: {ONE_OFF}"),
    "models/unet.py:384": (
        "make_init_fn", "eager", "models.make_unet", f"an initialiser: {ONE_OFF}"),
    "training/state.py:86": (
        "make_state_init_fn", "eager", "training.state.create_train_state",
        f"an initialiser: {ONE_OFF}"),
    "models/inception.py:232": (
        "create_inception", "eager", "models.inception.create_inception",
        f"an initialiser: {ONE_OFF}"),
    "training/state.py:217": (
        "make_teacher_train_step", "eager", "training.state.make_teacher_train_step",
        "the per-batch lane: JAX's lane off the default on one device, and the mesh "
        "lane, whose gloo collectives cannot be captured"),
    "training/state.py:305": (
        "make_distill_train_step", "eager", "training.state.make_distill_train_step",
        "the per-batch lane: JAX's lane off the default on one device, and the mesh "
        "lane, whose gloo collectives cannot be captured"),
    "metrics/trajectory_metrics.py:45": (
        "_metrics_core", "eager", "metrics.trajectory_metrics.batch_metrics_core",
        "vectorised over the samples: one call per size and scale"),
    "trajectories/engine.py:241": (
        "_batch_metrics", "eager", "metrics.trajectory_metrics.batch_metrics_core",
        "vectorised over the samples: one call per size and scale"),
    "metrics/lpips.py:84": (
        "LPIPSAlex.__init__._dist", "eager", "metrics.lpips.LPIPSAlex.forward",
        "no CLI calls it"),
    "parallel/spatial.py:178": (
        "make_spatial_eval_fn", "eager", "parallel.spatial.make_spatial_eval_fn",
        "its halo all-gathers run inside the forward"),
    "ops/cfg_update.py:46": (
        "_cfg_engine_update_impl", "eager", "ops.cfg_update.cfg_engine_update_row",
        "one kernel launch, the Triton kernel's: the captured chains replay it"),
    "models/unet.py:121": (
        "upsample_bilinear_x2", "eager", "models.unet.DenseLayout.up",
        "a helper inside the forward: F.interpolate in its caller's lane"),
}


def _sites():
    """``{"path:line": holding function}`` of every ``jax.jit`` reference in
    the JAX package's code (strings and comments aside), and of the
    ``lax.scan`` in ``editing/core.py``."""
    found = {}
    for dirpath, _, files in os.walk(JAX_ROOT):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, JAX_ROOT).replace(os.sep, "/")
            with open(path) as f:
                tree = ast.parse(f.read())

            def walk(node, holders):
                for child in ast.iter_child_nodes(node):
                    inner = holders
                    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                        inner = holders + [child.name]
                    if isinstance(child, ast.Attribute):
                        text = ast.unparse(child)
                        if text == "jax.jit" or (rel == "editing/core.py"
                                                 and text in ("jax.lax.scan", "lax.scan")):
                            found[f"{rel}:{child.lineno}"] = ".".join(holders) or "<module>"
                    walk(child, inner)

            walk(tree, [])
    return found


SITES = _sites()


def _port_callable(dotted):
    """The port object at ``dotted`` (a module path, then attributes)."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join([PORT, *parts[:i]]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def test_every_jit_site_has_a_lane():
    assert len(SITES) >= 29
    assert sorted(set(SITES) - set(LANES)) == [], "a JAX jit site without a lane in the port"
    assert sorted(set(LANES) - set(SITES)) == [], "a lane for a site the JAX package lacks"


@pytest.mark.parametrize("site", sorted(LANES))
def test_lane_entry(site):
    holder, lane, port, why = LANES[site]
    assert SITES.get(site) == holder, (site, SITES.get(site))
    assert lane in ("captured", "eager") and why
    assert callable(_port_callable(port)), port

