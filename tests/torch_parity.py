"""Shared pieces of the PyTorch-port parity tests: small configs, JAX
variables carried into port models, a draw source that replays the JAX
trainers' PRNG key stream into the port's trainers, the ``tmp_path``
every port test module imports, which removes what a test wrote once it
ends, and ``cpu_graphs``, a stand-in for the card's graph capture."""

import contextlib
import os
import shutil
from unittest import mock

# oneDNN's AMX kernels (the CPU's bf16 convolutions and int8 products) have
# returned tiles of wrong values, NaN among them, while their threads were
# preempted on a loaded host; its AVX-512 kernels, on the same host at the
# same time, have not.  The suite's CPU parity tests run six workers at once,
# so they keep oneDNN to AVX-512.  oneDNN reads this at its first primitive
# (no test module runs one at import before this one is imported), and the
# CLIs the tests start as subprocesses inherit it.
os.environ.setdefault("ONEDNN_MAX_CPU_ISA", "AVX512_CORE_BF16")

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import load_unet_variables, make_unet
from distillation_trajectories_torch.training.state import StepDraws

KW = dict(dataset="MNIST", image_size=16, channels=1, batch_size=8, sample_steps=10,
          timesteps=10, epochs=1, compute_dtype="float32", dropout=0.0)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with all it holds when the test ends
    (a port test module imports this fixture, which overrides pytest's
    there; module fixtures remove their ``tmp_path_factory`` trees the same
    way).  The port's tests write checkpoints of full-width U-Nets, sample
    grids and records: 6.1 GB a whole run, where the tests before the port
    wrote 0.7 GB.  pytest keeps the trees of the last three runs and drops
    the oldest only when a run ends, so four runs' trees share the disk
    while a run goes on, and on a host with about 30 GB free the fourth run
    in a row ran out of space (``OSError: [Errno 28]``) in whatever tests
    were writing then: the trainer parity tests, which write the most and
    run last."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


class _Replayed:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured body
    again, on the static set it was captured on."""

    def __init__(self, fn):
        self.replay = fn


@pytest.fixture
def cpu_graphs(monkeypatch):
    """``utils/graphs.py``'s capture on the CPU: the warm-up runs on the
    current stream, a capture runs the body once, its replays again."""
    from distillation_trajectories_torch.utils import graphs

    monkeypatch.setattr(graphs, "on_side_stream", lambda fn, device: fn())
    monkeypatch.setattr(graphs, "capture",
                        lambda fn, pool=None, generators=(): (_Replayed(fn), fn()))
    monkeypatch.setattr(graphs, "sampler_pool", lambda: None)


def configs(tmp_path=None, **kw):
    kw = {**KW, **kw}
    if tmp_path is not None:
        kw["base_dir"] = str(tmp_path)
    jcfg, tcfg = JaxConfig(**kw), Config(device="cpu", **kw)
    if tmp_path is not None:
        jcfg.create_directories()
        tcfg.create_directories()
    return jcfg, tcfg


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(tcfg, size_factor, variables):
    """A port U-Net on the CPU holding JAX ``variables``."""
    model = make_unet(tcfg, size_factor=size_factor, device="cpu")
    return load_unet_variables(model, numpy_tree(variables))


def as_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def teacher_draws(key, images_shape, timesteps):
    """The JAX teacher step's draws from its step key (``split(key, 5)``)."""
    kt, kn1, kn2, _, _ = jax.random.split(key, 5)
    t = jax.random.randint(kt, (images_shape[0],), 0, timesteps)
    n1 = jax.random.normal(kn1, images_shape)
    n2 = jax.random.normal(kn2, images_shape)
    return StepDraws(as_torch(t, torch.int64), (as_torch(n1), as_torch(n2)))


def distill_draws(key, images_shape, timesteps):
    """The JAX distillation step's draws from its step key (``split(key, 4)``)."""
    kt, kn, _, _ = jax.random.split(key, 4)
    t = jax.random.randint(kt, (images_shape[0],), 0, timesteps)
    return StepDraws(as_torch(t, torch.int64), (as_torch(jax.random.normal(kn, images_shape)),))


def sample_draws(key, shape, n_steps):
    """``p_sample_loop``'s starting and per-step noise from its key."""
    key, init_key = jax.random.split(key)
    noise = jax.random.normal(init_key, shape)
    steps = []
    for _ in range(n_steps):
        key, sk = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(sk, shape)))
    return as_torch(noise), as_torch(np.stack(steps))


def jax_noises(seeds, shape):
    """``[S, *shape]`` starting noises ``normal(PRNGKey(seed), shape)``."""
    return np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(int(s)), shape))
                     for s in seeds])


def jax_step_noise(seeds, timesteps, shape):
    """The JAX engine samplers' per-step noise ``fold_in(PRNGKey(seed), t)``
    as ``[T-1, S, *shape]`` (row ``j`` is step ``T-1-j``); the draw shape
    does not change the bits, so this serves batch and per-sample chains."""
    return np.stack([
        np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(int(s)), t), shape)) for s in seeds])
        for t in range(timesteps - 1, 0, -1)
    ])


# JAX's outputs by case (see :func:`jax_once`).
_JAX_OUT = {}


def jax_once(key, thunk):
    """``np.asarray(thunk())``, computed once a process for ``key`` (a tuple
    whose first item names the test module's case): the JAX output that
    several parametrised cases of a port test compare with, such as a
    maker's two entries."""
    if key not in _JAX_OUT:
        _JAX_OUT[key] = np.asarray(thunk())
    return _JAX_OUT[key]


def jax_chain_draws(seeds, timesteps, shape):
    """A port ``SweepDraws`` holding the JAX chains' starting and step noise."""
    from distillation_trajectories_torch.trajectories import SweepDraws

    return SweepDraws(torch.from_numpy(jax_noises(seeds, shape)),
                      torch.from_numpy(jax_step_noise(seeds, timesteps, shape)))


def train_small(root):
    """A teacher and students {0.1, 0.2} trained by the port's trainers
    (one batch each) into ``root``; returns the two packages' configs."""
    from distillation_trajectories_torch.training import train_students, train_teacher

    jcfg, tcfg = configs(root, limit_batches_per_epoch=1, num_samples_to_generate=0)
    train_teacher(tcfg, seed=0)
    train_students(tcfg, custom_size_factors=[0.1, 0.2], seed=0)
    return jcfg, tcfg


def jax_checkpoint_models(jcfg, size_factors=(1.0, 0.1, 0.2)):
    """``{sf: (model, variables)}`` of the JAX package, read from the
    checkpoints in ``jcfg``'s tree (1.0 is the teacher)."""
    from distillation_trajectories_tpu.training import load_checkpoint, variables_from_checkpoint

    out = {}
    for sf in size_factors:
        path = jcfg.teacher_models_dir if sf == 1.0 else jcfg.student_dir(sf)
        out[sf] = (jax_make_unet(jcfg, size_factor=sf),
                   variables_from_checkpoint(load_checkpoint(path)))
    return out


def names_only_savefig(figure, path, *args, **kwargs):
    """A stand-in for ``Figure.savefig`` that writes an empty file: the
    JAX plot functions' file names without their rendering cost."""
    open(path, "wb").close()


def _no_layout(figure, *args, **kwargs):
    """A stand-in for ``Figure.tight_layout`` on a figure never drawn."""


# The JAX plot functions under this patch write each PNG as an empty file
# and lay out no text: only their file names are compared.
NAMES_ONLY = mock.patch.multiple("matplotlib.figure.Figure", savefig=names_only_savefig,
                                 tight_layout=_no_layout)


def _no_redraw(canvas, *args, **kwargs):
    """A stand-in for ``FigureCanvasBase.draw_idle``."""


@contextlib.contextmanager
def quick_plots():
    """Plot functions under this context render each PNG at 30 dpi whatever
    they ask for: real PNGs (the tests check they are over 1 KB) at a
    hundredth of the pixels of 300 dpi.  ``pyplot.savefig``'s redraw of the
    figure after saving, which only an interactive window shows, is
    skipped."""
    from matplotlib.backend_bases import FigureCanvasBase
    from matplotlib.figure import Figure

    savefig = Figure.savefig

    def low_dpi(figure, path, *args, **kwargs):
        return savefig(figure, path, *args, **{**kwargs, "dpi": 30})

    with mock.patch.object(Figure, "savefig", low_dpi), \
            mock.patch.object(FigureCanvasBase, "draw_idle", _no_redraw):
        yield


def check_losses(got, want):
    """Per-epoch losses against JAX's: the first epoch at rtol 1e-4, later
    ones at rtol 1e-3 (``test_torch_trainers.py``'s tolerances: Adam's
    first steps move every weight by about ±lr whatever the size of its
    gradient, so the gradients' rounding noise reaches later losses)."""
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)


def file_set(root):
    """Relative paths of every file under ``root``."""
    import os

    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files}


class JaxDraws:
    """A port draw source replaying the JAX trainers' key stream from
    ``PRNGKey(seed)``: the init split, then one ``key, sub = split(key)``
    per train step and per sample grid, in the order the trainers use them."""

    def __init__(self, jcfg, seed, device):
        self.jcfg = jcfg
        self.key = jax.random.PRNGKey(seed)

    @classmethod
    def factory(cls, jcfg):
        return lambda seed, device: cls(jcfg, seed, device)

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def init_unet(self, config, size_factor):
        jmodel = jax_make_unet(self.jcfg, size_factor=size_factor)
        return port_model(config, size_factor, jax_init_unet(jmodel, self.jcfg, self._next()))

    def init_model(self, config):
        return self.init_unet(config, 1.0)

    def teacher_step(self, images, timesteps):
        return teacher_draws(self._next(), tuple(images.shape), timesteps)

    def distill_step(self, images, timesteps):
        return distill_draws(self._next(), tuple(images.shape), timesteps)

    def sample(self, shape, n_steps):
        return sample_draws(self._next(), shape, n_steps)

    def progressive_step(self, images, student_steps, guidance_range=None):
        """The JAX progressive step's draws: ``split(sk, 4)`` into
        ``kj, kn, kd, kw`` of the batch key ``sk``."""
        return progressive_draws(self._next(), tuple(images.shape), student_steps, guidance_range)


def progressive_draws(key, images_shape, student_steps, guidance_range=None):
    """``j``, the noise and ``w`` of the JAX progressive step from its key."""
    kj, kn, _, kw = jax.random.split(key, 4)
    j = jax.random.randint(kj, (images_shape[0],), 1, student_steps)
    noise = as_torch(jax.random.normal(kn, images_shape))
    w = None
    if guidance_range is not None:
        lo, hi = guidance_range
        w = as_torch(jax.random.uniform(kw, (images_shape[0], 1), minval=lo, maxval=hi))
    return StepDraws(as_torch(j, torch.int64), (noise,), w=w)


class JaxEditingDraws:
    """The editing flows' draws made the JAX way, for the port's
    ``draws=`` arguments: a generation of ``seed`` splits ``PRNGKey(seed)``
    into ``key, nk``, starts from ``normal(nk)`` and takes
    ``normal(fold_in(key, t))`` at step t; a re-denoise keyed on ``seed``
    takes ``normal(fold_in(PRNGKey(seed), t))``; a direction is
    ``normal(PRNGKey(seed))``."""

    @staticmethod
    def _steps(key, shape, start_t):
        return as_torch(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, t), shape))
                                  for t in range(start_t, 0, -1)]).reshape(start_t, *shape))

    def chain(self, seed, shape, start_t):
        key, nk = jax.random.split(jax.random.PRNGKey(seed))
        return as_torch(jax.random.normal(nk, shape)), self._steps(key, shape, start_t)

    def redenoise(self, seed, shape, start_t):
        return self._steps(jax.random.PRNGKey(seed), shape, start_t)

    def direction(self, seed, shape):
        return as_torch(jax.random.normal(jax.random.PRNGKey(seed), shape))


class JaxBenchDraws:
    """The benches' draws (``scripts._common.BenchDraws``) made the JAX
    benches' way: ``noise(key, shape)`` is ``normal(PRNGKey(key), shape)``,
    a chain of seed s takes ``normal(fold_in(PRNGKey(s), t), shape)`` at
    step t, and the metric suite's pair i takes ``uniform(k_i, (n, d))``
    with ``k = split(PRNGKey(key), pairs)``."""

    def __init__(self, device="cpu"):
        pass

    def noise(self, key, shape):
        return torch.from_numpy(jax_noises([key], tuple(shape))[0])

    def step_noise(self, seed, timesteps, shape):
        return torch.from_numpy(jax_step_noise([seed], timesteps, tuple(shape))[:, 0])

    def uniforms(self, key, pairs, n, d):
        keys = jax.random.split(jax.random.PRNGKey(int(key)), pairs)
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n, d)))
                                          for k in keys]))


def jax_variables(model):
    """The JAX variables of a port U-Net's weights."""
    from distillation_trajectories_torch.models import variables_from_unet_state_dict

    return variables_from_unet_state_dict(model.state_dict())
