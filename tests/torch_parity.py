"""Shared pieces of the PyTorch-port parity tests: small configs, JAX
variables carried into port models, and a draw source that replays the JAX
trainers' PRNG key stream into the port's trainers."""

import jax
import numpy as np
import torch

from distillation_trajectories_tpu.config import Config as JaxConfig
from distillation_trajectories_tpu.models import init_unet as jax_init_unet
from distillation_trajectories_tpu.models import make_unet as jax_make_unet
from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import load_unet_variables, make_unet
from distillation_trajectories_torch.training.state import StepDraws

KW = dict(dataset="MNIST", image_size=16, channels=1, batch_size=8, sample_steps=10,
          timesteps=10, epochs=1, compute_dtype="float32", dropout=0.0)


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

    def teacher_step(self, images, timesteps):
        return teacher_draws(self._next(), tuple(images.shape), timesteps)

    def distill_step(self, images, timesteps):
        return distill_draws(self._next(), tuple(images.shape), timesteps)

    def sample(self, shape, n_steps):
        return sample_draws(self._next(), shape, n_steps)
