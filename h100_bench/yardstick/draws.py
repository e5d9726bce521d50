"""Everything a run draws from ``--seed``, worked out without the program.

The program draws some of its inputs itself, as its users' calls make it
do: the sweep's and the paired call's noise from a generator per
``(seed, t)``, the trainer's timesteps, noise and dropout masks from one
device generator, and the loader's epoch order from ``std::mt19937_64``.
The reference derives the same draws here from the documented streams, so
that it takes nothing the program made.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

MASK64 = 0xFFFFFFFFFFFFFFFF


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (weights, data,
    draws), so that no two uses share a stream."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + sum(ord(c) << (8 * (i % 7)) for i, c in enumerate(tag)))
    return splitmix64(z & MASK64) >> 1


def splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def generator_seed(seed: int, t: int) -> int:
    """The seed of the generator of ``(seed, t)``: splitmix64 of the two
    32-bit halves (the sampler's documented per-step stream)."""
    return splitmix64(((int(seed) & 0xFFFFFFFF) << 32) | (int(t) & 0xFFFFFFFF))


def seeded_normal(keys: Sequence[Tuple[int, int]], shape, device) -> torch.Tensor:
    """``[len(keys), *shape]`` float32 normals, row ``i`` from the generator
    of ``keys[i]`` alone."""
    out = torch.empty((len(keys), *shape), device=device, dtype=torch.float32)
    gen = torch.Generator(device=device)
    for i, (seed, t) in enumerate(keys):
        gen.manual_seed(generator_seed(seed, t))
        out[i].normal_(generator=gen)
    return out


def step_noise(seeds: Sequence[int], timesteps: int, shape, device) -> torch.Tensor:
    """``[T-1, S, *shape]``: sample ``i`` at step ``t = T-1-j`` in row ``j``."""
    keys = [(int(s), t) for t in range(timesteps - 1, 0, -1) for s in seeds]
    return seeded_normal(keys, shape, device).reshape(timesteps - 1, len(seeds), *shape)


def sweep_uniforms(base_seed: int, samples: int, timesteps: int, pixels: int,
                   device) -> torch.Tensor:
    """The sweep's Wasserstein subsample keys ``[S, T+1, D]``: one generator
    seeded with the job's ``base_seed``."""
    gen = torch.Generator(device=device).manual_seed(int(base_seed))
    return torch.rand((samples, timesteps + 1, pixels), generator=gen, device=device)


# --- The trainer's stream -------------------------------------------------------


def dropout_masks(gen: torch.Generator, shapes_nchw, keep: float, device):
    """One train forward's dropout masks, in block order, as NCHW views of
    channels-last storage (the layout the U-Net's activations have, so the
    draws land on the same elements)."""
    out = []
    for b, c, h, w in shapes_nchw:
        m = torch.empty((b, h, w, c), device=device).bernoulli_(keep, generator=gen)
        out.append(m.permute(0, 3, 1, 2))
    return out


def teacher_step_draws(gen: torch.Generator, batch: int, image_shape, timesteps: int,
                       device):
    """A teacher step's ``t`` and its two noises, in the trainer's order."""
    t = torch.randint(0, timesteps, (batch,), generator=gen, device=device)
    n1 = torch.randn((batch, *image_shape), generator=gen, device=device)
    n2 = torch.randn((batch, *image_shape), generator=gen, device=device)
    return t, n1, n2


# --- The loader's epoch order -----------------------------------------------------


class MT19937_64:
    """``std::mt19937_64``."""

    N, M = 312, 156
    MATRIX_A = 0xB5026F5AA96619E9
    UPPER, LOWER = 0xFFFFFFFF80000000, 0x7FFFFFFF

    def __init__(self, seed: int):
        mt = [int(seed) & MASK64]
        for i in range(1, self.N):
            prev = mt[-1]
            mt.append((6364136223846793005 * (prev ^ (prev >> 62)) + i) & MASK64)
        self.mt, self.i = mt, self.N

    def _twist(self) -> None:
        mt, n, m = self.mt, self.N, self.M
        for k in range(n):
            x = (mt[k] & self.UPPER) | (mt[(k + 1) % n] & self.LOWER)
            xa = x >> 1
            if x & 1:
                xa ^= self.MATRIX_A
            mt[k] = mt[(k + m) % n] ^ xa
        self.i = 0

    def __call__(self) -> int:
        if self.i >= self.N:
            self._twist()
        y = self.mt[self.i]
        self.i += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & MASK64


def uniform_int(rng: MT19937_64, hi: int) -> int:
    """``std::uniform_int_distribution<int64_t>(0, hi)`` of libstdc++ on a
    64-bit engine: Lemire's multiply-and-reject on 128-bit products."""
    rng_range = hi + 1
    product = rng() * rng_range
    low = product & MASK64
    if low < rng_range:
        threshold = ((1 << 64) - rng_range) % rng_range
        while low < threshold:
            product = rng() * rng_range
            low = product & MASK64
    return product >> 64


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """Fisher-Yates over ``range(n)`` on ``std::mt19937_64(seed)``, the
    loader's documented epoch permutation."""
    rng = MT19937_64(seed & MASK64)
    idx = list(range(n))
    for i in range(n - 1, 0, -1):
        j = uniform_int(rng, i)
        idx[i], idx[j] = idx[j], idx[i]
    return np.asarray(idx, dtype=np.int64)


def epoch_rows(n: int, batch: int, loader_seed: int, epoch: int, n_batches: int) -> np.ndarray:
    """``[n_batches, batch]`` rows of the loader's epoch ``epoch`` (1 for the
    first), whose permutation is seeded ``loader_seed * 1_000_003 + epoch``."""
    perm = shuffle_indices(n, int(loader_seed) * 1_000_003 + int(epoch))
    return perm[: n_batches * batch].reshape(n_batches, batch)
