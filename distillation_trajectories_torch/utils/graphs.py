"""CUDA graphs of the port's compiled lanes: the counterparts of the JAX
package's ``jax.jit`` programs.

Two lanes capture: the trainers' epoch step
(``training/state.py::_CapturedStep``: JAX's ``lax.scan`` epochs of the
teacher, the students and the student group, and the progressive round's
jitted step, ``training/progressive.py::make_progressive_epoch_fn``) and
the samplers' chains (:class:`CapturedCall`, behind the sampler makers,
JAX's jitted ``lax.scan`` chains).  What they share is here: the eager
warm-up on a side stream (a capture records what runs and runs nothing, so
Triton's build, cuDNN's algorithm choices and cuBLAS's workspace must come
before it), the capture itself, the memory pool the sampler graphs share,
and a host-to-device copy that does not synchronize the host.

The captured sampler lane is the rule on the card: the engine's makers,
the manager, the grid and FID samplers, and the benches' chains
(``diffusion/sampling.py::make_chain_fn`` in ``bench_r2``, ``bench_quant``,
``bench_progressive`` and ``bench_fast``; ``make_batch_chain_fn`` in
``bench``), every chain of a sweep call included bar one: an int8 sweep
maker, which no call keeps, runs its CFG-off chain eagerly.  These stay
eager, each
for its reason (of the first two :func:`sampler_lane_captures` decides,
which :class:`CapturedCall` alone asks):

* the CPU, which has no graphs;
* the spatial layout's forward (``Config.spatial_shape``), whose halo
  all-gathers run inside the forward, and a model sharded over a mesh,
  whose collectives do;
* the window sampler (``diffusion/parallel_sampling.py``), which tests its
  convergence on the host between sweeps;
* one-off calls not made through a maker (``generate_trajectory``,
  ``generate_trajectory_scan``, ``p_sample_loop``,
  ``editing/core.py::denoise_with_trajectory``), and a maker's call with
  ``eager=True`` (a bench's calibration chain and its timed eager body, the
  int8 sweep maker's CFG-off chain): a capture that is never replayed
  costs an eager chain plus the graph's instantiation.

Of JAX's other jitted programs (``tests/test_torch_compiled_lanes.py``
lists every ``jax.jit`` site with its lane), these run eagerly: those run
once or a few times a run (the editing directions, the noise-prediction
analysis, FID's feature pass, the int8 calibration, the sweep's draws, a
checkpoint's device copy, the initialisers); the per-batch train steps
(the lane JAX takes off its default on one device, and the mesh lane,
whose collectives cannot be captured); the metric suite, vectorised over
the samples (one call per size and scale); LPIPS, which no CLI calls; and
the spatial forward, whose halo all-gathers run inside it.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Hashable, Sequence

import numpy as np
import torch

from .profiling import span


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A small host array on ``device``.  On the card the copy goes through
    pinned memory and is ordered on the current stream, so the host does
    not wait for the device; elsewhere it is a plain copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def on_side_stream(fn: Callable, device):
    """``fn()`` eagerly on a side stream that starts after the current
    stream's work and that the current stream's later work waits for: the
    warm-up PyTorch asks for before a capture."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out


def capture(fn: Callable, pool=None, generators: Sequence[torch.Generator] = ()):
    """``(graph, fn()'s result)``: ``fn`` captured into a new CUDA graph, in
    ``pool`` (a private pool when None), with each generator's state
    registered so that its replays advance it.  ``thread_local``: other
    threads (a checkpoint writer's) may copy to the host meanwhile."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn()
    return graph, out


# The sampler graphs' pool handle and the count of live graphs in it.
_SAMPLER_POOL = {"handle": None, "graphs": 0}


def sampler_pool():
    """The one memory pool of the sampler graphs alive in the process.  A
    graph's activations are dead between its replays, and the sampler
    graphs replay one after another on one stream, so they may share
    memory: a sweep that captures a graph per student size does not
    multiply its pools.  Once every graph of a pool is gone, the next
    capture takes a new handle: PyTorch's allocator refuses to capture
    into a pool that no graph holds while a block of it (cuBLAS's
    workspace, allocated during a capture) lives on."""
    if _SAMPLER_POOL["handle"] is None:
        _SAMPLER_POOL["handle"] = torch.cuda.graph_pool_handle()
    return _SAMPLER_POOL["handle"]


def _pool_graph_gone() -> None:
    _SAMPLER_POOL["graphs"] -= 1
    if _SAMPLER_POOL["graphs"] == 0:
        _SAMPLER_POOL["handle"] = None


def sampler_lane_captures(device, model=None, config=None) -> bool:
    """Whether a sampler maker's chains are captured: on the card, unless
    the forward runs collectives (the spatial layout, a model sharded over
    a mesh).  Everything else stays eager by the rules above."""
    if torch.device(device).type != "cuda":
        return False
    if config is not None and getattr(config, "spatial_shape", None):
        return False
    return model is None or getattr(model, "mesh", None) is None


class _Static:
    """The static inputs and output that a :class:`CapturedCall`'s graphs of
    one input signature share: copies of the inputs, which each replay
    overwrites first, and the output every such graph writes, allocated
    outside the pool."""

    def __init__(self, inputs: Sequence[torch.Tensor], shape, dtype, device):
        with torch.no_grad():
            self.inputs = [a.detach().clone() for a in inputs]
        self.output = torch.empty(shape, dtype=dtype, device=device)


class _Graph:
    """One captured call: the graph, on a static set's inputs and output,
    and the launches of each counted wrapper a replay makes."""

    def __init__(self, fn: Callable, static: _Static, counted):
        self.inputs, self.output = static.inputs, static.output
        self.counted = counted
        before = [c.launches for c in counted]
        try:
            self.graph, out = capture(lambda: fn(*self.inputs, out=self.output),
                                      pool=sampler_pool())
            if out is not self.output:
                raise ValueError("a captured body must return the out= tensor it is given")
        except BaseException:
            if _SAMPLER_POOL["graphs"] == 0:  # no graph holds the pool
                _SAMPLER_POOL["handle"] = None
            raise
        finally:
            # The capture recorded these launches; the replays make them.
            self.launches = [c.launches - b for c, b in zip(counted, before)]
            for c, b in zip(counted, before):
                c.launches = b
        _SAMPLER_POOL["graphs"] += 1
        weakref.finalize(self, _pool_graph_gone)

    def __call__(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            for static, a in zip(self.inputs, inputs):
                static.copy_(a)
        self.graph.replay()
        for c, n in zip(self.counted, self.launches):
            c.launches += n
        return self.output.clone()


class CapturedCall:
    """``body(*inputs, out=None) -> tensor`` as a CUDA graph, one per key,
    where the sampler lane captures.

    ``captures(device)`` (:func:`sampler_lane_captures`, or a maker's
    closure of it over its model and config) is asked at each call, on the
    first input's device.  Where it is false, or the call passes
    ``eager=True``, the call runs ``body(*inputs)`` directly on the current
    stream: no span, no warm-up kept, no graph.  Otherwise the first call
    of an input signature (the inputs' shapes, dtypes and devices) runs
    ``body`` eagerly on a side stream, its warm-up: a maker's keys (CFG on
    or off) differ in what their chain computes, not in its kernels.  A
    key of a warm signature is captured on its next call and replayed, and
    every later call of it replays.  So a caller that calls a key only once
    (a sweep's CFG-off chain) calls a key of its signature that repeats
    first: the warm-up then falls on that key, and the once-called key is
    captured on its call instead of being left to capture on a later one.
    The keys of one signature share one
    static set: the inputs' copies, which a replay overwrites first, and
    the output, allocated outside the pool at the signature's first
    capture, which ``body`` writes and returns when given it as ``out=``
    (its shape and dtype follow from the signature).  The graphs replay
    one after another on one stream and each call returns a fresh copy of
    the output, so no two calls share storage.  Whatever ``body`` reads
    besides its inputs (a model's weights) it reads where it was captured,
    so such state must change in place.  ``counted`` are kernel wrappers
    with a ``launches`` count (``ops.COUNTED``): the launches recorded
    while capturing are taken back and added again at each replay, so the
    counts stay the device's.  A capture or replay that fails raises.

    Each captured-lane call is one span (:func:`..utils.profiling.span`,
    attribute ``key``, the caller's key): ``graph.warmup``,
    ``graph.capture`` (the capture alone; its call's replay follows) or
    ``graph.replay``."""

    def __init__(self, captures: Callable[[torch.device], bool], counted=()):
        self.captures = captures
        self.counted = tuple(counted)
        self.graphs: Dict[Hashable, _Graph] = {}
        self._outputs: Dict[tuple, tuple] = {}  # signature -> the warm-up's output shape
        self._statics: Dict[tuple, _Static] = {}

    def __call__(self, key: Hashable, body: Callable, *inputs: torch.Tensor,
                 eager: bool = False) -> torch.Tensor:
        if eager or not self.captures(inputs[0].device):
            return body(*inputs)
        sig = tuple((tuple(a.shape), a.dtype, a.device) for a in inputs)
        key = (key, sig)
        entry = self.graphs.get(key)
        if entry is None and sig not in self._outputs:
            with span("graph.warmup", key=key[0]):
                out = on_side_stream(lambda: body(*inputs), inputs[0].device)
            self._outputs[sig] = (out.shape, out.dtype, out.device)
            return out
        if entry is None:
            static = self._statics.get(sig)
            with span("graph.capture", key=key[0]):
                if static is None:
                    static = self._statics[sig] = _Static(inputs, *self._outputs[sig])
                entry = self.graphs[key] = _Graph(body, static, self.counted)
        with span("graph.replay", key=key[0]):
            return entry(inputs)
