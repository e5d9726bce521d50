"""Train state, draws and train steps (port of
``distillation_trajectories_tpu/training/state.py``).

One train step is eager PyTorch: the forwards, one backward, an Adam step
and, for the teacher, an optional EMA update.  Where JAX splits a PRNG key
per step (``split(key, 5)`` for the teacher at JAX ``state.py:164``,
``split(key, 4)`` for distillation at ``:341``), the port takes a
:class:`StepDraws`: the timesteps, the noise draws and the generator of the
dropout masks.  A step given none draws them from ``state.draws``, a draw
source; the default source, :class:`TorchDraws`, is one ``torch.Generator``
on the device seeded from the trainer's seed.  Tests pass a source (or the
draws) holding JAX's values instead.

The epoch lane (JAX ``make_teacher_epoch_fn``, ``make_distill_epoch_fn``,
``make_multi_distill_epoch_fn``, and the progressive round's jitted step
through ``progressive.make_progressive_epoch_fn``) runs the same step
bodies over a device-resident dataset: each batch is gathered on the
device by a row of ``DataLoader.epoch_indices`` and each loss lands in a
device tensor, so nothing waits for the host inside an epoch.  On CUDA
the step is captured once into a ``torch.cuda.CUDAGraph`` and replayed
for every batch (the counterpart of JAX's one ``lax.scan`` dispatch); on
the CPU the same body runs eagerly.  Same-architecture students train as one step over a member
axis: each member's step on its row of the stacked weights, one backward
and one Adam step for the group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..diffusion.process import q_sample
from ..diffusion.schedules import schedule_on
from ..models.dit import require_unet
from ..parallel.collectives import all_reduce_, mean_gradients
from ..parallel.mesh import DATA_AXIS, axis_group, axis_size, shard_batch
from ..utils.graphs import capture, on_side_stream
from ..utils.profiling import span


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one train step."""

    t: torch.Tensor  # [B] integer timesteps (the teacher's, for distillation;
    # the student's index j for progressive distillation)
    noises: Tuple[torch.Tensor, ...]  # two for the teacher step, one for distillation
    generator: Optional[torch.Generator] = None  # dropout masks; None: global generator
    w: Optional[torch.Tensor] = None  # [B, 1] guidance scales of guided progressive steps


class TorchDraws:
    """The port's default draw source for one trainer run.

    ``init_unet`` initialises a model from ``seed`` (see
    :func:`..models.make_unet`); the step and sample draws come, in call
    order, from one ``torch.Generator`` on ``device`` seeded from ``seed``,
    which also draws the dropout masks.  A source that replays another
    stream implements the same methods.
    """

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

    def init_unet(self, config, size_factor: float) -> torch.nn.Module:
        from ..models import make_unet

        return make_unet(config, size_factor=size_factor, device=self.device, seed=self.seed)

    def _normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device, dtype=dtype)

    def _t(self, batch: int, timesteps: int) -> torch.Tensor:
        return torch.randint(0, timesteps, (batch,), generator=self.generator,
                             device=self.device)

    def teacher_step(self, images: torch.Tensor, timesteps: int) -> StepDraws:
        t = self._t(images.shape[0], timesteps)
        noises = (self._normal(images.shape, images.dtype), self._normal(images.shape, images.dtype))
        return StepDraws(t, noises, self.generator)

    def distill_step(self, images: torch.Tensor, timesteps: int) -> StepDraws:
        t = self._t(images.shape[0], timesteps)
        return StepDraws(t, (self._normal(images.shape, images.dtype),), self.generator)

    def progressive_step(self, images: torch.Tensor, student_steps: int,
                         guidance_range: Optional[Tuple[float, float]] = None) -> StepDraws:
        """``j ~ U[1, S)``, the noise and, for a guided step, ``w ~ U[lo, hi]``."""
        b = images.shape[0]
        j = torch.randint(1, student_steps, (b,), generator=self.generator, device=self.device)
        noise = self._normal(images.shape, images.dtype)
        w = None
        if guidance_range is not None:
            lo, hi = guidance_range
            u = torch.rand((b, 1), generator=self.generator, device=self.device, dtype=images.dtype)
            w = lo + (hi - lo) * u
        return StepDraws(j, (noise,), self.generator, w)

    def sample(self, shape, n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Starting noise ``shape`` and per-step noise ``[n_steps, *shape]``
        of one sample grid."""
        return self._normal(shape), self._normal((n_steps, *shape))


@dataclasses.dataclass
class TrainState:
    """A model in training: its optimizer, its draw source, the optional
    EMA of its parameters (by name), the step count and, once
    ``parallel.shard_train_state`` has partitioned it, its mesh."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    draws: object
    ema: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0
    mesh: Optional[object] = None


def make_optimizer(model, config) -> torch.optim.Adam:
    """Adam with torch's defaults, β=(0.9, 0.999) and eps 1e-8, as the
    reference trainers run it (not the config's unused ``adam_beta1=0.8``),
    over a module's parameters or an iterable of tensors.  On CUDA it is
    ``capturable`` (its step count a device tensor), so that a captured
    step can replay it; the per-batch loop builds it so too, and both lanes
    run the same update."""
    params = list(model.parameters() if isinstance(model, torch.nn.Module) else model)
    return torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=params[0].device.type == "cuda")


def create_train_state(model: torch.nn.Module, config, draws, use_ema: bool = False) -> TrainState:
    require_unet(model, "the trainers")
    ema = None
    if use_ema:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model=model, optimizer=make_optimizer(model, config), draws=draws, ema=ema)


def make_eval_model_fn(model: torch.nn.Module, params: Optional[Dict[str, torch.Tensor]] = None) -> Callable:
    """Eval-mode forward closure ``(x, t, cond, cond_mask, labels=None) ->
    ε̂``, run under ``torch.no_grad()``; puts ``model`` in eval mode.
    ``labels`` go to a class-conditional model (the DiT) and only there.
    ``params`` (tensors by parameter name, e.g. EMA weights) stand in for
    the model's own."""
    model.eval()

    def model_fn(x, t, cond=None, cond_mask=None, labels=None):
        kwargs = dict(cond=cond, cond_mask=cond_mask)
        if labels is not None:
            kwargs["labels"] = labels
        with torch.no_grad():
            if params is None:
                return model(x, t, **kwargs)
            return torch.func.functional_call(model, params, (x, t), kwargs, strict=False)

    return model_fn


def make_eval_fn_from_config(model: torch.nn.Module, config) -> Callable:
    """The config-aware eval forward every sampler and editing flow goes
    through (JAX ``training/state.py::make_eval_fn_from_config``):

    * ``Config.sampler_quant="int8"``: the folded int8 forward
      (:func:`..models.quantized.make_quantized_eval_fn`, dynamic scales);
    * ``Config.spatial_shape=(d, s)``: the spatially partitioned forward
      (:func:`..parallel.spatial.make_spatial_eval_fn`: image rows split
      s-way, halo rows exchanged), for sampling and editing alike;
    * otherwise the plain eval forward.

    The two opt-ins cannot combine (``ValueError``), as in JAX; neither
    takes a DiT (``ValueError``)."""
    spatial = config is not None and getattr(config, "spatial_shape", None)
    if spatial:  # before the spatial mesh, which needs its ranks
        require_unet(model, "the spatial lane")
    if config is not None and getattr(config, "sampler_quant", "none") == "int8":
        if spatial:
            raise ValueError(
                "spatial_shape and sampler_quant='int8' cannot combine: the "
                "quantized forward bypasses the Block modules the spatial "
                "constraints intercept"
            )
        from ..models.quantized import make_quantized_eval_fn

        return make_quantized_eval_fn(model)
    if spatial:
        from ..parallel.spatial import make_spatial_eval_fn, make_spatial_mesh

        mesh = make_spatial_mesh(tuple(spatial), device_type=torch.device(config.device).type)
        return make_spatial_eval_fn(model, mesh)
    return make_eval_model_fn(model)


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def _schedule(cache: Dict, diffusion_params, device) -> Dict:
    if device not in cache:
        cache[device] = schedule_on(diffusion_params, device)
    return cache[device]


def _step_draws(state: TrainState, draws: Optional[StepDraws], images: torch.Tensor,
                make: Callable) -> StepDraws:
    """The step's draws: ``draws``, or ``make(images)`` from the state's
    source.  On a data-sharded mesh they are made for the global batch
    (``images`` holds this rank's rows) and cut to this rank's rows, so
    every rank draws what the unsharded step draws."""
    d = axis_size(state.mesh, DATA_AXIS)
    if d == 1:
        return draws if draws is not None else make(images)
    if draws is None:
        draws = make(images.new_empty((images.shape[0] * d, *images.shape[1:]), device="meta"))
    rows = lambda v: None if v is None else shard_batch(v, state.mesh)
    return StepDraws(rows(draws.t), tuple(rows(n) for n in draws.noises), draws.generator,
                     rows(draws.w))


def _global_loss(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """The global batch's loss: the mean of the ranks' losses over the
    data axis (equal shards)."""
    d = axis_size(state.mesh, DATA_AXIS)
    loss = loss.detach()
    if d == 1:
        return loss
    return all_reduce_(loss.clone(), axis_group(state.mesh, DATA_AXIS)) / d


def _update(state: TrainState, loss: torch.Tensor, ema_rate: Optional[float]) -> None:
    """Backward, the data axis's gradient mean on a mesh, the Adam step
    and the EMA.  The gradients are zeroed in place, not freed, so that a
    captured step keeps writing the buffers its graph holds."""
    state.optimizer.zero_grad(set_to_none=False)
    loss.backward()
    if axis_size(state.mesh, DATA_AXIS) > 1:
        mean_gradients(state.model, axis_group(state.mesh, DATA_AXIS))
    state.optimizer.step()
    if ema_rate is not None and state.ema is not None:
        with torch.no_grad():
            ema = list(state.ema.values())
            params = [p for _, p in state.model.named_parameters()]
            torch._foreach_mul_(ema, ema_rate)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_rate)


def _counted(body: Callable) -> Callable:
    """The per-batch step ``step(state, images, draws=None) -> (state,
    loss)`` of a step body ``body(state, images, draws) -> loss``."""

    def train_step(state, images: torch.Tensor, draws: Optional[StepDraws] = None):
        loss = body(state, images, draws)
        state.step += 1
        return state, loss

    return train_step


def make_teacher_train_step(diffusion_params, timesteps: int, ema_rate: Optional[float] = None):
    """Teacher step: one ``t`` per image, two noise draws, loss =
    (cond ε-MSE + uncond ε-MSE) / 2, BatchNorm statistics chained through
    both train forwards (cond first).  Returns ``step(state, images,
    draws=None) -> (state, loss)``; the gradients stay in ``.grad``."""
    return _counted(_teacher_body(diffusion_params, timesteps, ema_rate))


def _teacher_body(diffusion_params, timesteps: int, ema_rate: Optional[float]) -> Callable:
    """The teacher step's body ``(state, images, draws) -> loss``, shared by
    the per-batch step and the epoch lane; it leaves ``state.step`` alone."""
    schedules: Dict[torch.device, Dict] = {}

    def body(state: TrainState, images: torch.Tensor, draws: Optional[StepDraws]):
        draws = _step_draws(state, draws, images,
                            lambda like: state.draws.teacher_step(like, timesteps))
        dp = _schedule(schedules, diffusion_params, images.device)
        model = state.model.train()
        b = images.shape[0]
        ones = images.new_ones((b, 1))
        zeros = images.new_zeros((b, 1))
        x1, n1 = q_sample(images, draws.t, dp, noise=draws.noises[0])
        loss_cond = _mse(model(x1, draws.t, ones, ones, generator=draws.generator), n1)
        x2, n2 = q_sample(images, draws.t, dp, noise=draws.noises[1])
        loss_uncond = _mse(model(x2, draws.t, zeros, zeros, generator=draws.generator), n2)
        loss = (loss_cond + loss_uncond) / 2.0
        _update(state, loss, ema_rate)
        return _global_loss(state, loss)

    return body


def make_distill_train_step(teacher_model: torch.nn.Module, teacher_diffusion_params,
                            teacher_steps: int, student_steps: int):
    """Distillation step: ``t_student = ⌊t·S/T⌋``, images noised with the
    teacher's schedule, the teacher's cond and uncond in eval mode without
    gradients, the student's in train mode; loss = mean of the two MSEs
    between student and teacher predictions.  Returns ``step(state, images,
    draws=None) -> (state, loss)``."""
    return _counted(_distill_body(teacher_model, teacher_diffusion_params, teacher_steps,
                                  student_steps))


def _distill_body(teacher_model: torch.nn.Module, teacher_diffusion_params, teacher_steps: int,
                  student_steps: int) -> Callable:
    """The distillation step's body ``(state, images, draws) -> loss``,
    shared by the per-batch step and the epoch lane."""
    ratio = student_steps / teacher_steps
    teacher_fn = make_eval_model_fn(teacher_model)
    schedules: Dict[torch.device, Dict] = {}

    def body(state: TrainState, images: torch.Tensor, draws: Optional[StepDraws]):
        draws = _step_draws(state, draws, images,
                            lambda like: state.draws.distill_step(like, teacher_steps))
        dp = _schedule(schedules, teacher_diffusion_params, images.device)
        b = images.shape[0]
        ones = images.new_ones((b, 1))
        zeros = images.new_zeros((b, 1))
        t_teacher = draws.t
        t_student = torch.floor(t_teacher * ratio).to(torch.int64)
        x_noisy, _ = q_sample(images, t_teacher, dp, noise=draws.noises[0])
        teacher_cond = teacher_fn(x_noisy, t_teacher, ones, ones)
        teacher_uncond = teacher_fn(x_noisy, t_teacher, zeros, zeros)
        model = state.model.train()
        student_cond = model(x_noisy, t_student, ones, ones, generator=draws.generator)
        student_uncond = model(x_noisy, t_student, zeros, zeros, generator=draws.generator)
        loss = (_mse(student_cond, teacher_cond) + _mse(student_uncond, teacher_uncond)) / 2.0
        _update(state, loss, None)
        return _global_loss(state, loss)

    return body


# --- The epoch lane ----------------------------------------------------------

# Eager steps a state takes before its step is captured: the first builds
# the Adam moments and the gradients, the second runs every kernel once
# more with them in place (the capture records what runs, it runs nothing).
CAPTURE_WARMUP_STEPS = 2


def epoch_scan_enabled(config, mesh) -> bool:
    """The epoch lane (JAX ``state.py::epoch_scan_enabled``): on when
    ``config.epoch_scan`` is set, on one device (a mesh takes the per-batch
    loop, which places each batch's rows) and ``DTT_EPOCH_SCAN`` is not
    ``"0"``."""
    return (
        bool(getattr(config, "epoch_scan", True))
        and mesh is None
        and os.environ.get("DTT_EPOCH_SCAN", "1") != "0"
    )


def _draw_generators(state) -> List[torch.Generator]:
    """The generators a captured step of ``state`` draws from: each draw
    source's ``generator`` (a stacked state's members' too).  A source
    without one has nothing a replay could advance, so a capture raises."""
    sources = [m.draws for m in state.members] if isinstance(state, StackedTrainState) \
        else [state.draws]
    gens = [getattr(s, "generator", None) for s in sources]
    if any(not isinstance(g, torch.Generator) for g in gens):
        raise TypeError("a captured step draws from its draw source's torch.Generator; "
                        f"{[type(s).__name__ for s in sources]} have none")
    return gens


class _CapturedStep:
    """One state's step over one device dataset at one ``[n_batches, B]``
    index shape, captured into a CUDA graph after its warm-up steps.

    The graph reads its batch's index row from ``idx`` at the device
    counter ``i``, gathers the images from the dataset, runs the step body
    and writes the loss into row ``i`` of ``losses``, then advances
    ``i``: one ``replay()`` per batch and nothing else from the host.
    Spans (:func:`..utils.profiling.span`): ``epoch.warmup`` an eager step
    (attribute ``batch``), ``epoch.capture``, and one ``epoch.replay`` over
    an epoch's replays (``batches``), not one a replay."""

    def __init__(self, state, dataset: torch.Tensor, idx: torch.Tensor):
        self.state, self.dataset = state, dataset
        self.idx = idx.clone()
        self.i = torch.zeros((), dtype=torch.int64, device=dataset.device)
        self.losses = None  # [n_batches, *loss shape], from the first step
        self.warm = 0  # eager steps taken
        self.graph = None

    def matches(self, state, dataset, idx) -> bool:
        return self.state is state and self.dataset is dataset and self.idx.shape == idx.shape

    def eager(self, body, i: int) -> None:
        """Batch ``i`` eagerly, on a side stream (the warm-up CUDA graphs
        want before a capture)."""

        def step():
            loss = body(self.state, self.dataset.index_select(0, self.idx[i]))
            if self.losses is None:
                self.losses = loss.new_zeros((self.idx.shape[0], *loss.shape))
            self.losses[i].copy_(loss)

        with span("epoch.warmup", batch=i):
            on_side_stream(step, self.dataset.device)
        self.state.step += 1
        self.warm += 1

    def capture(self, body) -> None:
        def step():
            at = self.i.view(1)
            loss = body(self.state, self.dataset.index_select(0, self.idx.index_select(0, at)[0]))
            self.losses.index_copy_(0, at, loss.unsqueeze(0))
            self.i.add_(1)

        with span("epoch.capture"):
            self.graph, _ = capture(step, generators=_draw_generators(self.state))

    def run(self, body, idx: torch.Tensor) -> torch.Tensor:
        """One epoch over ``idx``: warm-up steps while any are due, the
        capture, then a replay per batch.  Returns the epoch's losses."""
        n = idx.shape[0]
        self.idx.copy_(idx)
        i = 0
        while i < n and self.warm < CAPTURE_WARMUP_STEPS:
            self.eager(body, i)
            i += 1
        if i < n and self.graph is None:
            self.capture(body)
        self.i.fill_(i)
        with span("epoch.replay", batches=n - i):
            for _ in range(i, n):
                self.graph.replay()
                self.state.step += 1
        return self.losses.clone()


def _epoch_fn(body: Callable) -> Callable:
    """``epoch(state, dataset, idx) -> (state, losses)``: ``body(state,
    images, draws=None) -> loss`` for each row of ``idx`` (``[n_batches,
    B]``, as ``DataLoader.epoch_indices`` gives it) on the rows of
    ``dataset`` (``[N, H, W, C]`` float32 on the device) it names, with
    ``losses`` ``[n_batches, *loss shape]`` on the device.  On CUDA the
    step is captured once (:class:`_CapturedStep`) and replayed; a capture
    or replay that fails raises."""
    captured: List[_CapturedStep] = []
    step = lambda state, images: body(state, images, None)

    def epoch(state, dataset: torch.Tensor, idx):
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64).to(dataset.device)
        if dataset.device.type != "cuda":
            losses = []
            for row in idx:
                losses.append(step(state, dataset.index_select(0, row)))
                state.step += 1
            return state, torch.stack(losses)
        if not (captured and captured[0].matches(state, dataset, idx)):
            captured[:] = [_CapturedStep(state, dataset, idx)]
        return state, captured[0].run(step, idx)

    epoch.captured = captured  # the capture and its graph
    return epoch


def make_teacher_epoch_fn(diffusion_params, timesteps: int, ema_rate: Optional[float] = None):
    """The teacher's epoch lane (JAX ``make_teacher_epoch_fn``):
    ``epoch(state, dataset, idx) -> (state, losses)`` runs the teacher
    step of :func:`make_teacher_train_step` on each batch ``dataset[idx[i]]``
    with its draws from ``state.draws`` in the per-batch loop's order, so
    one seed gives the loop's batches, draws, losses and weights."""
    return _epoch_fn(_teacher_body(diffusion_params, timesteps, ema_rate))


def make_distill_epoch_fn(teacher_model: torch.nn.Module, teacher_diffusion_params,
                          teacher_steps: int, student_steps: int):
    """The distillation epoch lane (JAX ``make_distill_epoch_fn``): the
    step of :func:`make_distill_train_step` over an epoch, as
    :func:`make_teacher_epoch_fn` runs the teacher's."""
    return _epoch_fn(_distill_body(teacher_model, teacher_diffusion_params, teacher_steps,
                                   student_steps))


# --- The student group --------------------------------------------------------


@dataclasses.dataclass
class StackedTrainState:
    """Same-architecture students along a leading member axis: their
    weights and BatchNorm buffers stacked by name (``[N, ...]``, each row
    laid out as the member's own tensor), one Adam over the stacked weights
    (Adam is elementwise, so this is N Adams), the members' own
    :class:`TrainState`\\ s (draw sources, and the modules that
    :func:`unstack_train_state` fills) and the shared step count."""

    model: torch.nn.Module  # the architecture the rows run through
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    members: List[TrainState]
    step: int = 0

    def row(self, i: int) -> Dict[str, torch.Tensor]:
        """Member ``i``'s weights and buffers: views of row ``i``."""
        return {k: v[i] for k, v in (*self.params.items(), *self.buffers.items())}


def _stack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``[N, *shape]`` whose row ``i`` holds ``tensors[i]`` with its strides
    (a channels-last weight stays channels-last), so that a row runs the
    member's own kernels."""
    t0 = tensors[0]
    out = torch.empty_strided((len(tensors), *t0.shape), (t0.numel(), *t0.stride()),
                              dtype=t0.dtype, device=t0.device)
    for row, t in zip(out, tensors):
        row.copy_(t)
    return out


def stack_train_states(states: List[TrainState]) -> StackedTrainState:
    """Stack same-architecture :class:`TrainState`\\ s along a leading member
    axis (JAX ``state.py::stack_train_states``), Adam moments included."""
    models = [s.model for s in states]
    with torch.no_grad():
        params = {name: _stack([m.get_parameter(name) for m in models]).requires_grad_()
                  for name, _ in models[0].named_parameters()}
        buffers = {name: _stack([m.get_buffer(name) for m in models])
                   for name, _ in models[0].named_buffers()}
        opt0 = states[0].optimizer
        optimizer = type(opt0)(list(params.values()), **opt0.defaults)
        for name, p in params.items():
            per = [s.optimizer.state.get(s.model.get_parameter(name)) for s in states]
            if all(per):
                optimizer.state[p] = {"step": per[0]["step"].clone(),
                                      **{k: _stack([st[k] for st in per])
                                         for k in ("exp_avg", "exp_avg_sq")}}
    return StackedTrainState(model=models[0], params=params, buffers=buffers,
                             optimizer=optimizer, members=list(states), step=states[0].step)


def unstack_train_state(states: StackedTrainState, i: int) -> TrainState:
    """Member ``i`` of a stacked state (JAX ``state.py::unstack_train_state``):
    its :class:`TrainState`, whose model and Adam state are set to row ``i``
    of the stacked ones."""
    member = states.members[i]
    with torch.no_grad():
        for name, p in member.model.named_parameters():
            p.copy_(states.params[name][i])
            st = states.optimizer.state.get(states.params[name])
            if st:
                member.optimizer.state[p] = {
                    "step": st["step"].clone(),
                    **{k: st[k][i].clone() for k in ("exp_avg", "exp_avg_sq")}}
        for name, b in member.model.named_buffers():
            b.copy_(states.buffers[name][i])
    member.step = states.step
    return member


def _group_body(teacher_model: torch.nn.Module, teacher_diffusion_params, teacher_steps: int,
                student_steps: int) -> Callable:
    """The group's step body ``(states, images, draws) -> losses [N]``.

    Each member runs the sequential distillation step's arithmetic on its
    row of the stacked weights (``torch.func.functional_call``), drawing
    from its own source in the sequential order (``t`` and the noise, then
    the cond forward's dropout masks, then the uncond forward's); one
    backward of the members' summed losses gives each row its member's
    gradient, and one Adam step updates every row.  The BatchNorm
    buffers' rows are updated in place.  (A ``vmap`` of the member's loss
    batches the convolutions and so rounds them otherwise; Adam's first
    steps, which move each weight by about ±lr whatever its gradient, lift
    that rounding into the losses.)"""
    from torch.func import functional_call

    ratio = student_steps / teacher_steps
    teacher_fn = make_eval_model_fn(teacher_model)
    schedules: Dict[torch.device, Dict] = {}

    def body(states: StackedTrainState, images: torch.Tensor, draws=None):
        dp = _schedule(schedules, teacher_diffusion_params, images.device)
        b = images.shape[0]
        ones = images.new_ones((b, 1))
        zeros = images.new_zeros((b, 1))
        model = states.model.train()
        names = list(states.params)
        losses, weights = [], []
        for i, member in enumerate(states.members):
            d = member.draws.distill_step(images, teacher_steps)
            t_student = torch.floor(d.t * ratio).to(torch.int64)
            x_noisy, _ = q_sample(images, d.t, dp, noise=d.noises[0])
            teacher_cond = teacher_fn(x_noisy, d.t, ones, ones)
            teacher_uncond = teacher_fn(x_noisy, d.t, zeros, zeros)
            row = states.row(i)
            weights += [row[k] for k in names]
            student = lambda c: functional_call(model, row, (x_noisy, t_student, c, c),
                                                {"generator": d.generator})
            losses.append((_mse(student(ones), teacher_cond)
                           + _mse(student(zeros), teacher_uncond)) / 2.0)
        losses = torch.stack(losses)
        # Each member's gradients are taken at its rows and copied in, not
        # scattered through the stack (a zero-filled [N, ...] a member).
        grads = torch.autograd.grad(losses.sum(), weights)
        for p in states.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_copy_([states.params[k].grad[i] for i in range(len(states.members))
                              for k in names], grads)
        states.optimizer.step()
        return losses.detach()

    return body


def make_multi_distill_epoch_fn(teacher_model: torch.nn.Module, teacher_diffusion_params,
                                teacher_steps: int, student_steps: int):
    """The student group's epoch lane (JAX
    ``state.py::make_multi_distill_epoch_fn``): ``epoch(states, dataset,
    idx) -> (states, losses)`` for a :class:`StackedTrainState`, ``losses``
    ``[n_batches, N]``, one step (on CUDA, one captured graph) per batch for
    the whole group.

    Each member's arithmetic is the sequential trainer's: the shared batch
    order (one loader seed), its own draw stream and the same step, so a
    member ends where :func:`make_distill_epoch_fn` would have taken it."""
    return _epoch_fn(_group_body(teacher_model, teacher_diffusion_params, teacher_steps,
                                 student_steps))
