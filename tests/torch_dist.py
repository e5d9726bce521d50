"""Rank-side halves of the multi-device parity tests.

The tests spawn ``gloo`` process groups of 2 or 4 ranks on the CPU
(``parallel.launch.spawn_ranks``); each rank runs one of the functions
below.  Ranks import neither JAX nor the JAX package, so this module
doesn't either: what the JAX side draws or computes comes in as arguments
(numpy arrays, state dicts) and is compared in the test process.  Every
function returns what rank 0 (or every rank) saw, for the test to check.
"""

import copy
import dataclasses
import json
import os

import torch

from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import make_unet

KW = dict(dataset="MNIST", image_size=16, channels=1, batch_size=8, sample_steps=10,
          timesteps=10, epochs=1, compute_dtype="float32", dropout=0.0, device="cpu")


def config(**kw):
    return Config(**{**KW, **kw})


def model_from(cfg, size_factor, state_dict):
    model = make_unet(cfg, size_factor=size_factor, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


class Recorded:
    """A draw source that hands out recorded values in call order: the
    init state dict of ``init_unet`` and the returns of ``teacher_step``,
    ``distill_step`` and ``sample`` (each for the global batch)."""

    def __init__(self, calls):
        self.calls = list(calls)

    def _next(self, name):
        got, value = self.calls.pop(0)
        assert got == name, (got, name)
        return value

    def init_unet(self, config, size_factor):
        return model_from(config, size_factor, self._next("init_unet")).train()

    def teacher_step(self, images, timesteps):
        return self._next("teacher_step")

    def distill_step(self, images, timesteps):
        return self._next("distill_step")

    def sample(self, shape, n_steps):
        return self._next("sample")


class Recording:
    """Wraps a draw source and records what it hands out, for
    :class:`Recorded` to replay in the ranks."""

    def __init__(self, source):
        self.source, self.calls = source, []

    def _keep(self, name, value):
        self.calls.append((name, value))
        return value

    def init_unet(self, config, size_factor):
        model = self.source.init_unet(config, size_factor)
        self._keep("init_unet", {k: v.clone() for k, v in model.state_dict().items()})
        return model

    def teacher_step(self, images, timesteps):
        return self._keep("teacher_step", self.source.teacher_step(images, timesteps))

    def distill_step(self, images, timesteps):
        return self._keep("distill_step", self.source.distill_step(images, timesteps))

    def sample(self, shape, n_steps):
        return self._keep("sample", self.source.sample(shape, n_steps))


# --- test_torch_mesh ---------------------------------------------------------


def mesh_basics(rank, sd01):
    """The 2-rank checks of the mesh module: guards, collectives,
    column-parallel and data-axis BatchNorm gradients, and the gathered
    state dict of a sharded sf-0.1 U-Net."""
    import torch.distributed as dist

    from distillation_trajectories_torch.models.unet import BatchNorm2d
    from distillation_trajectories_torch.parallel import (
        make_global_mesh,
        mesh_from_config,
        shard_batch,
        shard_params,
    )
    from distillation_trajectories_torch.parallel.collectives import (
        all_gather_cat,
        gather_state_dict,
        mean_gradients,
    )
    from distillation_trajectories_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        axis_group,
        axis_size,
        gather_batch,
    )

    out = {}
    errors = {}
    for shape, kw in (((4, 1), {}), ((2, 1), dict(batch_size=7))):
        try:
            mesh_from_config(config(mesh_shape=shape, **kw))
        except ValueError as exc:
            errors[shape] = str(exc)
    out["errors"] = errors
    meshes = {shape: mesh_from_config(config(mesh_shape=shape)) for shape in ((2, 1), (1, 2))}
    out["sizes"] = {shape: (axis_size(m, DATA_AXIS), axis_size(m, MODEL_AXIS))
                    for shape, m in meshes.items()}
    g = make_global_mesh(model_parallel=2)
    out["global"] = (axis_size(g, DATA_AXIS), axis_size(g, MODEL_AXIS))

    data = meshes[(2, 1)]
    x = torch.arange(24.0).reshape(4, 6)
    out["rows"] = shard_batch(x, data).tolist()
    out["round_trip"] = torch.equal(gather_batch(shard_batch(x, data), data), x)
    out["gather_bf16"] = all_gather_cat(torch.full((2,), rank + 0.5, dtype=torch.bfloat16),
                                        axis_group(data, DATA_AXIS)).tolist()

    # Column parallelism on (1, 2): a conv + linear + norm pipeline, its
    # loss and every gradient against the unsharded one.
    gen = torch.Generator().manual_seed(3)
    net = torch.nn.Sequential(torch.nn.Conv2d(4, 6, 3, padding=1), BatchNorm2d(6),
                              torch.nn.ReLU(), torch.nn.Conv2d(6, 3, 1))
    for p in net.parameters():
        torch.nn.init.normal_(p, generator=gen)
    x = torch.randn((4, 4, 5, 5), generator=gen)

    def run(model, xs):
        xs = xs.clone().requires_grad_()
        y = model.train()(xs)
        loss = (y * y).mean()
        loss.backward()
        return loss.detach(), xs.grad

    dense = copy.deepcopy(net)
    want_loss, want_xgrad = run(dense, x)
    out["dense_grads"] = {k: p.grad.clone() for k, p in dense.named_parameters()}
    sharded = shard_params(copy.deepcopy(net), meshes[(1, 2)])
    loss, xgrad = run(sharded, x)
    out["column"] = dict(loss=(float(loss), float(want_loss)),
                         xgrad=float((xgrad - want_xgrad).abs().max()),
                         local_shapes={k: tuple(p.shape) for k, p in sharded.named_parameters()},
                         grads={k: p.grad.clone() for k, p in sharded.named_parameters()})

    # BatchNorm over the data axis on (2, 1): each rank its rows; the
    # gradients averaged over the axis are the unsharded ones.
    dp = shard_params(copy.deepcopy(net), data)
    xr = shard_batch(x, data)
    y = dp.train()(xr)
    ((y * y).mean()).backward()
    mean_gradients(dp, axis_group(data, DATA_AXIS))
    out["data_bn"] = dict(
        grads={k: p.grad.clone() for k, p in dp.named_parameters()},
        running={k: v.clone() for k, v in dp.state_dict().items()},
        dense_running={k: v.clone() for k, v in dense.state_dict().items()},
    )

    # The gathered state dict of an sf-0.1 U-Net sharded over (1, 2).
    cfg = config()
    unet = shard_params(model_from(cfg, 0.1, sd01), meshes[(1, 2)])
    out["unet_local"] = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    out["unet_gathered"] = gather_state_dict(unet)
    xb = torch.randn((2, 16, 16, 1), generator=gen)
    t = torch.tensor([3.0, 7.0])
    with torch.no_grad():
        out["unet_eval"] = unet.eval()(xb, t, torch.ones(2, 1), torch.ones(2, 1))
    out["unet_eval_input"] = (xb, t)
    out["dropout_steps"] = {shape: dropout_steps(meshes[shape]) for shape in meshes}
    dist.barrier()
    return out


def dropout_steps(mesh=None):
    """Two teacher steps of a seeded sf-0.25 U-Net with dropout 0.3 and the
    port's own draws (the masks from its generator), on ``mesh`` or
    unsharded: the losses and the (gathered) state dict."""
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.parallel import shard_batch, shard_train_state
    from distillation_trajectories_torch.parallel.collectives import gather_state_dict
    from distillation_trajectories_torch.training.state import (
        TorchDraws,
        create_train_state,
        make_teacher_train_step,
    )

    cfg = config(dropout=0.3)
    source = TorchDraws(0, "cpu")
    state = create_train_state(source.init_unet(cfg, 0.25), cfg, source)
    if mesh is not None:
        state = shard_train_state(state, mesh)
    step = make_teacher_train_step(get_diffusion_params(10, cfg), 10)
    images = torch.rand((2, 8, 16, 16, 1), generator=torch.Generator().manual_seed(1)) * 2 - 1
    losses = [float(step(state, images[i] if mesh is None else shard_batch(images[i], mesh))[1])
              for i in range(2)]
    return losses, (gather_state_dict(state.model) if mesh is not None
                    else {k: v.detach().clone() for k, v in state.model.state_dict().items()})


# --- test_torch_sharded_sweep ------------------------------------------------


def sharded_sweep(rank, sds, noise, step_noise, draws):
    """On (2, 1): the CFG chain of an sf-0.1 U-Net with its batch rows
    sharded (each rank its rows of the global draws, the trajectory
    gathered), and ``sweep_compare_trajectories`` with two jobs, one whose
    sample count the data axis divides and one it does not."""
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.diffusion.sampling import generate_trajectory_scan
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.parallel import mesh_from_config, shard_batch
    from distillation_trajectories_torch.parallel.mesh import gather_batch
    from distillation_trajectories_torch.trajectories import sweep_compare_trajectories_multi
    from distillation_trajectories_torch.training import make_eval_model_fn

    cfg = config(mesh_shape=(2, 1))
    mesh = mesh_from_config(cfg)
    teacher = model_from(cfg, 0.1, sds[0.1])
    local = generate_trajectory_scan(
        make_eval_model_fn(teacher), shard_batch(torch.from_numpy(noise), mesh), 10,
        get_diffusion_params(10, cfg)["alphas"], 0, guidance_scale=3.0,
        step_noise=shard_batch(torch.from_numpy(step_noise), mesh, dim=1))
    traj = gather_batch(local, mesh, dim=1)

    cfg = dataclasses.replace(cfg, image_size=32)  # 1,024 pixels: the Wasserstein subsample acts
    teacher, student = (model_from(cfg, sf, sds[sf]) for sf in (1.0, 0.1))
    cfg_engine_update.launches = 0
    results = sweep_compare_trajectories_multi(teacher, [
        {"students": {0.1: student}, "guidance_scales": (1.0, 3.0), "num_samples": 4,
         "base_seed": 42, "timesteps": 6, "draws": draws},
        {"students": {0.1: student}, "guidance_scales": (3.0,), "num_samples": 3,
         "base_seed": 7, "timesteps": 6},
    ], cfg, verbose=False)
    return dict(traj=traj, results=results, launches=cfg_engine_update.launches)


# --- test_torch_mesh_training ------------------------------------------------


def _metrics(path):
    with open(path) as f:
        return [rec["avg_loss"] for rec in map(json.loads, f) if "avg_loss" in rec]


def mesh_training(rank, runs):
    """``train_teacher`` and ``distill_diffusion_model`` on each mesh of
    ``runs`` (``[(kind, mesh_shape, base_dir, config kwargs, recorded
    calls, teacher state dict)]``): rank 0 returns each run's per-epoch
    losses, gathered parameters and, with ``checkpoint_sharded``, the
    gathered state it saved."""
    from distillation_trajectories_torch.parallel.collectives import gather_state_dict
    from distillation_trajectories_torch.training import train_teacher
    from distillation_trajectories_torch.training.students import distill_diffusion_model

    out = []
    for kind, shape, base_dir, kw, calls, teacher_sd in runs:
        cfg = config(mesh_shape=shape, base_dir=base_dir, **kw).create_directories()
        source = lambda seed, device, calls=calls: Recorded(calls)
        if kind == "teacher":
            model = train_teacher(cfg, seed=0, draws=source).model
            metrics = os.path.join(cfg.results_dir, "teacher_metrics.jsonl")
        else:
            teacher = model_from(cfg, 0.5, teacher_sd)
            model = distill_diffusion_model(teacher, cfg, size_factor=0.25, seed=0, draws=source)
            metrics = os.path.join(cfg.results_dir, "distill_metrics_size_0.25.jsonl")
        state = gather_state_dict(model)
        local = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        out.append(dict(losses=_metrics(metrics) if rank == 0 else None, state=state,
                        local_shapes=local))
    return out


# --- test_torch_checkpoints_sharded ------------------------------------------


def sharded_checkpoint(rank, base_dir, sd):
    """An sf-0.25 U-Net with Adam state and EMA on (1, 2): written with
    ``save_checkpoint_sharded``, read back by every rank into
    ``abstract_target`` (its own shards), and the gathered state for the
    test to hold the topology-free read to."""
    from distillation_trajectories_torch.parallel import mesh_from_config, shard_train_state
    from distillation_trajectories_torch.parallel.collectives import (
        gather_named,
        gather_optimizer_state,
        gather_state_dict,
    )
    from distillation_trajectories_torch.training import (
        abstract_target,
        available_epochs,
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )
    from distillation_trajectories_torch.training.state import TorchDraws, create_train_state

    cfg = config(mesh_shape=(1, 2))
    model = model_from(cfg, 0.25, sd).train()
    state = shard_train_state(create_train_state(model, cfg, TorchDraws(0, "cpu"), use_ema=True),
                              mesh_from_config(cfg))
    x = torch.randn((4, 16, 16, 1), generator=torch.Generator().manual_seed(1))
    loss = (model(x, torch.tensor([1.0, 2.0, 3.0, 4.0])) ** 2).mean()
    loss.backward()
    state.optimizer.step()
    state.ema = {k: v * 0.5 for k, v in state.ema.items()}
    save_checkpoint_sharded(base_dir, 3, model, optimizer=state.optimizer, ema=state.ema,
                            extra={"note": "ranks"})
    target = load_checkpoint_sharded(base_dir, 3,
                                     target=abstract_target(model, state.optimizer, state.ema))
    mine = {k[len("state/"):]: v for k, v in target.items() if k.startswith("state/")}
    local_equal = all(torch.equal(mine[k].to_local() if hasattr(mine[k], "to_local") else mine[k],
                                  v.detach()) for k, v in model.state_dict().items())
    return dict(state=gather_state_dict(model), adam=gather_optimizer_state(model, state.optimizer),
                ema=gather_named(model, state.ema), local_equal=local_equal,
                epochs=available_epochs(base_dir))


# --- test_torch_spatial ------------------------------------------------------


def spatial_forwards(rank, cases, sd01, traj_args):
    """The spatially partitioned forward on each ``(mesh, x, t, cond)`` of
    ``cases`` (every rank the whole result), the height guard, and — on a
    (1, 2) world — ``generate_trajectory`` and masked inpainting under
    ``Config.spatial_shape``."""
    from distillation_trajectories_torch.editing import apply_masked_inpainting
    from distillation_trajectories_torch.parallel import (
        make_spatial_eval_fn,
        make_spatial_mesh,
        shard_batch_spatial,
    )
    from distillation_trajectories_torch.trajectories import generate_trajectory

    cfg = config()
    model = model_from(cfg, 0.1, sd01)
    out = {"forwards": []}
    for shape, x, t, cond in cases:
        fn = make_spatial_eval_fn(model, make_spatial_mesh(shape, "cpu"))
        c = None if cond is None else torch.from_numpy(cond)
        out["forwards"].append(fn(torch.from_numpy(x), torch.from_numpy(t), c, c))
    mesh = make_spatial_mesh(cases[0][0], "cpu")
    try:
        shard_batch_spatial(torch.zeros((2, 15, 16, 1)), mesh)
    except ValueError as exc:
        out["guard"] = str(exc)
    if traj_args is not None:
        x, image = traj_args
        sp = dataclasses.replace(cfg, spatial_shape=cases[0][0])
        out["traj"] = generate_trajectory(model, torch.from_numpy(x), 10, seed=3,
                                          guidance_scale=2.0, config=sp)
        out["inpainted"] = apply_masked_inpainting(model, sp, image, seed=2,
                                                   record_trajectory=False)["inpainted_image"]
    return out


# --- test_torch_cuda ---------------------------------------------------------


def sharded_chain_on_card(rank, sd, noise, step_noise):
    """The CFG chain of an sf-0.1 U-Net with its rows over (2, 1), two
    ranks sharing the card (float32, TF32 off): the gathered trajectory
    and this rank's kernel launches."""
    from distillation_trajectories_torch.diffusion import get_diffusion_params
    from distillation_trajectories_torch.diffusion.sampling import generate_trajectory_scan
    from distillation_trajectories_torch.ops.cfg_update import cfg_engine_update
    from distillation_trajectories_torch.parallel import mesh_from_config, shard_batch
    from distillation_trajectories_torch.parallel.mesh import gather_batch
    from distillation_trajectories_torch.training import make_eval_model_fn

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config(mesh_shape=(2, 1), device="cuda")
    mesh = mesh_from_config(cfg)
    model = model_from(cfg, 0.1, sd).cuda()
    cfg_engine_update.launches = 0
    local = generate_trajectory_scan(
        make_eval_model_fn(model), shard_batch(noise, mesh).cuda(), 10,
        get_diffusion_params(10, cfg)["alphas"], 0, guidance_scale=3.0,
        step_noise=shard_batch(step_noise, mesh, dim=1).cuda())
    traj = gather_batch(local, mesh, dim=1)
    torch.cuda.synchronize()
    return dict(traj=traj.cpu(), launches=cfg_engine_update.launches)
