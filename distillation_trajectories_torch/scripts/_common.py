"""Flags and checkpoint loaders shared by the port's CLIs.

Each CLI joins the process group a launcher names (``torchrun``) at the
start; ``--mesh D,M`` and ``--spatial D,S`` then need ``D·M`` (``D·S``)
ranks, for example::

    torchrun --nproc_per_node=2 -m distillation_trajectories_torch.scripts.train_teacher \
        --device cpu --mesh 2,1 --checkpoint_sharded

The benches (``bench*.py``) share the device preflight, their draws, their
chains' maker, a timer of calls and the Block sizes of the int8 lane's
mixed set.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

from ..parallel.mesh import require_ranks

project_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Override the output root directory")
    parser.add_argument("--limit_batches", type=int, default=None,
                        help="Cap batches per epoch (smoke runs)")
    parser.add_argument("--num_samples", type=int, default=None,
                        help="Samples in the sample grid (0 skips grid generation)")
    parser.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                        help="(data, model) mesh over the launched ranks, e.g. '2,1' "
                        "(torchrun --nproc_per_node=2). Default: one device")
    parser.add_argument("--checkpoint_sharded", action="store_true",
                        help="Write model_epoch_{e}.dcp sharded checkpoints (every rank "
                        "its shards). Default stays the msgpack contract")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to train on (default: the config's, cuda)")


def parse_axes(text: str, flag: str = "--mesh"):
    """``'D,M'`` (or ``'D'``, for ``D,1``) as two positive ints."""
    parts = [int(x) for x in text.split(",")]
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2 or parts[0] < 1 or parts[1] < 1:
        raise SystemExit(f"{flag} must be two positive ints 'A,B', got {text!r}")
    return parts[0], parts[1]


def start_distributed(config) -> bool:
    """Join the launcher's process group, if one is named: gloo for a CPU
    run, else the backend ``parallel.distributed.choose_backend`` picks."""
    import torch

    from ..parallel import initialize_distributed

    cpu = torch.device(config.device).type == "cpu"
    return initialize_distributed(backend="gloo" if cpu else None)


def report_device(config) -> None:
    """Print the device a CLI runs on and whether CUDA sees a card (under
    ``run_on_cpu`` it must not)."""
    import torch

    print(f"[device] {config.device}; torch.cuda.is_available()={torch.cuda.is_available()}",
          flush=True)


def make_config(args):
    """A Config from parsed flags, in the launcher's process group."""
    from ..config import Config

    config = Config(base_dir=args.base_dir) if args.base_dir else Config()
    if args.device is not None:
        config.device = args.device
    if args.mesh:
        config.mesh_shape = parse_axes(args.mesh)
    config.checkpoint_sharded = bool(args.checkpoint_sharded)
    start_distributed(config)
    if args.mesh:
        require_ranks(config.mesh_shape, "--mesh")
    for flag, field in (("noise_schedule", "noise_schedule"), ("dropout", "dropout"),
                        ("sample_mode", "sample_mode"), ("epochs", "epochs"),
                        ("dataset", "dataset"), ("image_size", "image_size"),
                        ("batch_size", "batch_size"), ("limit_batches", "limit_batches_per_epoch"),
                        ("num_samples", "num_samples_to_generate")):
        value = getattr(args, flag, None)
        if value is not None:
            setattr(config, field, value)
    if getattr(args, "full_res_head", False):
        config.full_res_head = True
    if getattr(args, "timesteps", None) is not None:
        config.timesteps = config.sample_steps = args.timesteps
        config.teacher_steps = config.student_steps = args.timesteps
    report_device(config)
    return config.create_directories()


def add_model_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--dataset", type=str, default=None, choices=["MNIST", "CIFAR10"])
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--timesteps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--noise_schedule", type=str, default=None, choices=["linear", "cosine"])
    parser.add_argument("--dropout", type=float, default=None)
    parser.add_argument("--full_res_head", action="store_true",
                        help="Use the enc1-skip full-resolution decoder head")
    parser.add_argument("--sample_mode", type=str, default=None,
                        choices=["reference", "ancestral"])


def add_analysis_flags(parser: argparse.ArgumentParser) -> None:
    """The port's flags of every analysis CLI, beside the JAX CLI's own."""
    parser.add_argument("--dataset", type=str, default=None, choices=["MNIST", "CIFAR10"])
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--num_channels", type=int, default=None)
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Override the output root directory "
                        "(checkpoints are read from <base_dir>/output/models)")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on (default: the config's, cuda)")


def analysis_config(args, timesteps=None):
    """The Config of an analysis CLI, its directories created, on the
    resolved device (raises when that is CUDA and no GPU exists).

    As in the JAX CLIs, ``timesteps`` sets ``config.timesteps`` alone:
    ``teacher_steps`` and ``student_steps`` keep the value the Config was
    built with (100 by default), and the trajectory manager's chains run
    on ``teacher_steps``."""
    from ..config import Config, resolve_device

    config = Config(base_dir=args.base_dir) if args.base_dir else Config()
    if args.device is not None:
        config.device = args.device
    if args.dataset:
        config.dataset = args.dataset
    if args.image_size:
        config.image_size = args.image_size
    if args.num_channels:
        config.channels = args.num_channels
    if timesteps:
        config.timesteps = timesteps
    resolve_device(config.device)
    report_device(config)
    return config.create_directories()


def resolve_output_dir(config, output_dir: str) -> str:
    """``output_dir``, a relative one taken against the config's
    ``base_dir`` (the checkout root unless ``--base_dir`` is given)."""
    if os.path.isabs(output_dir):
        return output_dir
    return os.path.join(config.base_dir, output_dir)


def load_teacher_from_arg(config, teacher_model_arg=None):
    """The sf-1.0 teacher on ``config.device``, in eval mode, from the
    checkpoint a ``--teacher_model`` name gives (``model_epoch_N``, with any
    extension), or the latest one."""
    import re

    from ..training.students import load_teacher

    epoch = None
    if teacher_model_arg:
        m = re.search(r"model_epoch_(\d+)", teacher_model_arg)
        if m:
            epoch = int(m.group(1))
    return load_teacher(config, epoch)


def load_student(config, size_factor, epoch=None):
    """The student of ``size_factor`` on ``config.device``, in eval mode,
    from its latest (or given-epoch) checkpoint; ``FileNotFoundError``
    when it has none."""
    from ..models import load_unet_variables, make_unet
    from ..training.checkpoints import load_checkpoint, variables_from_checkpoint

    payload = load_checkpoint(config.student_dir(size_factor), epoch)
    model = make_unet(config, size_factor=size_factor)
    return load_unet_variables(model, variables_from_checkpoint(payload)).eval()


def load_model(config, directory, size_factor=1.0):
    """The U-Net of ``size_factor`` from the latest checkpoint in
    ``directory``, on ``config.device``, in eval mode."""
    from ..models import load_unet_variables, make_unet
    from ..training.checkpoints import load_checkpoint, variables_from_checkpoint

    model = make_unet(config, size_factor=size_factor)
    return load_unet_variables(model, variables_from_checkpoint(load_checkpoint(directory))).eval()


def parse_float_list(s):
    return [float(x) for x in s.split(",") if x.strip()]


def plots_available() -> bool:
    """Whether matplotlib imports.  Where it does not (the GPU machine has
    none), a CLI's ``main`` says so and skips its plots; what ``run``
    computed and wrote stands."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("[plots] matplotlib cannot be imported: plots skipped")
        return False
    return True


def card_line(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or the reason they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(index)],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"
    return out.stdout.strip().splitlines()[0]


def preflight_probe(device="cuda") -> dict:
    """The device a run measures on: ``status`` ``ok`` (a card, with its
    name, memory, count and ``detail``, the ``nvidia-smi`` name and power
    limit), ``down`` (CUDA asked for and no card) or ``skipped`` (a host
    device: nothing to probe)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"status": "skipped", "device": str(dev), "detail": "host device"}
    if not torch.cuda.is_available():
        return {"status": "down", "device": str(dev),
                "detail": "torch.cuda.is_available() is False"}
    index = dev.index or 0
    props = torch.cuda.get_device_properties(index)
    return {"status": "ok", "device": str(dev), "name": props.name,
            "total_memory_bytes": int(props.total_memory),
            "count": torch.cuda.device_count(), "detail": card_line(index)}


def block_sizes(image_size: int) -> dict:
    """Each U-Net Block's spatial size at ``image_size`` (32 → 16 → 8 → 4 → 2
    and back up)."""
    hw = image_size
    return {"enc1": hw, "enc2": hw // 2, "enc3": hw // 4, "enc4": hw // 8,
            "bottleneck": hw // 16, "dec3": hw // 8, "dec2": hw // 4, "dec1": hw // 2}


def mixed_blocks(image_size: int) -> set:
    """The int8 lane's mixed set: the Blocks working at 8x8 or more.  The
    4x4 and 2x2 levels are latency-bound, and requantizing them costs more
    than their int8 products save."""
    return {name for name, hw in block_sizes(image_size).items() if hw >= 8}


def add_bench_flags(parser: argparse.ArgumentParser, base_dir: bool = True) -> None:
    """The port's flags of every bench, beside the JAX bench's own
    (``--base_dir`` only where the bench reads or writes under it)."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to measure on (cuda raises without a GPU)")
    if base_dir:
        parser.add_argument("--base_dir", type=str, default=None,
                            help="Output root (checkpoints under <base_dir>/output/models)")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])


class BenchDraws:
    """The benches' random draws on ``device``, keyed by integers where the
    JAX benches key theirs with ``PRNGKey``: a starting ``noise(key,
    shape)`` from the generator of ``(key, 0)``; a chain's ``step_noise(seed,
    timesteps, shape)`` as the engine sampler draws it by default (step t
    from ``(seed, t)``); the metric suite's Wasserstein ``uniforms(key,
    pairs, n, d)``.  Tests pass an object with the same three methods that
    makes the JAX draws."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)

    def noise(self, key: int, shape):
        from ..diffusion.sampling import seeded_normal

        return seeded_normal([(key, 0)], shape, self.device)[0]

    def step_noise(self, seed: int, timesteps: int, shape):
        from ..diffusion.sampling import draw_step_noise

        return draw_step_noise([seed], timesteps, shape, self.device)[:, 0]

    def uniforms(self, key: int, pairs: int, n: int, d: int):
        import torch

        gen = torch.Generator(device=self.device).manual_seed(int(key))
        return torch.rand((pairs, n, d), generator=gen, device=self.device)


def chain_fn(config, draws, steps, fn):
    """``run(noise, seed, guidance_scale=None, use_cfg=None, eager=False) ->
    [steps+1, ...]``: the engine chain of the model forward ``fn`` at
    ``steps`` through its maker (on the card captured after one eager
    warm-up of its input signature and replayed; with ``eager=True`` its
    body run eagerly), with the step noise of ``draws``; ``run.maker`` is
    the maker."""
    from ..diffusion import get_diffusion_params
    from ..diffusion.sampling import make_chain_fn
    from ..utils.graphs import sampler_lane_captures

    chain = make_chain_fn(fn, steps, get_diffusion_params(steps, config)["alphas"],
                          captures=sampler_lane_captures)

    def run(noise, seed, guidance_scale=None, use_cfg=None, eager=False):
        return chain(noise, seed, guidance_scale, use_cfg,
                     step_noise=draws.step_noise(seed, steps, tuple(noise.shape)), eager=eager)

    run.maker = chain
    return run


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_calls(fn, seeds, device) -> list:
    """Wall seconds of ``fn(seed)`` for each seed, each call ended by a
    device synchronization (the barrier; nothing is read back)."""
    seconds = []
    for seed in seeds:
        synchronize(device)
        t0 = time.perf_counter()
        fn(seed)
        synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return seconds


def write_json(path: str, record: dict) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return path
