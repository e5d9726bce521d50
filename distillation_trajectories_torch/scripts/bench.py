"""Benchmark: trajectories/s of 50-step CFG sampling on one card (the port's
counterpart of the repository's ``bench.py``).

    python -m distillation_trajectories_torch.scripts.bench
    python -m distillation_trajectories_torch.scripts.bench --device cpu --batch 2 \\
        --timesteps 4 --size_factor 0.05 --image_size 16 --pairs 2

Prints ONE JSON line on stdout: ``metric``, ``value`` (traj/s), ``unit``,
``vs_baseline``, ``preflight``, the card's name and power limit
(``card``), every timed call's seconds (``seconds``; the eager chain's in
``eager_seconds``), the metric suite's pairs/s and the baseline's source.

Workload (``BASELINE.json``): the sf-1.0 U-Net of ``make_unet(seed=0)``,
32x32x3, batch 256, T=50 reverse steps of the engine sampler with
two-forward CFG at guidance 3.0, bf16 compute, every step's update tail
the Triton kernel with the CFG combine fused in.  That is the port's one
tail, whatever ``Config.pallas_cfg_update`` says, and the record and the
ledger line name it as ``use_pallas: true`` (:data:`USE_PALLAS`).  The
chain is the makers' compiled chain, as the JAX bench times its jitted
one: on the card a CUDA graph captured during the warm-up and replayed
(``diffusion/sampling.py::make_batch_chain_fn``).  Method: two warm-up
chains (the first eager, the second the capture), then ``--iters`` timed
chains, each with a fresh seed and ended by ``torch.cuda.synchronize()``;
``value`` is batch x iters over their summed seconds.  Then the eager
chain on the same seeds, its seconds kept as ``eager_seconds`` beside
``seconds``.  Each chain's step noise is drawn inside its timed call, as
the JAX bench draws it inside its jitted chain.  The metric suite's pairs/s
(``batch_metrics_core`` over 256 pairs at T=50) is the best of 3 trials,
each with fresh Wasserstein subsample keys.

``vs_baseline`` divides by a CPU figure: the reference U-Net of the module
directory that ``DTT_REFERENCE_DIR`` names, where that imports; else the
port's own ``DiffusionUNet`` (the reference's module names, loaded from
its state dicts strictly) in float32 on this host's CPU, batch 2, the
per-forward time the best of 5 batches of 3 forwards, extrapolated to a
T-step trajectory.  It is cached in ``.bench_baseline_torch.json``; the JAX
bench's ``.bench_baseline.json`` (a figure from the TPU host) is never read.

Every measurement is appended to ``.bench_ledger_torch.jsonl``.  When the
preflight finds no card, the last healthy record is printed marked
``stale: true`` with its age, and the process exits 3.  The device work
runs in one child process under ``--timeout`` seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

from ._common import BenchDraws, add_bench_flags, preflight_probe, project_root, timed_calls

T_STEPS = 50
BATCH = 256
GUIDANCE = 3.0
ITERS = 5
PAIRS = 256
USE_PALLAS = True  # the update tail the chain runs: the CFG combine fused into the kernel
CACHE = os.path.join(project_root, ".bench_baseline_torch.json")
LEDGER = os.path.join(project_root, ".bench_ledger_torch.jsonl")
METRIC_NAME = ("trajectories/sec/card (50-step CFG sampling, 32x32 teacher U-Net, "
               "PyTorch port)")
# Ledger statuses of healthy measurements: "ok" (a card), "up" and a missing
# preflight (the oldest records of the JAX bench's ledger, whose format
# this one keeps).
_HEALTHY = ("ok", "up", None)


def _ledger_append(record: dict) -> None:
    try:
        with open(LEDGER, "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError as e:
        print(f"# ledger append failed: {e}", file=sys.stderr)


def _ledger_last():
    """The most recent healthy measurement, or None: records whose
    preflight status is not healthy (a host run, a down card) are passed
    over, and a corrupt ledger gives None."""
    try:
        with open(LEDGER) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        for ln in reversed(lines):
            rec = json.loads(ln)
            if (rec.get("preflight") or {}).get("status") in _HEALTHY:
                return rec
        return None
    except (OSError, json.JSONDecodeError):
        return None


def _emit_stale_and_exit(reason: str) -> None:
    """Print the last healthy measurement marked ``stale: true`` with its
    age (or ``value: null`` without one) and exit 3: never a fresh-looking
    number."""
    last = _ledger_last()
    if last is None:
        print(f"# no measurement possible and no ledger history: {reason}", file=sys.stderr)
        print(json.dumps({"metric": METRIC_NAME, "value": None, "unit": "trajectories/s",
                          "vs_baseline": None, "stale": True, "error": reason}))
        sys.exit(3)
    age_s = round(time.time() - last.get("ts", 0.0), 1)
    print(f"# STALE: emitting last-known-good measurement from {last.get('ts_iso', '?')} "
          f"({age_s}s ago); reason: {reason}", file=sys.stderr)
    print(json.dumps({
        "metric": METRIC_NAME,
        "value": last.get("value"),
        "unit": "trajectories/s",
        "vs_baseline": last.get("vs_baseline"),
        "stale": True,
        "stale_age_s": age_s,
        "stale_recorded_at": last.get("ts_iso"),
        "error": reason,
        "preflight": last.get("preflight"),
    }))
    sys.exit(3)


def bench_main_path(args, draws=None):
    """traj/s of the main path's compiled chain: ``(value, per-call
    seconds, the last timed chain [T+1, batch, H, W, C], the eager chain's
    per-call seconds)``.  The chain is the makers' (on the card a CUDA
    graph: its first warm-up call runs eagerly, the second captures), timed
    as the JAX bench times its jitted chain; then its eager body on the
    same seeds."""
    from ..config import Config, resolve_device
    from ..diffusion import get_diffusion_params
    from ..diffusion.sampling import CFG_COND_PAIRS, make_batch_chain_fn
    from ..models import make_unet
    from ..training import make_eval_model_fn
    from ..utils.graphs import sampler_lane_captures

    dev = resolve_device(args.device)
    draws = draws or BenchDraws(dev)
    config = Config(timesteps=args.timesteps, sample_steps=args.timesteps,
                    image_size=args.image_size, compute_dtype=args.compute_dtype,
                    device=str(dev))
    model_fn = make_eval_model_fn(make_unet(config, size_factor=args.size_factor, seed=0))
    alphas = get_diffusion_params(args.timesteps, config)["alphas"]
    shape = (args.batch, args.image_size, args.image_size, config.channels)
    noise = draws.noise(1, shape).to(dev)
    chain = make_batch_chain_fn(model_fn, args.timesteps, alphas, captures=sampler_lane_captures)
    out = []

    def call(seed, eager=False):
        return chain(noise, None, CFG_COND_PAIRS, GUIDANCE, eager=eager,
                     step_noise=draws.step_noise(seed, args.timesteps, shape)).transpose(0, 1)

    def run(seed):
        out[:] = [call(seed)]

    # Warm-up: the Triton build and cuDNN's choices, then the capture.
    timed_calls(run, [0, 0], dev)
    seconds = timed_calls(run, range(1, args.iters + 1), dev)
    eager_seconds = timed_calls(lambda seed: call(seed, eager=True),
                                range(1, args.iters + 1), dev)
    return args.batch * args.iters / sum(seconds), seconds, out[0], eager_seconds


def bench_metric_suite(args, draws=None):
    """pairs/s of the metric suite over ``args.pairs`` pairs of T+1 states
    (best of 3 trials, fresh subsample keys each) and each metric's sum
    over the pairs in the last trial (the JAX bench sums them so that no
    metric is left out of the measured work)."""
    import torch

    from ..config import resolve_device
    from ..metrics.trajectory_metrics import batch_metrics_core

    dev = resolve_device(args.device)
    draws = draws or BenchDraws(dev)
    s, n = args.pairs, args.timesteps + 1
    shape = (s, n, args.image_size, args.image_size, 3)
    t_trajs = draws.noise(0, shape).to(dev)
    s_trajs = t_trajs + 0.1
    d = t_trajs[0, 0].numel()
    sums = {}

    def run(key):
        out = batch_metrics_core(t_trajs, s_trajs, draws.uniforms(key, s, n, d).to(dev))
        stacked = torch.stack([v.float().sum() for v in out.values()]).cpu().tolist()
        sums.clear()
        sums.update(zip(out, stacked))

    timed_calls(run, [0], dev)
    seconds = timed_calls(run, [1, 2, 3], dev)
    return s / min(seconds), dict(sums)


def _reference_unet(size_factor):
    """The reference U-Net (``models.DiffusionUNet`` of the module directory
    ``DTT_REFERENCE_DIR`` names) in eval mode, or None when the variable is
    unset or the import fails (said on stderr).  The directory leaves
    ``sys.path`` again, and its modules leave ``sys.modules``."""
    ref_dir = os.environ.get("DTT_REFERENCE_DIR")
    if not ref_dir:
        return None
    root = os.path.join(os.path.abspath(ref_dir), "")
    before = set(sys.modules)
    sys.path.insert(0, ref_dir)
    try:
        from models import DiffusionUNet as RefUNet

        class _Cfg:
            channels = 3
            dropout = 0.3

        return RefUNet(_Cfg(), size_factor=size_factor).eval()
    except Exception as e:  # the port's own U-Net stands in, on record
        print(f"# reference U-Net import failed ({e}); timing the port's", file=sys.stderr)
        return None
    finally:
        sys.path.remove(ref_dir)
        for name in set(sys.modules) - before:
            mod = sys.modules[name]
            where = [getattr(mod, "__file__", None), *(getattr(mod, "__path__", None) or ())]
            if any(p and os.path.abspath(p).startswith(root) for p in where):
                del sys.modules[name]


def bench_reference_cpu(args):
    """Reference trajectories/s on this host's CPU and its source: the
    reference U-Net's (``DTT_REFERENCE_DIR``) or the port's float32
    ``DiffusionUNet`` fused-CFG forward at batch 2, extrapolated to T
    steps.  The per-forward time is the least of 5 batches of 3 forwards:
    on a shared host, contention only ever makes the forward look slower."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 8)
    x = torch.randn(2, args.image_size, args.image_size, 3)
    t = torch.tensor([25, 25])
    c = torch.cat([torch.zeros(1, 1), torch.ones(1, 1)])
    model, call, source = _reference_unet(args.size_factor), None, None
    if model is not None:
        xr = x.permute(0, 3, 1, 2).contiguous()
        call = lambda: model(xr, t, c)
        source = (f"reference U-Net ({os.environ['DTT_REFERENCE_DIR']}), float32, host CPU, "
                  "batch 2")
    else:
        from ..config import Config
        from ..models import make_unet

        cfg = Config(device="cpu", compute_dtype="float32", image_size=args.image_size)
        model = make_unet(cfg, size_factor=args.size_factor, seed=0).eval()
        call = lambda: model(x, t, c, torch.ones_like(c))
        source = "port DiffusionUNet (reference module names), float32, host CPU, batch 2"
    try:
        with torch.no_grad():
            for _ in range(2):
                call()
            n, k = 3, 5
            step_time = math.inf
            for _ in range(k):
                t0 = time.perf_counter()
                for _ in range(n):
                    call()
                step_time = min(step_time, (time.perf_counter() - t0) / n)
    finally:
        torch.set_num_threads(threads)
    traj_per_sec = 1.0 / (args.timesteps * step_time)
    with open(CACHE, "w") as f:
        json.dump({"ref_traj_per_sec_cpu": traj_per_sec, "source": source,
                   "method": f"best-of-{k} batches of {n} forwards",
                   "ts_iso": time.strftime("%Y-%m-%dT%H:%M:%S+0000", time.gmtime())}, f)
    return traj_per_sec, source


def measure(args, draws=None) -> dict:
    """The device half: the main path's traj/s and the metric suite's pairs/s."""
    import torch

    ours, seconds, traj, eager_seconds = bench_main_path(args, draws)
    pairs_per_s, sums = bench_metric_suite(args, draws)
    if not bool(torch.isfinite(traj).all()):
        raise RuntimeError("the main path's chain is not finite")
    return {"ours": ours, "seconds": seconds, "eager_seconds": eager_seconds,
            "pairs_per_s": pairs_per_s, "metric_sums": sums}


def finish(args, result: dict, preflight: dict) -> dict:
    """The record of a measurement: the CPU baseline, the ledger line."""
    with contextlib.redirect_stdout(sys.stderr):  # a reference constructor may print
        ref, source = bench_reference_cpu(args)
    ours = result["ours"]
    vs = ours / ref if ref and math.isfinite(ref) else None
    record = {
        "metric": METRIC_NAME,
        "value": round(ours, 3),
        "unit": "trajectories/s",
        "vs_baseline": round(vs, 2) if vs else None,
        "preflight": preflight,
        "card": preflight.get("detail") if preflight.get("status") == "ok" else None,
        "device": args.device,
        "use_pallas": USE_PALLAS,
        "seconds": result["seconds"],
        "eager_seconds": result["eager_seconds"],
        "pairs_per_s": round(result["pairs_per_s"], 1),
        "baseline_traj_per_s": ref,
        "baseline_source": source,
        "workload": {"batch": args.batch, "timesteps": args.timesteps, "guidance": GUIDANCE,
                     "size_factor": args.size_factor, "image_size": args.image_size,
                     "compute_dtype": args.compute_dtype, "iters": args.iters,
                     "pairs": args.pairs},
    }
    _ledger_append({
        "ts": time.time(),
        "ts_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "value": record["value"],
        "vs_baseline": record["vs_baseline"],
        "pairs_per_s": record["pairs_per_s"],
        "seconds": record["seconds"],
        "eager_seconds": record["eager_seconds"],
        "card": record["card"],
        "use_pallas": record["use_pallas"],
        "preflight": preflight,
    })
    return record


def run(args, draws=None) -> dict:
    """The whole measurement in this process: preflight (the stale exit
    when it finds no card), device half, baseline, ledger; returns the
    record."""
    probe = preflight_probe(args.device)
    if probe["status"] == "down":
        _emit_stale_and_exit(f"no card: {probe['detail']}")
    return finish(args, measure(args, draws), probe)


def _device_child(args) -> dict:
    """``measure`` in a child process, killed at ``args.timeout`` seconds."""
    cmd = [sys.executable, "-m", "distillation_trajectories_torch.scripts.bench",
           "--device-bench", *args.argv]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, timeout=args.timeout, cwd=project_root)
    if proc.returncode != 0:
        raise RuntimeError(f"the device bench exited {proc.returncode}")
    for line in reversed(proc.stdout.decode().splitlines()):
        if line.strip().startswith("{"):
            return json.loads(line)
    raise RuntimeError("the device bench printed no record")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--timesteps", type=int, default=T_STEPS)
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("--pairs", type=int, default=PAIRS)
    parser.add_argument("--size_factor", type=float, default=1.0)
    parser.add_argument("--image_size", type=int, default=32)
    add_bench_flags(parser, base_dir=False)  # without a card, cuda is the stale exit
    parser.add_argument("--timeout", type=float, default=900.0,
                        help="Seconds the device child may take")
    parser.add_argument("--device-bench", dest="device_bench", action="store_true",
                        help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    args.argv = [a for a in argv if a != "--device-bench"]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device_bench:
        with contextlib.redirect_stdout(sys.stderr):
            result = measure(args)
        print(json.dumps(result))
        return 0
    probe = preflight_probe(args.device)
    print(f"# preflight: {probe['status']} ({probe['detail']})", file=sys.stderr)
    if probe["status"] == "down":
        _emit_stale_and_exit(f"no card: {probe['detail']}")
    record = finish(args, _device_child(args), probe)
    print(f"# metric-suite: {record['pairs_per_s']} trajectory-pairs/s (T={args.timesteps})",
          file=sys.stderr)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
