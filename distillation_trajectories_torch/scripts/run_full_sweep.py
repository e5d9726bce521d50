"""The full reference-default workload, timed end to end (port of
``scripts/run_full_sweep.py``): each stage runs one of the port's CLIs as
``python -m distillation_trajectories_torch.scripts.<cli>`` in a subprocess.

Stages (the CLIs' defaults unless a flag below says otherwise):
1. teacher training, ``train_teacher``, 10 epochs;
2. student distillation, ``train_students``, 5 epochs over the 13 size
   factors of :data:`SIZE_FACTORS` (retried with ``--skip_existing``);
3. and 4. the CFG trajectory-metric sweep (job ``heatmaps``: the CLI's 8
   sizes × 10 guidance scales × 10 samples, T=100) and the student trio
   (0.1/0.5/0.9 at T=50), as one ``analyze_trajectory_metrics --jobs``
   process; the trio's seconds are its job's marginal from the log;
5. FID across the size factors, ``analyze_fid``.

Each stage has a timeout, retries and an attempt banner in its log under
``<base>/output/results/sweep_<stage>.log``.  On ``--device cuda`` a
preflight records the card's name, memory and power limit, and a missing GPU writes
``ok: false`` and exits 1 before any stage starts (a stage's retry is
skipped the same way).  The record is ``SWEEP_torch_{tag}.json`` under
``--base_dir`` (the repository root without one); the JAX package's
``SWEEP_{tag}.json`` files are not touched.

    python -m distillation_trajectories_torch.scripts.run_full_sweep --tag t01
    python -m distillation_trajectories_torch.scripts.run_full_sweep --skip-training \
        --base_dir /data/run1
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ._common import preflight_probe, project_root

SIZE_FACTORS = "0.01,0.05,0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.75,0.8,0.9,1.0"
# Stage 3 and 4's jobs: the flagship sweep at the CLI's defaults and the trio.
CFG_JOBS = [
    {"output_dir": "analysis/heatmaps"},
    {"size_factors": "0.1,0.5,0.9", "timesteps": 50, "output_dir": "analysis/trio"},
]
# Further arguments per stage name, appended to its command (empty: the
# CLIs' defaults).
STAGE_ARGS = {}


def preflight(device: str) -> dict:
    """``_common.preflight_probe`` with a host device read as ``ok``: the
    stages run there with no card to wait for."""
    probe = preflight_probe(device)
    return {**probe, "status": "ok"} if probe["status"] == "skipped" else probe


def run_stage(name, cmd, log_dir, timeout=None, retries=1, retry_extra_args=None,
              env_extra=None, device="cuda"):
    """Run one stage as a subprocess with a timeout and retries.

    Each attempt appends an ``===== attempt N =====`` banner to the stage's
    log, so a failed attempt's output survives the retry; a retry adds
    ``retry_extra_args`` and is skipped when the device's preflight fails.
    ``env_extra`` is added to the inherited environment.
    """
    log_path = os.path.join(log_dir, f"sweep_{name}.log")
    print(f"[sweep] stage {name}: {' '.join(cmd)}")
    print(f"[sweep]   log: {log_path}")
    t0 = time.time()
    ok = False
    for attempt in range(retries + 1):
        if attempt > 0:
            probe = preflight(device)
            print(f"[sweep] pre-retry preflight: {probe['status']} ({probe['detail']})")
            if probe["status"] != "ok":
                print(f"[sweep] stage {name}: device down; aborting retry")
                break
        with open(log_path, "a") as log:
            log.write(f"\n===== attempt {attempt + 1} =====\n")
            log.flush()
            attempt_cmd = list(cmd)
            if attempt > 0 and retry_extra_args:
                attempt_cmd += list(retry_extra_args)
            try:
                proc = subprocess.run(
                    attempt_cmd, stdout=log, stderr=subprocess.STDOUT, cwd=project_root,
                    timeout=timeout, env={**os.environ, **env_extra} if env_extra else None,
                )
                ok = proc.returncode == 0
            except subprocess.TimeoutExpired:
                log.write(f"\n[sweep] stage {name} timed out after {timeout}s\n")
                ok = False
        if ok:
            break
        if attempt < retries:
            print(f"[sweep] stage {name} attempt {attempt + 1} failed; retrying")
    dt = time.time() - t0
    print(f"[sweep] stage {name}: {'OK' if ok else 'FAILED'} in {dt:.1f}s")
    if not ok:
        with open(log_path) as f:
            print("".join(f.readlines()[-30:]))
    return {"ok": ok, "seconds": round(dt, 1), "cmd": " ".join(cmd)}


def _probe_weight_lanes() -> dict:
    """First existing pretrained-weights file per lane (None when absent),
    along the port's own Inception and LPIPS search paths."""
    from ..metrics import lpips
    from ..models import inception

    lanes = {"inception": inception._weights_search_paths(),
             "lpips": lpips._weights_search_paths()}
    return {lane: next((p for p in paths if p and os.path.exists(p)), None)
            for lane, paths in lanes.items()}


def _job_marginal(log_path, label: str) -> float:
    """Marginal seconds of the job labelled ``label`` (its output
    directory's basename) in the multi-job CLI's log, which prints
    ``[jobs] job N ({label}): marginal X.Xs``.  Matched by label (the CLI
    numbers only its live jobs); only the last attempt counts, so the parse
    resets at every attempt banner; 0.0 when absent."""
    marginal = 0.0
    try:
        with open(log_path) as f:
            for line in f:
                if line.startswith("===== attempt "):
                    marginal = 0.0
                elif (line.startswith("[jobs] job ") and f"({label}):" in line
                      and "marginal" in line):
                    marginal = float(line.rsplit("marginal", 1)[1].strip().rstrip("s"))
    except (OSError, ValueError):
        pass
    return marginal


def _embed_students_phases(log_dir, stage_record):
    """Embed the students stage's phase split (``students_phase_times.json``
    from the student trainer) in its record as ``phases``: the distill
    epochs' total and one entry per ``students/*`` phase; a dump older than
    the stage is ignored."""
    phases_path = os.path.join(log_dir, "students_phase_times.json")
    if not os.path.exists(phases_path):
        return
    if os.path.getmtime(phases_path) < time.time() - stage_record["seconds"] - 120:
        return
    try:
        with open(phases_path) as f:
            phases = json.load(f)
        train_s = sum(v["total_s"] for k, v in phases.items() if k.startswith("distill_epoch_"))
        stage_record["phases"] = {
            "train_epochs_s": round(train_s, 1),
            **{k.split("/", 1)[1] + "_s": round(v["total_s"], 1)
               for k, v in phases.items() if k.startswith("students/")},
        }
    except (OSError, ValueError, KeyError, TypeError) as e:  # recorded; the stage result stands
        stage_record["phases"] = {"error": str(e)[:200]}


def _write(tag, stages, ok, probe=None, weights=None, out_dir=None,
           size_factors=SIZE_FACTORS, device=None):
    """``SWEEP_torch_{tag}.json`` in ``out_dir`` (the repository root by
    default), with the stage records and the reference-equivalent estimate
    of the sweep stage from ``.bench_baseline.json``'s measured reference
    rate (trajectories/s on a CPU at T=50; the sweep's 1,600 chains are
    T=100, twice as long)."""
    total = sum(s["seconds"] for s in stages.values())
    ref_rate = None
    baseline_path = os.path.join(project_root, ".bench_baseline.json")
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            ref_rate = json.load(f).get("ref_traj_per_sec_cpu")
    n_traj = 8 * 10 * 10 * 2
    t_scale = 100 / 50
    ref_equiv = round(n_traj * t_scale / ref_rate, 1) if ref_rate else None
    sweep_s = stages.get("cfg_sweep", {}).get("seconds")
    payload = {
        "tag": tag,
        "ok": ok,
        "device": device,
        "total_seconds": round(total, 1),
        "preflight_probe": probe,
        "pretrained_weight_lanes": weights,
        "stages": stages,
        "workload": {
            "teacher_epochs": "see stages",
            "student_size_factors": size_factors,
            "cfg_sweep": "8 sizes x 10 guidance scales x 10 samples, T=100, "
                         "paired teacher/student chains",
            "trio": "size factors 0.1/0.5/0.9 vs teacher, paired per-timestep chains, T=50",
            "fid": f"FID across size factors {size_factors}",
            "n_trajectories_in_sweep": n_traj,
        },
        "reference_traj_per_s_T50": ref_rate,
        "reference_equiv_sweep_seconds": ref_equiv,
        "sweep_speedup_vs_reference": (
            round(ref_equiv / sweep_s, 1) if ref_equiv and sweep_s else None
        ),
    }
    out = os.path.join(out_dir or project_root, f"SWEEP_torch_{tag}.json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(f"[sweep] wrote {out}: ok={ok} total={total:.1f}s")
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tag", type=str, default="r02")
    parser.add_argument("--skip-training", action="store_true",
                        help="Only run the CFG sweep and FID against existing checkpoints")
    parser.add_argument("--epochs_teacher", type=int, default=10)
    parser.add_argument("--epochs_students", type=int, default=5)
    parser.add_argument("--base_dir", type=str, default=None,
                        help="Output root of every stage and of the SWEEP json "
                        "(default: the repository root)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dataset", choices=["MNIST", "CIFAR10"], default="CIFAR10")
    parser.add_argument("--image_size", type=int, default=32)
    parser.add_argument("--limit_batches", type=int, default=None,
                        help="Cap batches per epoch of the training stages")
    parser.add_argument("--size_factors", type=str, default=SIZE_FACTORS,
                        help="Student size factors trained and scored by FID")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    base_dir = os.path.abspath(args.base_dir) if args.base_dir else None
    out_dir = base_dir or project_root
    log_dir = os.path.join(out_dir, "output", "results")
    os.makedirs(log_dir, exist_ok=True)
    cli = lambda name: [sys.executable, "-m", f"distillation_trajectories_torch.scripts.{name}"]
    shared = ["--device", args.device, "--dataset", args.dataset,
              "--image_size", str(args.image_size)]
    if base_dir:
        shared += ["--base_dir", base_dir]
    train_flags = shared + (["--limit_batches", str(args.limit_batches)]
                            if args.limit_batches is not None else [])
    stage_kw = dict(device=args.device, env_extra={"PYTHONUNBUFFERED": "1"})
    weights_lanes = _probe_weight_lanes()
    write = lambda stages, ok, **kw: _write(
        args.tag, stages, ok, weights=weights_lanes, out_dir=out_dir,
        size_factors=args.size_factors, device=args.device, **kw)

    for lane, found in weights_lanes.items():
        print(f"[sweep] weights lane {lane}: {found if found else 'NOT FOUND (seeded features)'}")
    probe = preflight(args.device)
    print(f"[sweep] preflight: {probe['status']} ({probe['detail']})")
    if probe["status"] != "ok":
        write({}, False, probe=probe)
        return 1

    stages = {}
    if args.skip_training:
        # Carry the training stages forward from the previous full run.
        prev = os.path.join(out_dir, f"SWEEP_torch_{args.tag}.json")
        if os.path.exists(prev):
            with open(prev) as f:
                for k, v in json.load(f).get("stages", {}).items():
                    if k != "cfg_sweep":
                        stages[k] = v
    else:
        stages["teacher"] = run_stage(
            "teacher",
            cli("train_teacher") + ["--epochs", str(args.epochs_teacher)] + train_flags
            + STAGE_ARGS.get("teacher", []),
            log_dir, timeout=1800, retries=1, **stage_kw)
        if not stages["teacher"]["ok"]:
            write(stages, False, probe=probe)
            return 1
        stages["students"] = run_stage(
            "students",
            cli("train_students") + ["--epochs", str(args.epochs_students),
                                     "--custom_size_factors", args.size_factors]
            + train_flags + STAGE_ARGS.get("students", []),
            log_dir, timeout=3600, retries=1,
            # Attempt 1's finished students are this run's own work.
            retry_extra_args=["--skip_existing"], **stage_kw)
        _embed_students_phases(log_dir, stages["students"])
        if not stages["students"]["ok"]:
            write(stages, False, probe=probe)
            return 1

    combined = run_stage(
        "cfg_trio",
        cli("analyze_trajectory_metrics") + ["--jobs", json.dumps(CFG_JOBS)] + shared
        + STAGE_ARGS.get("cfg_trio", []),
        log_dir, timeout=2400, retries=2, **stage_kw)
    trio_marginal = _job_marginal(os.path.join(log_dir, "sweep_cfg_trio.log"), label="trio")
    stages["cfg_sweep"] = {
        "ok": combined["ok"],
        "seconds": round(combined["seconds"] - trio_marginal, 1),
        "cmd": combined["cmd"] + " [shared process with trio; see sweep_cfg_trio.log]",
    }
    stages["trio"] = {
        "ok": combined["ok"],
        "seconds": round(trio_marginal, 1),
        "cmd": combined["cmd"] + " [marginal cost of the trio job in the shared process]",
    }
    stages["fid"] = run_stage(
        "fid",
        cli("analyze_fid") + ["--size_factors", args.size_factors] + shared
        + STAGE_ARGS.get("fid", []),
        log_dir, timeout=1800, retries=2, **stage_kw)
    ok = all(stages[k]["ok"] for k in ("cfg_sweep", "trio", "fid"))
    write(stages, ok, probe=probe)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
