"""Analysis orchestrator: run the port's analysis CLIs in sequence, each in
its own process (the ``SCRIPTS`` order, ``--skip`` and ``--teacher_model``
of the repository's ``run_analysis.py``).

    python -m distillation_trajectories_torch.scripts.run_analysis --skip analyze_fid

Each CLI runs as ``python -m distillation_trajectories_torch.scripts.<name>``
in the caller's working directory (the directory that holds the package is
put on the child's ``PYTHONPATH``), with ``--teacher_model``,
``--base_dir``, ``--device``, ``--dataset``, ``--image_size`` and
``--num_channels`` passed on when given.  A CLI that exits non-zero is
reported and the next one runs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Dict

SCRIPTS = [
    "analyze_trajectory_metrics",
    "analyze_trajectories",
    "analyze_effectiveness",
    "analyze_dimensionality",
    "analyze_noise_prediction",
    "analyze_time_dependent",
    "analyze_fid",
]
_FORWARDED = ("teacher_model", "base_dir", "device", "dataset", "image_size", "num_channels")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run the full analysis pipeline",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--skip", type=str, default="",
                        help="Comma-separated script names to skip")
    parser.add_argument("--teacher_model", type=str, default=None,
                        help="Teacher checkpoint name passed through to each script")
    parser.add_argument("--base_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None, choices=["MNIST", "CIFAR10"])
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--num_channels", type=int, default=None)
    return parser.parse_args(argv)


def main(argv=None) -> Dict[str, int]:
    """Run every script not skipped; returns ``{name: exit code}``."""
    args = parse_args(argv)
    skip = {s.strip() for s in args.skip.split(",") if s.strip()}
    flags = []
    for name in _FORWARDED:
        value = getattr(args, name)
        if value is not None:
            flags += [f"--{name}", str(value)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    codes = {}
    for name in SCRIPTS:
        if name in skip:
            print(f"Skipping {name}")
            continue
        cmd = [sys.executable, "-m", f"distillation_trajectories_torch.scripts.{name}", *flags]
        print(f"\n{'=' * 70}\nRunning {name}\n{'=' * 70}", flush=True)
        codes[name] = subprocess.run(cmd, env=env).returncode
        if codes[name] != 0:
            print(f"Warning: {name} exited with code {codes[name]}")
    print("\nAnalysis pipeline complete")
    return codes


if __name__ == "__main__":
    main()
