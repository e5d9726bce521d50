"""Force-CPU dispatcher (the port's counterpart of the repository's
``scripts/run_on_cpu.py``).

    python -m distillation_trajectories_torch.scripts.run_on_cpu train_teacher \
        --args "--epochs 1 --limit_batches 2 --dataset MNIST --image_size 16"

Re-runs the chosen CLI as ``python -m distillation_trajectories_torch.scripts.<script>
--device cpu <args>`` in a child whose environment sets
``CUDA_VISIBLE_DEVICES=""``, so the card is hidden from CUDA's first
initialisation in that process whatever this one has imported, and exits
with the child's code.  ``run_analysis`` passes ``--device cpu`` on to each
of its CLIs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

SCRIPTS = ("train_teacher", "train_students", "run_analysis")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Run a training/analysis script on CPU",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("script", type=str, choices=SCRIPTS, help="Which script to run on CPU")
    parser.add_argument("--args", type=str, default="",
                        help="Additional arguments to pass to the script")
    args = parser.parse_args(argv)

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    print("\n" + "=" * 80)
    print("RUNNING ON CPU")
    print("=" * 80)
    print(f"Script to run: {args.script}")
    print(f"Running {args.script} on CPU...", flush=True)
    # --args split on whitespace, as the JAX dispatcher splits it.
    cmd = [sys.executable, "-m", f"distillation_trajectories_torch.scripts.{args.script}",
           "--device", "cpu", *args.args.split()]
    return subprocess.run(cmd, env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
