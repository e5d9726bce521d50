"""The readings that a cell's limits are set from: the check's numbers over
many seeds in one process, for the program as the cell runs it or for its
lower-precision control (``--control``), with what each number was made
of.  Not run by the benchmark's own runs.

    python3 h100_bench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--control program_int8|reference_fp8|fault_half_batch] [--out FILE]

One JSON line per seed on standard output (and appended to ``--out``).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from h100_bench import harness

    cell = harness.find_cell(harness.manifest(ROOT), args.workload)
    harness.check_cards(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        details = {}
        t0 = time.perf_counter()
        result = harness.run_cell(cell, seed, args.seconds, bool(args.trace), "cuda",
                                  control=args.control, details=details)
        line = json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                           "wall_s": time.perf_counter() - t0, "result": result,
                           "details": details})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
