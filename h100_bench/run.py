"""The benchmark's one command.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  Prints, as its last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the check compared with its limit (also the last
lines of standard error).  Exits non-zero, printing no result, where the
checkout lacks the program, without the cards the cell asks for, or when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The program fixes Triton's cache at build/triton of the checkout; the
# benchmark names the same fixed directory, so one run in a checkout builds.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import distillation_trajectories_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"h100_bench: the program is not in this checkout ({e})", file=sys.stderr)
        return 4
    from h100_bench import harness

    cell = harness.find_cell(harness.manifest(ROOT), args.workload)
    try:
        harness.check_cards(cell.chips)
    except harness.NoCard as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"h100_bench: loaded {found}; the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
