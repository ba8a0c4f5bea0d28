"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Drives cube_slam_tpu_torch's trackers frame by frame on one CUDA card (see
harness.py for the window and PERF.md for the cells). Prints the set-up
split, the card's clocks and power and each compared number beside its
limit on standard error, then one JSON result line last on standard output.
Exits non-zero, printing no result, without a card or where the run loaded
JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench import harness

    harness.fix_host_threads()
    cell = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(harness.HOST_THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    result, _ = harness.run_cell(cell, args.seed, args.seconds, args.trace, torch.device("cuda", 0), T_START)
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
