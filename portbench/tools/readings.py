"""Readings of the compared numbers, for setting their limits: the sound
program's and the controls', over noise draws, in one process.

    python3 portbench/tools/readings.py --workload tum_cabinet.objects --draws 0,301,302

Each draw plays one whole episode of the cell's traffic with the checks'
recorders on, then prints one JSON line: the checks as a run computes them
(on up to `--calls` object BA and EDT calls of the episode, the largest
among them), and for the same calls
- `oba`: the float64 costs per family (reference/object_ba.py::costs) of
  the start, the float64 optimum and the program's final state, and of the
  final states of the port's own object BA rerun on the recorded inputs with
  TF32 on (`program_tf32`, the program's own lower-precision path: the
  control) and off (`program_rerun`), and of reference/object_ba.py's solve
  in TF32 and in bfloat16 in the port's place (`reference_tf32`,
  `reference_bfloat16`);
- `edt.reference_bfloat16`: reference/edt.py's transform in bfloat16 in the
  port's place (the control).
"""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--draws", required=True, help="comma-separated noise draws")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--all-controls", type=int, default=1, help="0: leave out the rerun and bfloat16")
    ap.add_argument("--data", default="", help="a directory of bench.json, configs/ and workloads/ (tests/data)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from portbench import harness
    from portbench.checks import _oba, _sample, edt_err
    from portbench.reference import edt
    from portbench.reference import object_ba as ref

    harness.fix_host_threads()
    import torch

    import cube_slam_tpu_torch  # noqa: F401  (turns the port's TF32 off)
    from cube_slam_tpu_torch.graph import object_ba

    torch.set_num_threads(harness.HOST_THREADS)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    if args.data:
        with open(os.path.join(args.data, "bench.json")) as f:
            cell = harness.load_cell(args.workload, bench=json.load(f), base=args.data)
    else:
        cell = harness.load_cell(args.workload)
    _oba.SAMPLE, edt_err.SAMPLE = 1, args.calls  # the run's own check: one call (the loop below reads them all)
    for d in (int(s) for s in args.draws.split(",")):
        t0 = time.perf_counter()
        result, run = harness.run_cell(cell, d, None, 0, device, t0, warm=False, draws=[d],
                                       render_workers=0 if device.type == "cpu" else 6)
        out = dict(draw=d, correct=result["correct"], checks={k: v["value"] for k, v in result["checks"].items()},
                   frames=len(run.frames), setup=run.setup, window_s=run.window_s)
        calls = run.calls.get(_oba.PROBE) or []
        rows = []
        for i in _sample.pick(d, [_oba.size(a) for a, _ in calls], args.calls, salt=1):
            a, prog = calls[i]
            opt = ref.solve(a, "float64")
            row = dict(call=i, edges=_oba.size(a), program=ref.costs(a, prog, opt))
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                row["program_tf32"] = ref.costs(a, object_ba.local_ba_objects_two_stage(**a)[:4], opt)["program"]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            row["reference_tf32"] = ref.costs(a, ref.solve(a, "tf32")[1], opt)["program"]
            if args.all_controls:
                row["program_rerun"] = ref.costs(a, object_ba.local_ba_objects_two_stage(**a)[:4], opt)["program"]
                row["reference_bfloat16"] = ref.costs(a, ref.solve(a, "bfloat16")[1], opt)["program"]
            rows.append(row)
        out["oba"] = rows
        calls = run.calls.get(edt_err.PROBE) or []
        rows = []
        for i in _sample.pick(d, [int(e.numel()) for e, _ in calls], args.calls, salt=2):
            e, o = calls[i]
            bf = torch.sqrt(edt.squared(e, torch.bfloat16).to(torch.float32)).reshape(e.shape)
            rows.append(dict(call=i, program=edt_err.gap(e, o), reference_bfloat16=edt_err.gap(e, bf)))
        out["edt"] = rows
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del run, calls
    return 0


if __name__ == "__main__":
    sys.exit(main())
