"""What the port's tracing costs while it is on: windows of a cell with the
port's spans and counters (the `sync` hook included) off and on, in turns,
in one process per seed.

    python3 portbench/tools/tracing_cost.py --workload tum_cabinet.objects --seeds 11,12,13 --seconds 40

Each seed sets the cell up once, as run.py does, then runs `--windows`
windows of `--seconds`, the first off and the next on, alternating (the
second seed of a list starts on, and so on), and prints one JSON line per
window: the seed, whether tracing was on, the frames, the window's seconds
and frames/s. "On" is the window of a `--trace 1` run without its profiled
stretch: the spans and counters on for the whole window and read after every
frame.
"""

import argparse
import json
import os
import sys
import time


class _NoStretch:
    """A stretch control that profiles nothing (harness.measure then turns
    the port's spans on for the window and reads them after each frame)."""

    def before_episode(self, e):
        pass

    def after_frame(self, rec, trk):
        pass

    def stop(self):
        pass


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--windows", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from portbench import drive, harness
    from portbench.traffic import episode as traffic_episode

    harness.fix_host_threads()
    import torch

    torch.set_num_threads(harness.HOST_THREADS)
    if not torch.cuda.is_available():
        print("tracing_cost.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    port = drive.port_modules()
    eps = [traffic_episode.make_episode(cell.config, d) for d in range(int(cell.spec["episodes"]))]
    for lib in cell.run["native"]:
        port["build"].load(lib)
    name = torch.cuda.get_device_name(device)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        order = harness.pool_order(cell, seed)
        driver = harness.Driver(cell, eps, port, device)
        harness.warm_up(driver, order[0], port["profiler"], cell.traffic["warmup_until"])
        for w in range(args.windows):
            on = (w + i) % 2 == 1
            frames, _, window = harness.measure(driver, order, args.seconds, _NoStretch() if on else None,
                                                port["profiler"])
            port["profiler"].reset()
            port["profiler"].drain()
            done = sum(1 for r in frames if r.kind != "raised")
            print(json.dumps({"workload": cell.name, "seed": seed, "tracing": on, "frames": done,
                              "window_s": window, "frames_per_s": done / window, "device": name}), flush=True)
        del driver
    harness.log(f"[tracing_cost] {time.perf_counter() - t_start:.1f} s; {harness.nvidia_smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
