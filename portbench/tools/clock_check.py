"""Do the clocks of a profiled stretch agree? A second witness for the join
of portbench/spans.py, on one CUDA card.

    python3 portbench/tools/clock_check.py --workload tum_cabinet.objects --seed 11 --seconds 25

Runs one `--trace 1` run of the cell, as run.py does, with probes inside
its profiled stretch: at the start of each of the port's spans named in
PROBED, and after each frame, the device is synchronized, the host reads
perf_counter_ns, a CUDA event is recorded and a short spin kernel is
launched. (The probes' synchronizations change the stretch's timing: this
run checks clocks, it measures nothing else.) Each probe is then read on
four clocks, each from the stretch's marker (the harness's clock read just
before its marker kernel):

- `host`: perf_counter_ns at the probe;
- `event`: the event's time after an event recorded just after the
  marker, on the GPU's own clock (cudaEventElapsedTime);
- `launch`: the spin kernel's runtime launch record in the trace, less the
  marker's launch record (the trace's host-side times);
- `kernel`: the spin kernel's start in the trace, less the marker kernel's
  start (the trace's GPU timestamps).

It prints, on standard error, the difference of each pair of clocks at
the first and at the last probe and its least and largest value, and the
spin kernel's start less its launch on the trace's own clock, then one
JSON line with the same numbers. Where `event - host` stays within tens
of microseconds while `kernel - event` moves by milliseconds, the GPU's
clock agrees with the host's and the trace's GPU timestamps do not.
"""

import argparse
import json
import os
import sys
import time

# the port's spans at whose start a probe is made (inside the stretch): a few per frame, so that the
# stretch runs mostly as it does without probes (a probe before every LM iteration kept the trace's GPU
# timestamps on the host's clock in both cells)
PROBED = ("frame", "lsd.detect", "kf.total", "obj.ba")
SPIN_CYCLES = 2000


def compare(probes, marker, spins):
    """Per probe, from the marker: (host, event, launch, kernel) in ns, and
    the pairs' differences. `probes` is [(host ns, event ns)] in probe
    order, `marker` (host ns, launch ns, kernel start ns) of the marker,
    `spins` [(launch ns, kernel start ns)] of the spin kernels in launch
    order, on the trace's clock."""
    if len(spins) != len(probes):
        raise ValueError(f"{len(probes)} probes but {len(spins)} spin kernels in the trace")
    rows = []
    for (h, e), (lau, ker) in zip(probes, spins):
        rows.append({"host": h - marker[0], "event": e, "launch": lau - marker[1], "kernel": ker - marker[2],
                     "spin_start_less_launch": ker - lau})
    pairs = {"launch - host": ("launch", "host"), "event - host": ("event", "host"),
             "kernel - event": ("kernel", "event"), "kernel - launch": ("kernel", "launch")}
    out = {}
    for name, (a, b) in pairs.items():
        d = [r[a] - r[b] for r in rows]
        out[name] = {"first": d[0], "last": d[-1], "min": min(d), "max": max(d)} if d else None
    lag = [r["spin_start_less_launch"] for r in rows]
    out["spin_start_less_launch"] = {"min": min(lag), "max": max(lag)} if lag else None
    out["span_s"] = (rows[-1]["host"] - rows[0]["host"]) * 1e-9 if rows else 0.0
    return rows, out


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from portbench import drive, harness, trace

    harness.fix_host_threads()
    import torch

    torch.set_num_threads(harness.HOST_THREADS)
    if not torch.cuda.is_available():
        print("clock_check.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    prof = drive.port_modules()["profiler"]
    held = {"ctl": None, "probes": []}

    def probe():
        torch.cuda.synchronize()
        h = time.perf_counter_ns()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda._sleep(SPIN_CYCLES)
        held["probes"].append((h, ev))

    start, after_frame, enter = trace.StretchControl._start, trace.StretchControl.after_frame, prof.Span.__enter__

    def start_probed(self):
        start(self)
        held["ctl"] = self
        held["ev0"] = torch.cuda.Event(enable_timing=True)
        held["ev0"].record()
        held["clocks"] = {"wall_less_perf_ns": time.time_ns() - time.perf_counter_ns(),
                          "monotonic_less_perf_ns": time.monotonic_ns() - time.perf_counter_ns()}

    def after_frame_probed(self, rec, trk):
        if self.running:
            probe()
        after_frame(self, rec, trk)

    def enter_probed(self):
        ctl = held["ctl"]
        if ctl is not None and ctl.running and self.name in PROBED:
            probe()
        return enter(self)

    trace.StretchControl._start = start_probed
    trace.StretchControl.after_frame = after_frame_probed
    prof.Span.__enter__ = enter_probed
    try:
        result, _ = harness.run_cell(cell, args.seed, args.seconds, 1, device, t_start)
    finally:
        trace.StretchControl._start, trace.StretchControl.after_frame = start, after_frame
        prof.Span.__enter__ = enter
    ctl = held["ctl"]
    if ctl is None:
        print("clock_check.py: no stretch ran", file=sys.stderr)
        return 1
    events = ctl.prof.profiler.kineto_results.events()
    launches = trace.launches_of(events, lambda e: e.device_type() == torch.autograd.DeviceType.CUDA)
    marker = launches[0]
    spins = [(lau.t, lau.ops[0][1]) for lau in launches if "spin" in lau.ops[0][0]]
    ev0 = held["ev0"]
    probes = [(h, round(ev0.elapsed_time(ev) * 1e6)) for h, ev in held["probes"]]
    rows, out = compare(probes, (ctl.stretch.marker_ns, marker.t, marker.ops[0][1]), spins)
    out.update(workload=cell.name, seed=args.seed, probes=len(rows), marker=marker.ops[0][0][:80],
               marker_first_launched=marker.corr == min(lau.corr for lau in launches),
               trace_less_perf_ns=marker.t - ctl.stretch.marker_ns, correct=result["correct"],
               card=harness.nvidia_smi(), **held["clocks"])
    for r in rows:
        harness.log("[clock] " + " ".join(f"{k} {v}" for k, v in r.items()))
    for k, v in out.items():
        harness.log(f"[clock] {k}: {v}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
