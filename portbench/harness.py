"""One run of one cell: load it by name, make its traffic from the seed,
warm up, measure for the given seconds, check what the timed path produced,
and build the result line.

The window replays episodes back to back for `seconds`: an episode is a
fresh tracker of the cell's configuration over the rendered orbit, one
`track()` call per frame in a closed loop (the next frame is sent when the
previous one has returned and the device is synchronized). A cell plays a
fixed pool of `episodes` noise draws (workloads/<name>.json) in an order
drawn from the seed, over and over; the window closes with the first frame
that returns after `seconds`, cutting the episode it falls in. Every seed
plays the same draws: the tracker's keyframes, and with them the work,
follow the noise (a draw of its own per seed made the objects cell's
episodes take 37-56 s).

The checks (checks/<name>.py) may record calls of the port made in the
window: a check's `install(port, calls)` wraps a function of the port when
the window opens and is taken off when it closes; checks that name the same
`PROBE` share one recorder. The port's span records of the window are
drained from its profiler once the window has closed and handed to the
metrics on the Run (`Run.spans`), with the profiled stretch (`Run.trace`).
Where a cell's end-to-end metrics read the device trace, its `--trace 0`
run holds the whole window under a device-only trace (trace.WindowTrace)
and hands the device's busy seconds to them (`Run.device_busy_s`).
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from .reference import truth
from .traffic import episode as traffic_episode

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# host threads of every run (torch, OpenMP, BLAS): one value on every run
HOST_THREADS = 4
# module names that no run may hold once its window has closed (whole
# top-level names: the port's own name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cube_slam_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict                 # workloads/<name>.json: limits, trace stretch
    run: dict                  # config["runs"][traffic name]
    end_to_end: list
    per_layer: list
    units: dict                # metric name -> unit, from BENCHMARK.json
    sources: dict = field(default_factory=dict)   # metric name -> source, from BENCHMARK.json


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, bench=None, base=BENCH_DIR):
    """The cell `name` of BENCHMARK.json (or of `bench`), with its
    configuration and limits read from the files under `base` and its
    traffic mix from traffic/, each file named after its name."""
    bench = bench if bench is not None else _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]

    def reported(m):
        return name in m.get("workloads", cells)

    config = _json(os.path.join(base, "configs", f"{w['config']}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")),
                spec=_json(os.path.join(base, "workloads", f"{name}.json")),
                run=config["runs"][w["traffic"]],
                end_to_end=[m["name"] for m in bench["end_to_end"] if reported(m)],
                per_layer=[m["name"] for m in bench["per_layer"] if reported(m)],
                units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]},
                sources={m["name"]: m.get("source") for m in bench["end_to_end"] + bench["per_layer"]})


def fix_host_threads():
    """The same host thread counts on every run (before numpy and torch
    start their pools)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def reader(kind, name):
    """The module of a metric (kind "metrics") or a compared number (kind
    "checks"), found by its name. A quantity split between cells that
    report different end-to-end metrics, `<name>.<part>`, is read by
    `<name>`'s module."""
    return importlib.import_module(f"portbench.{kind}.{name.split('.')[0]}")


@dataclass
class FrameRecord:
    episode: int
    index: int
    pool: int                  # the draw of the pool the frame came from
    ms: float
    kind: str                  # "init", "kf", "tracked", "lost", "before_init", "raised"
    Tcw: object = None         # the pose track() returned, or None
    made: dict = field(default_factory=dict)    # what the feed made for track() and the checks ("lines")
    feed_ms: float = 0.0       # the feed's own call (LSD in the lines cells), host clock
    spans: dict = field(default_factory=dict)   # the port's spans in this frame: name -> (ms, calls)
    traced: bool = False       # inside the profiled stretch
    host_ranges: list = field(default_factory=list)  # (label, start ns, end ns) of the calls made


@dataclass
class EpisodeRecord:
    index: int
    pool: int
    final_Twc: list            # (frame, Twc or None) of final_trajectory()
    init_frame: int | None
    raised: bool = False
    frames_run: int = 0        # frames sent (fewer than the orbit's where the window cut the episode)
    t_end: float = 0.0         # perf_counter when its last frame returned


@dataclass
class Run:
    """What the window produced, read by the metrics and the checks."""
    cell: Cell
    seed: int
    eps: list                  # traffic_episode.Episode of each pool draw
    frames: list = field(default_factory=list)
    episodes: list = field(default_factory=list)
    window_s: float = 0.0
    setup: dict = field(default_factory=dict)
    trace: object = None       # trace.Stretch of a --trace 1 run
    device_busy_s: float = None  # seconds of the window in which the device ran an operation (trace.WindowTrace)
    spans: list = None         # the port's span records of the window (profiler.drain()), in the order they opened
    calls: dict = field(default_factory=dict)   # a check's PROBE -> the calls its install() recorded
    cache: dict = field(default_factory=dict)   # what the checks work out once and share

    @property
    def ep(self):
        """The first draw: the camera, the true poses and the box, which
        every draw shares."""
        return self.eps[0]
    edt_pixels: list = field(default_factory=list)   # B*H*W of each EDT call in the stretch


def _sync_fn(torch, device):
    if getattr(device, "type", str(device)) == "cuda":
        return torch.cuda.synchronize
    return lambda: None


class Driver:
    """Runs episodes of a cell on `device`; the port is imported by the
    caller and passed in as `port` (drive.port_modules())."""

    def __init__(self, cell, eps, port, device, lines_fn=None, tracker_hook=None):
        import torch

        from . import drive

        self.cell, self.eps, self.port, self.device = cell, eps, port, device
        self.sync = _sync_fn(torch, device)
        self.feeds = [drive.make_feed(port, cell.config, cell.run, ep, device, lines_fn=lines_fn) for ep in eps]
        self._build = drive.build_tracker
        # tracker_hook(trk) -> trk: a planted fault, or tools/sweep.py's recorders
        self.tracker_hook = tracker_hook

    def new_tracker(self, ep):
        trk = self._build(self.port, self.cell.config, self.cell.run, ep, self.device)
        return self.tracker_hook(trk) if self.tracker_hook else trk

    def episode(self, index, pool, frames=None, after_frame=None, stop=None, deadline=None):
        """One episode: a fresh tracker over every frame of draw `pool`.
        Appends a FrameRecord per frame to `frames` (a list) and returns the
        EpisodeRecord. `after_frame(rec, trk)` runs after each frame's sync;
        `stop(trk)` ends the episode early (the warm-up), and so does the
        first frame to return at or after `deadline` (perf_counter)."""
        ep, feed = self.eps[pool], self.feeds[pool]
        trk = self.new_tracker(ep)
        n = len(ep.frames)
        init_frame, raised, run = None, False, 0
        for f in range(n):
            t0 = time.perf_counter_ns()
            run += 1
            try:
                args, made = feed.args(f)
                t_fed = time.perf_counter_ns()
                was = trk.state
                out = trk.track(*args)
                self.sync()
            except Exception:  # a frame that raises ends its episode and counts as failed
                traceback.print_exc(file=sys.stderr)
                rec = FrameRecord(index, f, pool, 1e-6 * (time.perf_counter_ns() - t0), "raised")
                raised = True
                if frames is not None:
                    frames.append(rec)
                break
            t1 = time.perf_counter_ns()
            if was == "NOT_INITIALIZED" and trk.state == "OK" and init_frame is None:
                init_frame, kind = f, "init"
            elif out is None:
                kind = "before_init" if init_frame is None else "lost"
            else:
                kind = "kf" if trk.last_kf_frame_id == f else "tracked"
            rec = FrameRecord(index, f, pool, 1e-6 * (t1 - t0), kind, Tcw=None if out is None else np.array(out), made=made,
                              feed_ms=1e-6 * (t_fed - t0),
                              host_ranges=[(f"feed f{f}", t0, t_fed), (f"track f{f}", t_fed, t1)])
            if frames is not None:
                frames.append(rec)
            if after_frame is not None:
                after_frame(rec, trk)
            if stop is not None and stop(trk):
                break
            if deadline is not None and time.perf_counter() >= deadline:
                break
        t_end = time.perf_counter()
        final = trk.final_trajectory() if not raised else []
        self.sync()
        final_Twc = [(f, None if T is None else truth.rigid_inverse(T)) for f, T in final]
        return EpisodeRecord(index, pool, final_Twc, init_frame, raised, frames_run=run, t_end=t_end)


def warm_up(driver, pool, profiler, until):
    """Run a fresh tracker over the first frames until the port's spans
    show each of `until` ({span name: calls}) reached, or the episode ends:
    every CUDA module, cuBLAS / cuSOLVER handle and the allocator's pools
    the window will use are then made. The spans it recorded are drained
    and dropped."""
    profiler.reset()
    profiler.enable()

    def reached(_trk):
        agg = profiler.aggregated()
        return all(agg.get(k, (0, 0, 0, 0, 0))[4] >= v for k, v in until.items())

    try:
        driver.episode(-1, pool, stop=reached)
    finally:
        profiler.disable()
        profiler.drain()


def span_deltas(profiler, prev):
    """The port's spans recorded since `prev` (name -> (total ms, calls)),
    and the new totals."""
    now = {k: (v[0], v[4]) for k, v in profiler.aggregated().items()}
    out = {k: (t - prev.get(k, (0.0, 0))[0], c - prev.get(k, (0.0, 0))[1]) for k, (t, c) in now.items()
           if c != prev.get(k, (0.0, 0))[1]}
    return out, now


def measure(driver, order, seconds, trace_ctl=None, profiler=None, probes=()):
    """The window: the pool's draws in `order`, over and over, back to back,
    until the first frame that returns after `seconds`; the episode in
    progress is cut there (its trajectory is read after the close). Returns
    (frames, episodes, window seconds).
    With `trace_ctl` (trace.StretchControl) the port's spans are on for the
    whole window and one stretch of the first episode runs under the
    profiler. `probes` are the checks' installers, each put on as the window
    opens and taken off as it closes. `seconds` None plays the pool once,
    whole (the tools and the tests)."""
    frames, episodes = [], []
    prev = {}
    after = None
    if trace_ctl is not None:
        profiler.reset()
        profiler.enable()

        def after(rec, trk):
            nonlocal prev
            rec.spans, prev = span_deltas(profiler, prev)
            trace_ctl.after_frame(rec, trk)

    gc.collect()
    gc.freeze()
    restore = [install() for install in probes]
    t_open = time.perf_counter()
    deadline = t_open + seconds if seconds is not None else None
    try:
        while (len(episodes) < len(order) if deadline is None
               else not episodes or episodes[-1].t_end < deadline):
            pool = order[len(episodes) % len(order)]
            if trace_ctl is not None:
                trace_ctl.before_episode(len(episodes))
            episodes.append(driver.episode(len(episodes), pool, frames, after_frame=after, deadline=deadline))
    finally:
        window = (episodes[-1].t_end if episodes else time.perf_counter()) - t_open
        for undo in restore:
            undo()
        gc.unfreeze()
        if trace_ctl is not None:
            trace_ctl.stop()
            profiler.disable()
    return frames, episodes, window


def nvidia_smi():
    """The card's name, SM clock, power draw and limit (read outside the
    window)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def pool_order(cell, seed):
    """The order in which a run plays the cell's pool of draws."""
    rng = np.random.default_rng(traffic_episode.noise_seed(seed))
    return [int(i) for i in rng.permutation(int(cell.spec["episodes"]))]


def run_cell(cell, seed, seconds, trace, device, t_start, lines_fn=None, tracker_hook=None,
             render_workers=traffic_episode.RENDER_WORKERS, warm=True, draws=None):
    """Set up, measure and check one run of `cell`; returns (result dict,
    Run). `t_start` is the process's start on the perf_counter clock. The
    pool's draws are 0 .. episodes-1 in the seed's order; `draws` replaces
    them (tools/sweep.py reads one draw per seed)."""
    import torch

    from . import drive, spans
    from . import trace as trace_mod

    cuda = getattr(device, "type", str(device)) == "cuda"
    window_trace = None
    if not trace and cuda and any(cell.sources.get(n) == "device_trace" for n in cell.end_to_end):
        window_trace = trace_mod.WindowTrace(torch, device)
    setup = {}
    t = time.perf_counter()
    port = drive.port_modules()
    setup["import_s"] = time.perf_counter() - t_start
    t = time.perf_counter()
    if draws is None:
        draws, order = list(range(int(cell.spec["episodes"]))), pool_order(cell, seed)
    else:
        order = list(range(len(draws)))
    eps = [traffic_episode.make_episode(cell.config, d, workers=render_workers) for d in draws]
    setup["render_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for lib in cell.run["native"] if cuda else ():
        port["build"].load(lib)
    setup["build_s"] = time.perf_counter() - t
    setup["compiled_s"] = sum(port["build"].build_seconds.values())
    t = time.perf_counter()
    driver = Driver(cell, eps, port, device, lines_fn=lines_fn, tracker_hook=tracker_hook)
    if warm:
        warm_up(driver, order[0], port["profiler"], cell.traffic["warmup_until"])
    if window_trace is not None:
        window_trace.warm()
    setup["warmup_s"] = time.perf_counter() - t
    setup["total_s"] = time.perf_counter() - t_start
    log("[setup] " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items())
        + " (import counts from the process's start; compiled_s is the native builds' compile time, "
          "0 where the checkout had them)")
    if cuda:
        log(f"[device before the window] {nvidia_smi()}")

    ctl = None
    if trace:
        st = cell.spec["trace"]
        ctl = trace_mod.StretchControl(torch, device, port["hopper_kernels"], int(st["from_frame"]),
                                       int(st["max_frames"]))
    calls, probes = {}, []
    for name in cell.spec["limits"]:
        m = reader("checks", name)
        if hasattr(m, "install") and m.PROBE not in calls:
            calls[m.PROBE] = []
            probes.append(lambda m=m, c=calls[m.PROBE]: m.install(port, c))
    if window_trace is not None:
        window_trace.start()
    frames, episodes, window = measure(driver, order, seconds, ctl, port["profiler"], probes)
    run = Run(cell=cell, seed=seed, eps=eps, frames=frames, episodes=episodes, window_s=window, setup=setup,
              calls=calls, spans=port["profiler"].drain())
    if window_trace is not None:
        run.device_busy_s, ops, read_s = window_trace.stop_and_read()
        log(f"[window trace] {ops} device operations, busy {run.device_busy_s:.6f} s of the window's "
            f"{window:.3f} s, read in {read_s:.1f} s")
    if ctl is not None:
        run.trace = ctl.read()
        run.edt_pixels = ctl.edt_pixels
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}
    if cuda:
        log(f"[device after the window] {nvidia_smi()}; memory peak {device_info['memory_peak_bytes']} bytes")
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    failed = sum(1 for r in frames if r.kind in ("lost", "raised"))
    kinds = {k: sum(1 for r in frames if r.kind == k) for k in ("before_init", "init", "tracked", "kf", "lost",
                                                                   "raised")}
    ms = sorted(r.ms for r in frames)
    p90 = float(np.percentile(ms, 90)) if ms else float("nan")
    log(f"[window] {window:.3f} s, {len(episodes)} episodes (draws {[e.pool for e in episodes]}), {len(frames)} frames: "
        + ", ".join(f"{k} {v}" for k, v in kinds.items())
        + f"; frames before initialization (attempted, not failed) {kinds['before_init']}; "
          f"frames beyond the p90 ({p90:.1f} ms): {sum(1 for m in ms if m > p90)}")

    if trace:
        names = cell.per_layer
    else:
        names = cell.end_to_end
    metrics = {}
    for name in names:
        v = reader("metrics", name).read(run)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": cell.units[name]}
    result = {"correct": None, "attempted": len(frames), "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = trace_mod.busy_s(run.trace)
        result["device"]["window_s"] = run.trace.wall_s
        joined = spans.join(run)
        result["breakdown"] = trace_mod.breakdown(run.trace, None if joined is None else joined.gaps)
        log(f"[trace] stretch of {run.trace.frames} frames from frame {cell.spec['trace']['from_frame']}: "
            f"{run.trace.wall_s:.3f} s wall, {len(run.trace.device)} device events, EDT calls "
            f"{len(run.edt_pixels)}")

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run holds {found} once its window has closed")

    checks = {}
    for name, limit in cell.spec["limits"].items():
        v = float(reader("checks", name).read(run))
        checks[name] = {"value": v, "limit": float(limit)}
    correct = (all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
               and not any(r.kind == "raised" for r in frames))
    result["correct"] = bool(correct)
    result["checks"] = checks
    log(f"[run] {time.perf_counter() - t_start:.1f} s from the process's start")
    return result, run
