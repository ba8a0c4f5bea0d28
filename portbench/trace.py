"""The profiled stretch of a `--trace 1` run, and the device-only trace of
a whole window for end-to-end metrics that read the device (WindowTrace).

One fixed stretch of the window's first episode runs under torch.profiler
with device activity only (recording every host op of an object BA took
80-100 s to profile): from frame `from_frame` through the first keyframe
at or after it, at most `max_frames` frames. The stretch starts with a
marker kernel launched on an idle device, which puts the host's clock
beside the trace's, so the device's idle gaps can be labelled with what the
harness was doing: the feed's LSD call, the `track()` call, or its own
bookkeeping between calls.

After the window, `StretchControl.read()` keeps on the `Stretch` the device
operations (mapped to the host's clock by the marker kernel's start) and the
launch records: each CUDA runtime call with the device operations of its
correlation id, mapped by the marker's launch, which spans.py joins to the
port's spans.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Launch:
    t: int                    # the runtime call's start, perf_counter_ns
    ops: list                 # (name, start, end) of its device operations, perf_counter_ns
    corr: int = 0             # the correlation id linking the call to its operations


@dataclass
class Stretch:
    wall_s: float = 0.0
    frames: int = 0
    device: list = field(default_factory=list)   # (name, start ns, end ns) on the host's clock
    host: list = field(default_factory=list)     # (label, start ns, end ns)
    launches: list = field(default_factory=list)  # Launch records on the host's clock, the marker's first
    marker_ns: int = 0        # perf_counter_ns just before the marker's launch
    shift: int = 0            # `device`'s mapping less `launches`'s: minus the marker kernel's lag behind its launch


class StretchControl:
    """Starts and stops the profiler around the stretch, from the window's
    per-frame hook."""

    def __init__(self, torch, device, hopper_kernels, from_frame, max_frames):
        if from_frame < 1:
            raise ValueError("the stretch starts after a frame of the episode (from_frame >= 1)")
        self.torch, self.device, self.hk = torch, device, hopper_kernels
        self.from_frame, self.max_frames = from_frame, max_frames
        self.prof = None
        self.running = False
        self.done = False
        self.episode = -1
        self.stretch = Stretch()
        self.edt_pixels = []
        self._edt = None
        self._t0 = self._marker_ns = 0

    def before_episode(self, e):
        self.episode = e

    def _start(self):
        torch = self.torch
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        edt = self._edt = self.hk.edt_l2
        pixels = self.edt_pixels

        def counted(edges):
            pixels.append(int(edges.numel()))
            return edt(edges)

        self.hk.edt_l2 = counted
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        self._marker_ns = time.perf_counter_ns()
        torch.zeros(1, device=self.device)  # the marker: the trace's first device event
        self.running = True

    def _stop(self):
        self.torch.cuda.synchronize()
        self.stretch.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.hk.edt_l2 = self._edt
        self.running, self.done = False, True

    def after_frame(self, rec, trk):
        if self.done or self.episode != 0:
            return
        if self.running:
            rec.traced = True
            self.stretch.frames += 1
            self.stretch.host += rec.host_ranges
            if rec.kind == "kf" or self.stretch.frames >= self.max_frames:
                self._stop()
        elif rec.index == self.from_frame - 1:
            self._start()

    def stop(self):
        """Stop a stretch that the episode ended inside."""
        if self.running:
            self._stop()

    def read(self):
        """The stretch with its device events and launch records (after the
        window), or None where no stretch ran."""
        if self.prof is None:
            return None
        cuda = self.torch.autograd.DeviceType.CUDA
        events = self.prof.profiler.kineto_results.events()

        def is_device(e):
            return e.device_type() == cuda

        device = sorted((e for e in events if is_device(e)), key=lambda e: e.start_ns())
        if not device:
            return self.stretch
        offset = device[0].start_ns() - self._marker_ns  # the marker
        self.stretch.device = [(e.name(), e.start_ns() - offset, e.end_ns() - offset) for e in device[1:]]
        self.stretch.marker_ns = self._marker_ns
        self.stretch.launches = launches_of(events, is_device)
        if self.stretch.launches:
            self.stretch.shift = to_host_clock(self.stretch.launches, self._marker_ns) - offset
        return self.stretch


class WindowTrace:
    """The whole window of a `--trace 0` run under torch.profiler with
    device activity only, for the end-to-end metrics whose source is the
    device trace. `warm()` (in set-up) starts CUPTI once, so the window's
    start finds it loaded. A window of the KITTI cell records 16,000-17,400
    device operations a frame, 1.2-1.9 million in 40 s, with as many runtime
    calls; reading them back takes about a minute and up to 12 GB of host
    memory.
    `stop_and_read()` raises where the operations recorded stop short of the
    traced time's end (records lost)."""

    # the share of the traced time that its first to last operation spans at
    # the least (every frame launches work; a lost tail falls short)
    COVERED = 0.9

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.prof = None
        self._t0 = 0.0

    def _profile(self):
        torch = self.torch
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def warm(self):
        prof = self._profile()
        prof.start()
        self.torch.zeros(1, device=self.device)
        self.torch.cuda.synchronize()
        prof.stop()

    def start(self):
        self.torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop_and_read(self):
        """(seconds in which the device ran an operation, operations, seconds
        taken to read the trace)."""
        torch = self.torch
        torch.cuda.synchronize()
        traced = time.perf_counter() - self._t0
        t = time.perf_counter()
        self.prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        ops = [(e.start_ns(), e.end_ns()) for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        self.prof = None
        busy = union(ops)
        if not busy or (busy[-1][1] - busy[0][0]) * 1e-9 < self.COVERED * traced:
            raise RuntimeError(f"the window's device trace lost records: {len(ops)} operations over "
                               f"{(busy[-1][1] - busy[0][0]) * 1e-9 if busy else 0:.3f} of {traced:.3f} s")
        return sum(b - a for a, b in busy) * 1e-9, len(ops), time.perf_counter() - t


def launches_of(events, is_device):
    """Launch records of the kineto `events`: each runtime call (a `cu*`
    name on the host) with the device operations of its correlation id.
    Times on the trace's clock."""
    ops = {}
    for e in events:
        if is_device(e):
            ops.setdefault(e.correlation_id(), []).append((e.name(), e.start_ns(), e.end_ns()))
    out = []
    for e in events:
        if not is_device(e) and e.name().startswith("cu") and e.correlation_id() in ops:
            out.append(Launch(e.start_ns(), ops.pop(e.correlation_id()), e.correlation_id()))
    out.sort(key=lambda launch: launch.t)
    return out


def to_host_clock(launches, marker_ns):
    """Shift launches so that the first (the marker's) starts at
    `marker_ns`; returns the shift (trace clock - host clock)."""
    offset = launches[0].t - marker_ns
    for launch in launches:
        launch.t -= offset
        launch.ops = [(n, a - offset, b - offset) for n, a, b in launch.ops]
    return offset


def union(intervals):
    """Merged (start, end) intervals of a list of (start, end)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(stretch):
    """Seconds of the stretch in which the device ran an operation."""
    return sum(b - a for a, b in union([(a, b) for _, a, b in stretch.device])) * 1e-9


def idle_gaps(device, host):
    """The idle gaps, (start, end) in ns, of the device operations `device`
    (name, start, end): between the union's intervals, and from the first
    host range's start and to the last one's end."""
    busy = union([(a, b) for _, a, b in device])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if host and busy:
        gaps = [(host[0][1], busy[0][0])] + gaps + [(busy[-1][1], host[-1][2])]
    return [(a, b) for a, b in gaps if b > a]


def breakdown(stretch, gaps=None, top=10):
    """The device ops that took most time, and the longest idle gaps of the
    device: `gaps` (label, start ns, end ns) where the port's spans were
    joined to the stretch (spans.join labels each `<harness call>/<span
    path>`), else `idle_gaps` labelled with the host range they fall in."""
    by_name = {}
    for name, a, b in stretch.device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    if gaps is None:
        gaps = [(next((lab for lab, s, e in stretch.host if s <= (a + b) / 2 <= e), "harness"), a, b)
                for a, b in idle_gaps(stretch.device, stretch.host)]
    labelled = sorted(((label, (b - a) * 1e-9) for label, a, b in gaps), key=lambda g: -g[1])
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in labelled[:top]]}
