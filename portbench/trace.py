"""The profiled stretch of a `--trace 1` run.

One fixed stretch of the window's first episode runs under torch.profiler
with device activity only (recording every host op of an object BA took
80-100 s to profile): from frame `from_frame` through the first keyframe
at or after it, at most `max_frames` frames. The stretch starts with a
marker kernel launched on an idle device, which puts the host's clock
beside the trace's, so the device's idle gaps can be labelled with what the
harness was doing: the feed's LSD call, the `track()` call, or its own
bookkeeping between calls.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Stretch:
    wall_s: float = 0.0
    frames: int = 0
    device: list = field(default_factory=list)   # (name, start ns, end ns) on the host's clock
    host: list = field(default_factory=list)     # (label, start ns, end ns)


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
        """The stretch with its device events (after the window), or None
        where no stretch ran."""
        if self.prof is None:
            return None
        events = [e for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == self.torch.autograd.DeviceType.CUDA]
        if not events:
            return self.stretch
        events.sort(key=lambda e: e.start_ns())
        offset = events[0].start_ns() - self._marker_ns  # the marker
        self.stretch.device = [(e.name(), e.start_ns() - offset, e.end_ns() - offset) for e in events[1:]]
        return self.stretch


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


def breakdown(stretch, top=10):
    """The device ops that took most time, and the longest idle gaps of the
    device labelled with the host range they fall in."""
    by_name = {}
    for name, a, b in stretch.device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union([(a, b) for _, a, b in stretch.device])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if stretch.host and busy:
        gaps = [(stretch.host[0][1], busy[0][0])] + gaps + [(busy[-1][1], stretch.host[-1][2])]
    labelled = []
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        label = next((lab for lab, s, e in stretch.host if s <= mid <= e), "harness")
        labelled.append((label, (b - a) * 1e-9))
    labelled.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in labelled[:top]]}
