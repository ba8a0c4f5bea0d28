"""The port's own spans joined to the profiled stretch of a `--trace 1` run.

While a traced run's window is open, the port's profiler
(cube_slam_tpu_torch/utils/profiler.py) records every span with its start,
end, parent, frame id and counters on time.perf_counter_ns(). Beside each
device operation of the stretch, torch.profiler records the CUDA runtime
call that launched it, under the same correlation id. The harness hands
both over after the window, the spans drained from the port's profiler as
`Run.spans`, the launch records as `Run.trace.launches` (trace.py), and
`join(run)` reads them once:

- The launch records are on perf_counter_ns by the marker's launch record
  (the stretch's first launch, made just after the harness read its clock;
  its kernel's name and whether its correlation id is the first are
  logged), not by the marker kernel's start, which lags its launch by the
  queue.
- Each device operation goes to the innermost program span in which its
  launch was made. Per span this gives its device busy time, its launches
  and its self time (its wall time less its children's).
- The trace's GPU timestamps can drift from the host's clock within a
  stretch: in one KITTI stretch they fell 10.7 ms behind their launches in
  1.2 s while CUDA events, on the GPU's own clock, kept the host's to 51 us
  (tools/clock_check.py; PERF.md, section 6). So the device's timeline is
  rebuilt on the host's clock from each operation's launch and its
  duration (one stream: an operation starts at its launch or when the one
  before it ends). Each idle gap of the device gets, after the harness's
  label, the path of the innermost program span open at the midpoint of
  the host's wait before the launch that ended it:
  `track f12/frame/obj.ba/obj.ba.stage2/obj.ba.iter`; the harness passes
  these labelled gaps to trace.breakdown. The share of the idle time inside
  program spans is given on both timelines: the rebuilt one
  (`idle_in_program`, whose gaps are host time before a launch by
  construction) and the trace's own kernel times (`idle_in_program_trace`).

A metric gets the Run alone. On a run without a stretch or without launch
records, `join` gives None and the metrics that read it report nothing.
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass, field

from . import trace

SYNC = "sync"


@dataclass
class Joined:
    spans: list               # the window's closed program spans, in the order they opened
    stretch: tuple            # (start, end) of the stretch, perf_counter_ns
    frames: int               # frames in the stretch
    owner: dict = field(default_factory=dict)       # span id -> [device ns, launches] of its own launches
    subtree: dict = field(default_factory=dict)     # span id -> [device ns, launches, syncs] with its descendants
    self_ns: dict = field(default_factory=dict)     # span id -> its wall less its children's
    gaps: list = field(default_factory=list)        # (label, start, end) of every idle gap, as the stretch maps it
    idle_in_program: float | None = None            # share of the idle time inside a span below frame or lsd.detect
    idle_in_program_trace: float | None = None      # the same on the trace's own kernel times
    clock: dict = field(default_factory=dict)       # the clocks' agreement


def attribute(spans, times):
    """The id of the innermost span open at each of the sorted `times`
    (None outside every span). `spans` in the order they opened, properly
    nested (one thread records)."""
    stack, i, out = [], 0, []
    for t in times:
        while i < len(spans) and spans[i].start <= t:
            s = spans[i]
            while stack and stack[-1].id != s.parent:
                stack.pop()
            stack.append(s)
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1].id if stack else None)
    return out


def path(by_id, sid):
    """'root/.../name' of span `sid` ('' for None)."""
    names = []
    while sid in by_id:
        names.append(by_id[sid].name)
        sid = by_id[sid].parent
    return "/".join(reversed(names))


def _merge(intervals):
    return [tuple(iv) for iv in trace.union(intervals)]


def _overlap(a, b):
    """Total overlap of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _idle(busy, lo, hi):
    """The gaps of `lo`..`hi` that the (start, end) intervals `busy`, in
    start order, leave uncovered."""
    idle, prev = [], lo
    for start, end in busy:
        if min(start, hi) > prev:
            idle.append((prev, min(start, hi)))
        prev = max(prev, end)
    if hi > prev:
        idle.append((prev, hi))
    return idle


def join_records(spans, host, device_old, launches, frames, shift):
    """The join on hand-made inputs: `spans` the program's records, `host`
    the harness's (label, start, end) ranges of the stretch, `device_old`
    the stretch's device intervals as trace.Stretch holds them (mapped by
    the marker kernel's start), `launches` on the host clock (mapped by the
    marker's launch, in launch order), `frames` the stretch's frame count,
    `shift` the first mapping less the second (minus the marker kernel's lag
    behind its launch)."""
    by_id = {s.id: s for s in spans}
    j = Joined(spans, (host[0][1], host[-1][2]) if host else (0, 0), frames, self_ns=self_ns(spans))
    for s in spans:
        j.subtree[s.id] = [0, 0, (s.counts or {}).get(SYNC, 0)]
    for launch, sid in zip(launches, attribute(spans, [launch.t for launch in launches])):
        if sid is None:
            continue
        dev = sum(b - a for _, a, b in launch.ops)
        own = j.owner.setdefault(sid, [0, 0])
        own[0] += dev
        own[1] += 1
    for s in spans:
        own = j.owner.get(s.id)
        if own:
            j.subtree[s.id][0] += own[0]
            j.subtree[s.id][1] += own[1]
    for s in reversed(spans):   # children after their parents in open order
        if s.parent in by_id:
            for k in range(3):
                j.subtree[s.parent][k] += j.subtree[s.id][k]

    # the clocks: each launch inside a harness range, each operation after its launch
    outside = [launch for launch in launches[1:] if not any(s <= launch.t <= e for _, s, e in host)]
    lags = sorted(a - launch.t for launch in launches[1:] for _, a, _ in launch.ops)
    j.clock = {"launches": len(launches), "outside_harness_ranges": len(outside),
               "ops_before_launch": sum(1 for d in lags if d < 0),
               "marker_kernel_after_launch_ns": launches[0].ops[0][1] - launches[0].t if launches else None,
               "lag_ns_min_p1_p50": [lags[0], lags[len(lags) // 100], lags[len(lags) // 2]] if lags else [],
               "outside": [(launch.ops[0][0][:60], min(min(abs(launch.t - s), abs(launch.t - e)) for _, s, e in host))
                           for launch in outside[:3]],
               "marker": launches[0].ops[0][0][:80] if launches else None,
               "marker_first_launched": bool(launches) and launches[0].corr == min(lau.corr for lau in launches)}

    # the device's timeline on the host's clock, from each operation's launch and duration: one stream,
    # so an operation starts at its launch or when the one before it ends. The trace's GPU timestamps
    # drift against the host's (the clocks above), its durations do not.
    ops = [(launch.t, b - a, a) for launch in launches[1:] for _, a, b in launch.ops]
    timeline, end = [], None
    for t, dur, _ in ops:
        start = t if end is None else max(t, end)
        end = start + dur
        timeline.append((start, end))
    lo, hi = j.stretch
    covered = _merge([(s.start, s.end) for s in spans if _below_frame_or_lsd(s, by_id)])
    for attr, busy in (("idle_in_program", timeline),
                       ("idle_in_program_trace", sorted((a, b) for lau in launches[1:] for _, a, b in lau.ops))):
        idle = _idle(busy, lo, hi)
        total = sum(b - a for a, b in idle)
        setattr(j, attr, _overlap(idle, covered) / total if total > 0 else None)

    # the stretch's idle gaps (on the first mapping), each labelled at the midpoint of the host's wait before
    # the launch that ended it
    gaps = trace.idle_gaps(device_old, host)
    opening = {a: k for k, (_, _, a) in enumerate(ops)}
    mids = []
    for _, b in gaps:
        k = opening.get(b - shift)
        wait = ((timeline[k - 1][1] if k else lo, timeline[k][0]) if k is not None
                else (timeline[-1][1] if timeline else lo, hi))
        mids.append((min(wait) + wait[1]) / 2)   # an empty wait (the launch queued): the launch
    order = sorted(range(len(mids)), key=mids.__getitem__)
    owners = dict(zip(order, attribute(spans, [mids[i] for i in order])))
    for i, (a, b) in enumerate(gaps):
        harness = next((lab for lab, s, e in host if s <= mids[i] <= e), "harness")
        p = path(by_id, owners[i])
        j.gaps.append((harness + ("/" + p if p else ""), a, b))
    return j


def _below_frame_or_lsd(s, by_id):
    """A span inside a `frame` root (not the root itself), or lsd.detect or
    a span inside it."""
    chain = [s]
    while chain[-1].parent in by_id:
        chain.append(by_id[chain[-1].parent])
    names = [c.name for c in chain]
    return (names[-1] == "frame" and len(chain) > 1) or "lsd.detect" in names


def self_ns(spans):
    """span id -> its duration less its children's (children of one parent
    do not overlap: one thread records)."""
    out = {s.id: s.end - s.start for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end - s.start
    return out


def records(run):
    """The port's closed spans of the window, as the harness drained them,
    or None where it drained none."""
    return None if run.spans is None else [s for s in run.spans if s.end is not None]


def per_frame_counts(run, counter):
    """The counter summed over the spans of each frame outside the profiled
    stretch (its feed and its track() call), per frame; None without
    records."""
    spans = records(run)
    frames = [r for r in run.frames if not r.traced and r.kind != "raised" and r.host_ranges]
    if spans is None or not frames:
        return None
    starts = [s.start for s in spans]
    total = 0
    for r in frames:
        lo = bisect.bisect_left(starts, r.host_ranges[0][1])
        hi = bisect.bisect_right(starts, r.host_ranges[-1][2])
        total += sum((s.counts or {}).get(counter, 0) for s in spans[lo:hi])
    return total / len(frames)


def join(run):
    """The run's spans joined to its stretch (cached in run.cache), or
    None."""
    if "spans" in run.cache:
        return run.cache["spans"]
    run.cache["spans"] = None
    spans, st = records(run), run.trace
    if spans is None or st is None or not st.host or not st.launches:
        return None
    j = join_records(spans, st.host, st.device, st.launches, st.frames, st.shift)
    run.cache["spans"] = j
    _log(j)
    return j


def in_stretch(j, name):
    a, b = j.stretch
    return [s for s in j.spans if s.name == name and a <= s.start <= b]


def device_ms_per_call(run, name):
    """Device ms of what the spans `name` in the stretch launched, their
    descendants' included, per span; None without one."""
    j = join(run)
    calls = in_stretch(j, name) if j is not None else []
    return sum(j.subtree[s.id][0] for s in calls) * 1e-6 / len(calls) if calls else None


def launches_per_call(run, name):
    j = join(run)
    calls = in_stretch(j, name) if j is not None else []
    return sum(j.subtree[s.id][1] for s in calls) / len(calls) if calls else None


def device_ms_per_frame(run, name):
    """Device ms of what the spans `name` in the stretch launched, per
    frame of the stretch; None where the stretch has none of them."""
    j = join(run)
    calls = in_stretch(j, name) if j is not None else []
    return sum(j.subtree[s.id][0] for s in calls) * 1e-6 / j.frames if calls and j.frames else None


def table(j):
    """Per span name inside the stretch: calls, wall, self and device ms,
    launches and syncs, each of the span itself (device, launches and syncs
    of what it launched or counted while innermost), largest wall first."""
    a, b = j.stretch
    rows = {}
    for s in j.spans:
        if not a <= s.start <= b:
            continue
        own = j.owner.get(s.id, (0, 0))
        r = rows.setdefault(s.name, [0, 0, 0, 0, 0, 0])
        r[0] += 1
        r[1] += (s.end - s.start) * 1e-6
        r[2] += j.self_ns.get(s.id, 0) * 1e-6
        r[3] += own[0] * 1e-6
        r[4] += own[1]
        r[5] += (s.counts or {}).get(SYNC, 0)
    return sorted(rows.items(), key=lambda kv: -kv[1][1])


def _log(j):
    out = sys.stderr
    c = j.clock
    print(f"[spans] clocks: {c['launches']} launches in the stretch, {c['outside_harness_ranges']} outside the "
          f"harness's feed/track ranges (the marker's not counted; operation, ns from the nearest range: "
          f"{c['outside']}), {c['ops_before_launch']} device operations starting before their launch (start less "
          f"launch, ns: min, 1st percentile, median {c['lag_ns_min_p1_p50']}); the marker kernel started "
          f"{c['marker_kernel_after_launch_ns']} ns after its launch", file=out)
    print(f"[spans] marker: {c['marker']}, first launched by correlation id: {c['marker_first_launched']}",
          file=out)
    for name, share in (("the rebuilt timeline", j.idle_in_program),
                        ("the trace's own kernel times", j.idle_in_program_trace)):
        if share is not None:
            print(f"[spans] idle time inside a program span below frame or lsd.detect, on {name}: "
                  f"{100 * share:.1f}%", file=out)
    print("[spans] name calls wall_ms self_ms device_ms launches syncs (the stretch; device, launches and syncs "
          "of the span as the innermost)", file=out)
    for name, (n, wall, self_ms, dev, lau, syn) in table(j)[:40]:
        print(f"[spans] {name} {n} {wall:.3f} {self_ms:.3f} {dev:.3f} {lau} {syn}", file=out)
    a, b = j.stretch
    counts = {}
    for s in j.spans:
        if a <= s.start <= b:
            for k, n in (s.counts or {}).items():
                if k != SYNC:
                    counts.setdefault((s.name, k), []).append(n)
    print("[spans] counters of the stretch's spans (span/counter: per call)", file=out)
    for (name, k), ns in sorted(counts.items()):
        print(f"[spans] counter {name}/{k} {ns}", file=out)
    idle = {}
    for label, a, b in j.gaps:
        key = label.split("/", 1)[1] if "/" in label else "(no span)"
        idle[key] = idle.get(key, 0) + (b - a) * 1e-9
    print("[spans] idle s by innermost program span (the stretch):", file=out)
    for key, sec in sorted(idle.items(), key=lambda kv: -kv[1])[:20]:
        print(f"[spans] idle {key} {sec:.4f}", file=out)
