"""The port's span store: where a frame's time goes, layer by layer.

While the profiler is enabled, `with span(name):` records one `Span`: its
name, its parent (the span that was open when it opened), the frame id,
and its start and end on `time.perf_counter_ns()`. The tracker's root
span `frame` sets the frame id that every span opened inside it carries.
`count(name, n)` adds to a counter of the innermost open span. Spans stay
in memory in one flat list, the log, in the order they opened, until
`drain()` hands them over and forgets them; `dump_jsonl(path)` writes
them one JSON object per line. `reset()` starts a new view without
clearing the log: `records()` reads the view's spans, `aggregated()` and
`print_aggregated()` sum them per name, with the reference's label
granularity (dependency/tictoc_profiler, profiler.hpp:54-84), and
`counters()` per span name and counter.

On a CUDA machine, every operation that makes the host wait on the stream
while the profiler is enabled (a read-back, `.item()`, `nonzero`,
`bool(tensor)`, an upload from pageable host memory) adds 1 to the
counter `sync` of the innermost open span: torch's sync debug mode warns
on each one, and a warnings hook counts the warning and swallows it. The
mode does not see `torch.cuda.synchronize()` or an event's `synchronize()`.

Disabled (the default), `span()` returns one shared no-op context and
`count()` returns at once: one flag test each, no allocation, no
synchronization. One thread records at a time.
"""

from __future__ import annotations

import itertools
import json
import time
import warnings

import torch

SYNC = "sync"
# the text of torch's warning on a synchronizing CUDA operation
_SYNC_WARNING = "called a synchronizing CUDA operation"

_enabled = False
_spans = []       # the log: every record made since the last drain(), in the order they opened
_since = 0        # where the current view (since the last reset()) starts in _spans
_stack = []       # the open spans, innermost last
_frame = None     # the frame id of the open `frame` span
_ids = itertools.count()
_sync_saved = None  # (sync debug mode, warnings.showwarning) while the sync hook is on


class Span:
    """One span: `parent` is the id of the span open when it opened (None
    at the root), `frame` the frame id then (given, it sets the frame id of
    the spans opened inside), `start` and `end` are perf_counter_ns (`end`
    None while open), `counts` its counters (None while it has none)."""

    __slots__ = ("id", "name", "parent", "frame", "start", "end", "counts", "_outer_frame")

    def __init__(self, name, frame=None):
        self.name = name
        self.frame = frame

    def __enter__(self):
        global _frame
        self._outer_frame = _frame
        if self.frame is None:
            self.frame = _frame
        else:
            _frame = self.frame
        self.id = next(_ids)
        self.parent = _stack[-1].id if _stack else None
        self.counts = None
        self.end = None
        _spans.append(self)
        _stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _frame
        self.end = time.perf_counter_ns()
        if _stack and _stack[-1] is self:
            _stack.pop()
        _frame = self._outer_frame
        return False

    def as_dict(self):
        return {"id": self.id, "name": self.name, "parent": self.parent, "frame": self.frame,
                "start_ns": self.start, "end_ns": self.end, "counts": self.counts or {}}


class _Off:
    """The context `span()` returns while disabled."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def enabled():
    return _enabled


def enable():
    global _enabled
    if not _enabled:
        _enabled = True
        _sync_hook_on()


def disable():
    global _enabled
    if _enabled:
        _enabled = False
        _sync_hook_off()


def reset():
    """Start a new view: `records()`, `aggregated()` and `counters()` read
    only what is recorded from here on. The log is not cleared: `drain()`
    and `dump_jsonl()` hand over every record made since the last
    `drain()`, across resets."""
    global _since
    _since = len(_spans)
    _stack.clear()


def span(name):
    """`with span(name):` records a span while the profiler is enabled."""
    if not _enabled:
        return _OFF
    return Span(name)


def frame(fid):
    """The tracker's root span `frame` for frame `fid`; a no-op inside an
    open `frame` (a tracker whose track() calls its base class's)."""
    if not _enabled or _frame is not None:
        return _OFF
    return Span("frame", fid)


def count(name, n=1):
    """Add `n` to the counter `name` of the innermost open span."""
    if not _enabled or not _stack:
        return
    s = _stack[-1]
    if s.counts is None:
        s.counts = {}
    s.counts[name] = s.counts.get(name, 0) + n


def records():
    """The spans of the current view, in the order they opened (open ones
    with `end` None)."""
    return _spans[_since:]


def drain():
    """Every record made since the last drain, handed over and forgotten."""
    global _since
    out = list(_spans)
    _spans.clear()
    _since = 0
    return out


def dump_jsonl(path):
    """Write every record made since the last drain to `path`, one JSON
    object per line."""
    with open(path, "w") as f:
        for s in _spans:
            f.write(json.dumps(s.as_dict()) + "\n")


def self_ns(spans):
    """span id -> its duration less the part of it that its children cover
    (children of one parent do not overlap: one thread records)."""
    out = {s.id: s.end - s.start for s in spans if s.end is not None}
    for s in spans:
        if s.end is not None and s.parent in out:
            out[s.parent] -= s.end - s.start
    return out


def aggregated():
    """dict: label -> (total_ms, min_ms, avg_ms, max_ms, count) over the
    closed spans of the current view."""
    ms = {}
    for s in records():
        if s.end is not None:
            ms.setdefault(s.name, []).append((s.end - s.start) * 1e-6)
    return {name: (sum(v), min(v), sum(v) / len(v), max(v), len(v)) for name, v in ms.items()}


def counters():
    """dict: (span name, counter) -> total over the spans of the current
    view. A counter belongs to its span: `keyframes` on `frame` (the map's)
    and on `obj.ba` (the window's) are two counters."""
    out = {}
    for s in records():
        for k, n in (s.counts or {}).items():
            key = (s.name, k)
            out[key] = out.get(key, 0) + n
    return out


def print_aggregated():
    """Formatted like tictoc_profiler's exit dump (profiler.hpp:68-72), then
    the counters."""
    rows = aggregated()
    if not rows:
        print("[profiler] no records")
        return
    width = max(len(n) for n in rows)
    print(f"{'label'.ljust(width)}  total_ms     min_ms     avg_ms     max_ms  calls")
    for name in sorted(rows):
        total, mn, avg, mx, cnt = rows[name]
        print(f"{name.ljust(width)}  {total:9.2f}  {mn:9.3f}  {avg:9.3f}  {mx:9.3f}  {cnt:5d}")
    for (name, counter), n in sorted(counters().items()):
        print(f"[counter] {name}/{counter} {n}")


def _on_warning(message, category, filename, lineno, file=None, line=None):
    if str(message).startswith(_SYNC_WARNING):
        count(SYNC)
        return
    show = _sync_saved[1] if _sync_saved is not None else warnings._showwarning_orig
    show(message, category, filename, lineno, file, line)


def _sync_hook_on():
    """Count synchronizing CUDA operations (nothing to count without CUDA)."""
    global _sync_saved
    if not torch.cuda.is_available():
        return
    mode, show = torch.cuda.get_sync_debug_mode(), warnings.showwarning
    warnings.filterwarnings("always", message=_SYNC_WARNING)
    _sync_saved = (mode, show, warnings.filters[0])
    warnings.showwarning = _on_warning
    torch.cuda.set_sync_debug_mode("warn")


def _sync_hook_off():
    global _sync_saved
    if _sync_saved is None:
        return
    mode, show, flt = _sync_saved
    _sync_saved = None
    torch.cuda.set_sync_debug_mode(mode)
    warnings.showwarning = show
    if flt in warnings.filters:
        warnings.filters.remove(flt)
        warnings._filters_mutated()
