"""Aggregating wall-clock profiler with the reference's label granularity.

PyTorch counterpart of cube_slam_tpu/utils/profiler.py (itself the
replacement for dependency/tictoc_profiler, profiler.hpp:54-84): paired
tictoc(name) calls record spans; print_aggregated() reports
total/min/avg/max/count per label. `trace(name)` labels a range in
torch.profiler timelines. Device work inside a span is charged to it by
passing a tensor as `sync_value`: the span then synchronizes the tensor's
CUDA device before it closes (a CPU tensor needs no wait).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_enabled = False
_open_spans = {}
_records = defaultdict(list)


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def reset():
    _open_spans.clear()
    _records.clear()


def _sync(value):
    """Wait for the device work behind a tensor (or a tuple/list/dict of
    them); the torch counterpart of jax.block_until_ready."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            _sync(v)
    elif torch.is_tensor(value) and value.is_cuda:
        torch.cuda.synchronize(value.device)


def tictoc(name, sync_value=None):
    """Paired call API matching ca::Profiler::tictoc (profiler.hpp:62):
    first call opens a span, second closes and records it."""
    if not _enabled:
        return
    now = time.perf_counter()
    if name in _open_spans:
        if sync_value is not None:
            _sync(sync_value)
            now = time.perf_counter()
        _records[name].append(now - _open_spans.pop(name))
    else:
        _open_spans[name] = now


@contextmanager
def span(name, sync_value=None):
    """Context-manager form; optionally waits for a device value at exit so
    asynchronous work is charged to the right label."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_value is not None:
            _sync(sync_value)
        _records[name].append(time.perf_counter() - t0)


@contextmanager
def trace(name):
    """torch.profiler.record_function wrapper for device timelines."""
    with torch.profiler.record_function(name):
        yield


def aggregated():
    """dict: label -> (total_ms, min_ms, avg_ms, max_ms, count)."""
    out = {}
    for name, spans in _records.items():
        ms = [s * 1000.0 for s in spans]
        out[name] = (sum(ms), min(ms), sum(ms) / len(ms), max(ms), len(ms))
    return out


def print_aggregated():
    """Formatted like tictoc_profiler's exit dump (profiler.hpp:68-72)."""
    rows = aggregated()
    if not rows:
        print("[profiler] no records")
        return
    width = max(len(n) for n in rows)
    print(f"{'label'.ljust(width)}  total_ms     min_ms     avg_ms     max_ms  calls")
    for name in sorted(rows):
        total, mn, avg, mx, cnt = rows[name]
        print(f"{name.ljust(width)}  {total:9.2f}  {mn:9.3f}  {avg:9.3f}  {mx:9.3f}  {cnt:5d}")
