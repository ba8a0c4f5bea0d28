"""The join of the port's spans to the profiled stretch (portbench/spans.py)
on a hand-made stretch: launches to their innermost span, device time,
launches and syncs per span and subtree, the clocks' check, the
idle gaps' labels as trace.breakdown prints them, and the per-frame sync
count; and the hand-off from the harness: the stretch's launch records as
StretchControl.read() keeps them, the drained spans on the Run."""

import ast
import importlib
import os
import types

import pytest

from portbench import spans, trace
from portbench.harness import FrameRecord
from portbench.tools import clock_check

BENCH = os.path.dirname(os.path.abspath(spans.__file__))


def _span(i, name, parent, start, end, counts=None):
    return types.SimpleNamespace(id=i, name=name, parent=parent, start=start, end=end, counts=counts)


# frame 12 of the stretch: the feed (LSD) then track(), whose object BA runs two LM iterations
HOST = [("feed f12", 0, 100), ("track f12", 100, 1000)]
SPANS = [
    _span(1, "lsd.detect", None, 10, 90, {"sync": 1}),
    _span(2, "lsd.fit", 1, 40, 80),
    _span(3, "frame", None, 110, 990, {"tracked": 1}),
    _span(4, "track.dispatch", 3, 120, 200),
    _span(5, "obj.ba", 3, 300, 900, {"sync": 2}),
    _span(6, "obj.ba.iter", 5, 400, 500),
    _span(7, "obj.ba.iter", 5, 500, 600, {"sync": 1}),
]
# (launch time, device operations) on the host clock
LAUNCHES = [(5, [("marker", 8, 9)]), (20, [("grad", 30, 35)]), (50, [("segsum", 55, 75)]),
            (150, [("orb", 160, 190)]), (350, [("k", 355, 360)]),
            (450, [("jac", 460, 480)]), (550, [("chol", 560, 570)]), (950, [("read", 960, 965)])]
SHIFT = -2   # the first mapping puts every device interval 2 ns earlier than the launch mapping


def _join():
    launches = [trace.Launch(t, list(ops), corr=i) for i, (t, ops) in enumerate(LAUNCHES)]
    device_old = [(n, a + SHIFT, b + SHIFT) for _, ops in LAUNCHES[1:] for n, a, b in ops]
    return spans.join_records(SPANS, HOST, device_old, launches, frames=1, shift=SHIFT)


def test_each_launch_goes_to_its_innermost_span():
    owners = spans.attribute(SPANS, [t for t, _ in LAUNCHES])
    assert owners == [None, 1, 2, 4, 5, 6, 7, 3]


def test_innermost_span_follows_parents_not_times():
    # a child that ends exactly where its sibling starts stays a sibling (the
    # later one owns the shared instant), and the parent owns what follows both
    s = [_span(1, "a", None, 0, 100), _span(2, "b", 1, 10, 20), _span(3, "c", 1, 20, 30)]
    assert spans.attribute(s, [15, 20, 25, 50, 200]) == [2, 3, 3, 1, None]


def test_device_launches_and_syncs_per_span():
    j = _join()
    assert j.owner[5] == [5, 1] and j.owner[6] == [20, 1] and j.owner[3] == [5, 1]
    assert j.subtree[5] == [5 + 20 + 10, 3, 3]   # obj.ba with its iterations: device ns, launches, syncs
    assert j.subtree[3] == [30 + 35 + 5, 5, 3]
    assert j.subtree[1] == [5 + 20, 2, 1]


def test_metrics_per_call_and_per_frame():
    j = _join()
    run = types.SimpleNamespace(cache={"spans": j})
    assert spans.device_ms_per_call(run, "obj.ba") == pytest.approx(35e-6)
    assert spans.launches_per_call(run, "obj.ba") == 3
    assert spans.device_ms_per_frame(run, "track.dispatch") == pytest.approx(30e-6)
    assert spans.device_ms_per_frame(run, "lsd.detect") == pytest.approx(25e-6)
    assert spans.device_ms_per_call(run, "loop.gba") is None
    assert spans.device_ms_per_call(types.SimpleNamespace(cache={"spans": None}), "obj.ba") is None


def test_the_clocks_check():
    c = _join().clock
    assert (c["launches"], c["outside_harness_ranges"], c["ops_before_launch"]) == (8, 0, 0)
    assert c["marker_kernel_after_launch_ns"] == 3
    assert c["lag_ns_min_p1_p50"] == [5, 5, 10] and c["outside"] == []
    assert c["marker"] == "marker" and c["marker_first_launched"] is True
    launches = [trace.Launch(t, list(ops)) for t, ops in LAUNCHES] + [trace.Launch(1500, [("late", 1400, 1401)])]
    j = spans.join_records(SPANS, HOST, [("x", 30, 35)], launches, frames=1, shift=0)
    assert j.clock["outside_harness_ranges"] == 1 and j.clock["ops_before_launch"] == 1
    assert j.clock["outside"] == [("late", 500)] and j.clock["lag_ns_min_p1_p50"][0] == -100


def test_launches_and_host_clock_from_kineto_events():
    def ev(name, dev, corr, a, b):
        return types.SimpleNamespace(name=lambda: name, device=dev, correlation_id=lambda: corr,
                                     start_ns=lambda: a, end_ns=lambda: b)

    events = [ev("cudaLaunchKernel", False, 7, 1000, 1010), ev("fill", True, 7, 1012, 1013),
              ev("Runtime Triggered Module Loading", False, 9, 1020, 1021), ev("cudaLaunchKernel", False, 9, 1020, 1030),
              ev("gemm", True, 9, 1040, 1050), ev("cudaMemcpyAsync", False, 11, 1060, 1070),
              ev("Memcpy DtoH", True, 11, 1065, 1068), ev("cudaStreamSynchronize", False, 12, 1071, 1080)]
    launches = trace.launches_of(events, lambda e: e.device)
    assert [(lau.t, lau.corr, [n for n, _, _ in lau.ops]) for lau in launches] == [
        (1000, 7, ["fill"]), (1020, 9, ["gemm"]), (1060, 11, ["Memcpy DtoH"])]
    assert trace.to_host_clock(launches, 100) == 900
    assert launches[1].t == 120 and launches[1].ops == [("gemm", 140, 150)]


def test_idle_gaps_carry_the_program_span_in_the_breakdown():
    j = _join()
    # gaps (the first mapping): 0-28, 33-53, 73-158, 188-353, 358-458, 478-558, 568-958, 963-1000,
    # labelled at the midpoints of the host's waits: 0-20, 25-50, 70-150, 180-350, 355-450, 470-550,
    # 560-950, 955-1000 (each operation starts at its launch on an idle device)
    assert [label for label, _, _ in j.gaps] == [
        "feed f12/lsd.detect", "feed f12/lsd.detect", "track f12/frame", "track f12/frame",
        "track f12/frame/obj.ba/obj.ba.iter", "track f12/frame/obj.ba/obj.ba.iter", "track f12/frame/obj.ba",
        "track f12/frame"]
    stretch = trace.Stretch(wall_s=1e-6, frames=1, device=[(n, a + SHIFT, b + SHIFT) for _, ops in LAUNCHES[1:]
                                                           for n, a, b in ops], host=list(HOST))
    before = trace.breakdown(stretch)
    after = trace.breakdown(stretch, j.gaps)
    assert [s for _, s in after["idle_gaps"]] == [s for _, s in before["idle_gaps"]]
    assert [lab.split("/")[0] for lab, _ in after["idle_gaps"]] == [lab for lab, _ in before["idle_gaps"]]
    assert after["idle_gaps"][0] == ["track f12/frame/obj.ba", pytest.approx(390e-9)]
    assert all("/" in lab for lab, _ in after["idle_gaps"])


def test_idle_share_inside_spans_below_frame_or_lsd():
    # the host clock's idle: 0-20, 25-50, 70-150, 180-350, 355-450, 470-550, 560-950, 955-1000 (905 ns);
    # covered: lsd.detect 10-90 and frame's children 120-200, 300-900
    assert spans._overlap([(0, 20), (25, 50), (70, 150), (180, 350)], [(10, 90), (120, 200)]) == 10 + 25 + 50 + 20
    assert _join().idle_in_program == pytest.approx((10 + 25 + 50 + 70 + 95 + 80 + 340) / 905)
    # the trace's own kernel times (here on time): idle 0-30, 35-55, 75-160, 190-355, 360-460, 480-560,
    # 570-960, 965-1000 (905 ns)
    assert _join().idle_in_program_trace == pytest.approx((20 + 20 + 55 + 65 + 100 + 80 + 330) / 905)


def test_device_timeline_ignores_the_gpu_clock():
    """Operations whose GPU timestamps drift (here up to 30 ns early, as if
    before their launch) keep their labels and idle share: the timeline is
    rebuilt from launches and durations."""
    drift = [0, 0, 3, 6, 10, 15, 22, 30]
    launches = [trace.Launch(t, [(n, a - d, b - d) for n, a, b in ops]) for (t, ops), d in zip(LAUNCHES, drift)]
    device_old = [(n, a + SHIFT, b + SHIFT) for lau in launches[1:] for n, a, b in lau.ops]
    j = spans.join_records(SPANS, HOST, device_old, launches, frames=1, shift=SHIFT)
    assert [lab for lab, _, _ in j.gaps] == [lab for lab, _, _ in _join().gaps]
    assert j.idle_in_program == _join().idle_in_program and j.clock["ops_before_launch"] == 4
    # on the trace's own times: idle 0-30, 35-52, 72-154, 184-345, 350-445, 465-538, 548-930, 935-1000
    assert j.idle_in_program_trace == pytest.approx((20 + 17 + 52 + 61 + 95 + 73 + 352) / 905)


def test_host_syncs_per_frame_outside_the_stretch():
    f = [FrameRecord(0, 0, 0, 1, "tracked", host_ranges=[("feed f0", 0, 100), ("track f0", 100, 1000)]),
         FrameRecord(0, 1, 0, 1, "kf", host_ranges=[("feed f1", 1000, 1100), ("track f1", 1100, 2000)], traced=True),
         FrameRecord(0, 2, 0, 1, "tracked", host_ranges=[("feed f2", 2000, 2100), ("track f2", 2100, 3000)]),
         FrameRecord(0, 3, 0, 1, "raised")]
    recs = [_span(1, "frame", None, 110, 990, {"sync": 3}), _span(2, "x", 1, 200, 300, {"sync": 2}),
            _span(3, "frame", None, 1110, 1990, {"sync": 50}), _span(4, "lsd.detect", None, 2010, 2090, {"sync": 1}),
            _span(5, "frame", None, 2110, 2990)]
    run = types.SimpleNamespace(frames=f, spans=recs)
    assert spans.per_frame_counts(run, "sync") == pytest.approx((5 + 1) / 2)
    assert spans.per_frame_counts(types.SimpleNamespace(frames=f, spans=None), "sync") is None


def test_operations_past_the_stretch_add_no_idle():
    """A launch mapped after the stretch's last range (a clock mapped too
    late) leaves the idle time and its share inside the stretch."""
    launches = [trace.Launch(t, list(ops)) for t, ops in LAUNCHES] + [
        trace.Launch(1200, [("late", 1210, 1300)]), trace.Launch(1400, [("later", 1410, 1500)])]
    device_old = [(n, a + SHIFT, b + SHIFT) for lau in launches[1:] for n, a, b in lau.ops]
    j = spans.join_records(SPANS, HOST, device_old, launches, frames=1, shift=SHIFT)
    assert j.idle_in_program == pytest.approx(_join().idle_in_program) and j.clock["outside_harness_ranges"] == 2


def test_clock_check_compares_four_clocks():
    # the marker at host 1000, launched at trace 5000, its kernel at trace 5010; two probes 1 ms apart whose
    # events agree with the host and whose kernels drift 300 ns early against their launches
    probes = [(2000, 1005), (1_002_000, 1_001_010)]
    spins = [(6020, 6035), (1_006_040, 1_005_755)]
    rows, out = clock_check.compare(probes, (1000, 5000, 5010), spins)
    assert rows[0] == {"host": 1000, "event": 1005, "launch": 1020, "kernel": 1025, "spin_start_less_launch": 15}
    assert out["event - host"] == {"first": 5, "last": 10, "min": 5, "max": 10}
    assert out["launch - host"] == {"first": 20, "last": 40, "min": 20, "max": 40}
    assert out["kernel - event"] == {"first": 20, "last": -265, "min": -265, "max": 20}
    assert out["spin_start_less_launch"] == {"min": -285, "max": 15} and out["span_s"] == pytest.approx(1e-3)
    with pytest.raises(ValueError):
        clock_check.compare(probes, (1000, 5000, 5010), spins[:1])


def _ev(name, dev, corr, a, b):
    return types.SimpleNamespace(name=lambda: name, device_type=lambda: dev, correlation_id=lambda: corr,
                                 start_ns=lambda: a, end_ns=lambda: b)


# a recorded stretch as kineto gives it: HOST's frame on the trace's clock (T ahead of the host's), the
# marker launched at MARKER_NS and starting 3 ns after its launch, a module load and a synchronize among the
# runtime calls, a graph launch with two operations, two operations starting before their launch
T, MARKER_NS = 7_000_000_000, 5
EVENTS = [
    _ev("cudaLaunchKernel", "cpu", 11, T + 5, T + 7), _ev("fill_marker", "cuda", 11, T + 8, T + 9),
    _ev("grad", "cuda", 12, T + 30, T + 35), _ev("cudaLaunchKernel", "cpu", 12, T + 20, T + 24),
    _ev("Runtime Triggered Module Loading", "cpu", 13, T + 50, T + 51),
    _ev("cudaLaunchKernel", "cpu", 13, T + 50, T + 53), _ev("segsum", "cuda", 13, T + 55, T + 75),
    _ev("cudaLaunchKernel", "cpu", 14, T + 150, T + 153), _ev("orb", "cuda", 14, T + 157, T + 187),
    _ev("cudaLaunchKernel", "cpu", 15, T + 350, T + 352), _ev("k", "cuda", 15, T + 349, T + 354),
    _ev("cudaGraphLaunch", "cpu", 16, T + 450, T + 456), _ev("jac", "cuda", 16, T + 458, T + 468),
    _ev("jac2", "cuda", 16, T + 468, T + 478),
    _ev("cudaLaunchKernel", "cpu", 17, T + 550, T + 552), _ev("chol", "cuda", 17, T + 556, T + 566),
    _ev("cudaStreamSynchronize", "cpu", 18, T + 600, T + 650),
    _ev("Memcpy DtoH", "cuda", 19, T + 955, T + 960), _ev("cudaMemcpyAsync", "cpu", 19, T + 950, T + 961),
]


def _recorded_stretch():
    fake_torch = types.SimpleNamespace(autograd=types.SimpleNamespace(DeviceType=types.SimpleNamespace(CUDA="cuda")))
    ctl = trace.StretchControl(fake_torch, "cuda", None, 12, 12)
    ctl.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: list(EVENTS))))
    ctl._marker_ns = MARKER_NS
    ctl.stretch.host, ctl.stretch.frames, ctl.stretch.wall_s = list(HOST), 1, 1e-6
    return ctl.read()


def test_the_stretch_keeps_its_launch_records_on_the_host_clock():
    st = _recorded_stretch()
    assert [(lau.t, lau.corr, [n for n, _, _ in lau.ops]) for lau in st.launches] == [
        (5, 11, ["fill_marker"]), (20, 12, ["grad"]), (50, 13, ["segsum"]), (150, 14, ["orb"]), (350, 15, ["k"]),
        (450, 16, ["jac", "jac2"]), (550, 17, ["chol"]), (950, 19, ["Memcpy DtoH"])]
    assert st.launches[5].ops == [("jac", 458, 468), ("jac2", 468, 478)]
    # the device operations keep their mapping by the marker kernel's start, 3 ns after its launch
    assert st.marker_ns == MARKER_NS and st.shift == -3
    assert st.device[:2] == [("grad", 27, 32), ("segsum", 52, 72)] and len(st.device) == 8


def test_join_of_a_recorded_stretch_matches_the_parents():
    """The join reads the drained spans on the Run and the launch records on
    the stretch, and gives what the join gave when it searched the process
    for the StretchControl and rewrote the stretch's host ranges (each value
    pinned from that code on these events)."""
    st = _recorded_stretch()
    run = types.SimpleNamespace(spans=SPANS, trace=st, cache={})
    j = spans.join(run)
    assert j.owner == {1: [5, 1], 2: [20, 1], 4: [30, 1], 5: [5, 1], 6: [20, 1], 7: [10, 1], 3: [5, 1]}
    assert j.subtree == {1: [25, 2, 1], 2: [20, 1, 0], 3: [70, 5, 3], 4: [30, 1, 0], 5: [35, 3, 3],
                         6: [20, 1, 0], 7: [10, 1, 1]}
    assert j.self_ns == {1: 40, 2: 40, 3: 200, 4: 80, 5: 400, 6: 100, 7: 100}
    assert j.gaps == [("feed f12/lsd.detect", 0, 27), ("feed f12/lsd.detect", 32, 52), ("track f12/frame", 72, 154),
                      ("track f12/frame", 184, 346), ("track f12/frame/obj.ba/obj.ba.iter", 351, 455),
                      ("track f12/frame/obj.ba/obj.ba.iter", 475, 553), ("track f12/frame/obj.ba", 563, 952),
                      ("track f12/frame", 957, 1000)]
    assert j.idle_in_program == j.idle_in_program_trace == pytest.approx(0.7403314917127072, rel=1e-15)
    assert j.clock == {"launches": 8, "outside_harness_ranges": 0, "ops_before_launch": 1,
                       "marker_kernel_after_launch_ns": 3, "lag_ns_min_p1_p50": [-1, -1, 7], "outside": [],
                       "marker": "fill_marker", "marker_first_launched": True}
    assert (j.stretch, j.frames) == ((0, 1000), 1)
    assert st.host == HOST   # read, not rewritten
    assert trace.breakdown(st, j.gaps) == {
        "device_ops": [["orb", 3.0000000000000004e-08], ["segsum", 2e-08], ["jac", 1e-08], ["jac2", 1e-08],
                       ["chol", 1e-08], ["grad", 5e-09], ["k", 5e-09], ["Memcpy DtoH", 5e-09]],
        "idle_gaps": [["track f12/frame/obj.ba", 3.89e-07], ["track f12/frame", 1.6200000000000002e-07],
                      ["track f12/frame/obj.ba/obj.ba.iter", 1.04e-07], ["track f12/frame", 8.2e-08],
                      ["track f12/frame/obj.ba/obj.ba.iter", 7.800000000000001e-08], ["track f12/frame", 4.3e-08],
                      ["feed f12/lsd.detect", 2.7e-08], ["feed f12/lsd.detect", 2e-08]]}
    metric_run = types.SimpleNamespace(spans=SPANS, trace=st, cache=run.cache, frames=[], edt_pixels=[])
    assert [importlib.import_module(f"portbench.metrics.{m}").read(metric_run) for m in
            ("object_ba_device_ms", "object_ba_launches", "track_device_ms", "lsd_device_ms", "device_idle_pct")] == [
        3.5e-05, 3.0, 2.9999999999999997e-05, 2.4999999999999998e-05, 90.5]


def test_no_join_without_spans_or_launch_records():
    st = _recorded_stretch()
    assert spans.join(types.SimpleNamespace(spans=None, trace=st, cache={})) is None
    assert spans.join(types.SimpleNamespace(spans=SPANS, trace=None, cache={})) is None
    st.launches = []
    assert spans.join(types.SimpleNamespace(spans=SPANS, trace=st, cache={})) is None


def _modules():
    for root, _, files in os.walk(BENCH):
        if "tests" in root.split(os.sep) or "_frames" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    yield os.path.relpath(path, BENCH), ast.parse(fh.read())


def test_no_module_searches_the_process_for_objects():
    found = [name for name, tree in _modules()
             if any(isinstance(n, ast.Attribute) and n.attr in ("get_objects", "get_referrers") for n in ast.walk(tree))]
    assert found == []


def test_the_join_reads_what_the_harness_hands_over():
    """The join's inputs come from the harness: the spans drained after the
    window on the Run (no module of the benchmark drains or resets the
    port's profiler after it, or reads the port's modules from
    sys.modules), the launch records on the stretch, which only trace.py
    writes, and the joined gaps go to trace.breakdown as an argument."""
    writers, readers_of_modules = set(), set()
    for name, tree in _modules():
        for n in ast.walk(tree):
            if isinstance(n, ast.Attribute) and n.attr in ("host", "launches", "shift", "marker_ns") \
                    and isinstance(n.ctx, ast.Store):
                writers.add(name)
            if isinstance(n, ast.Attribute) and n.attr == "modules" and getattr(n.value, "id", None) == "sys":
                readers_of_modules.add(name)
    assert writers == {"trace.py"}
    assert readers_of_modules == {"harness.py"}   # its look for JAX once the window has closed
    with open(os.path.join(BENCH, "harness.py")) as fh:
        src = fh.read()
    assert src.count('port["profiler"].drain()') == 1 and 'port["profiler"].reset()' not in src
    assert "trace_mod.breakdown(run.trace, None if joined is None else joined.gaps)" in src
