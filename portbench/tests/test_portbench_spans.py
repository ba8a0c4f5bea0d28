"""The join of the port's spans to the profiled stretch (portbench/spans.py)
on a hand-made stretch: launches to their innermost span, device time,
launches and syncs per span and subtree, the clocks' check, the
idle gaps' labels as trace.breakdown prints them, and the per-frame sync
count."""

import ast
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
    launches = [spans.Launch(t, list(ops), corr=i) for i, (t, ops) in enumerate(LAUNCHES)]
    device_old = [(n, a + SHIFT, b + SHIFT) for _, ops in LAUNCHES[1:] for n, a, b in ops]
    return spans.join_records(SPANS, HOST, device_old, launches, frames=1, shift=SHIFT, self_ns={})


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
    launches = [spans.Launch(t, list(ops)) for t, ops in LAUNCHES] + [spans.Launch(1500, [("late", 1400, 1401)])]
    j = spans.join_records(SPANS, HOST, [("x", 30, 35)], launches, frames=1, shift=0, self_ns={})
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
    launches = spans.launches_of(events, lambda e: e.device)
    assert [(lau.t, lau.corr, [n for n, _, _ in lau.ops]) for lau in launches] == [
        (1000, 7, ["fill"]), (1020, 9, ["gemm"]), (1060, 11, ["Memcpy DtoH"])]
    assert spans.to_host_clock(launches, 100) == 900
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
    stretch.host = spans.gap_ranges(j, HOST)
    after = trace.breakdown(stretch)
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
    launches = [spans.Launch(t, [(n, a - d, b - d) for n, a, b in ops]) for (t, ops), d in zip(LAUNCHES, drift)]
    device_old = [(n, a + SHIFT, b + SHIFT) for lau in launches[1:] for n, a, b in lau.ops]
    j = spans.join_records(SPANS, HOST, device_old, launches, frames=1, shift=SHIFT, self_ns={})
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
    run = types.SimpleNamespace(frames=f, cache={"records": recs})
    assert spans.per_frame_counts(run, "sync") == pytest.approx((5 + 1) / 2)
    assert spans.per_frame_counts(types.SimpleNamespace(frames=f, cache={"records": None}), "sync") is None


def test_operations_past_the_stretch_add_no_idle():
    """A launch mapped after the stretch's last range (a clock mapped too
    late) leaves the idle time and its share inside the stretch."""
    launches = [spans.Launch(t, list(ops)) for t, ops in LAUNCHES] + [
        spans.Launch(1200, [("late", 1210, 1300)]), spans.Launch(1400, [("later", 1410, 1500)])]
    device_old = [(n, a + SHIFT, b + SHIFT) for lau in launches[1:] for n, a, b in lau.ops]
    j = spans.join_records(SPANS, HOST, device_old, launches, frames=1, shift=SHIFT, self_ns={})
    assert j.idle_in_program == pytest.approx(_join().idle_in_program) and j.clock["outside_harness_ranges"] == 2


def test_only_the_join_reads_the_stretch_host_ranges_before_the_breakdown():
    """spans.join replaces the stretch's host ranges (`st.host`) while the
    metrics are read, so that trace.breakdown, after them, labels gaps with
    the program span. That holds only while no other module reads `.host`
    and the harness builds the breakdown after the metrics: this fails when
    either changes."""
    readers = set()
    for root, _, files in os.walk(BENCH):
        if "tests" in root.split(os.sep) or "_frames" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read())
                if any(isinstance(n, ast.Attribute) and n.attr == "host" for n in ast.walk(tree)):
                    readers.add(os.path.relpath(path, BENCH))
    assert readers == {"spans.py", "trace.py"}
    with open(os.path.join(BENCH, "harness.py")) as fh:
        src = fh.read()
    assert src.index('reader("metrics", name).read(run)') < src.index("trace_mod.breakdown(run.trace)")


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
