"""The metrics' arithmetic on hand-made runs: the rate over a window, the
window's close, the spans per call and per frame, the union of device
intervals, the card's busy time per frame over a window's device trace,
the EDT's byte count and the breakdown's labels."""

import types

import numpy as np
import pytest

from portbench import trace
from portbench.checks import line_err
from portbench.harness import FrameRecord
from portbench.metrics import (device_idle_pct, device_ms_per_frame, edt_roofline_pct, frames_per_s, keyframe_ms,
                               lines_ms, object_ba_ms, track_ms)


def _run(frames, window_s=2.0, stretch=None, edt_pixels=(), device_busy_s=None):
    return types.SimpleNamespace(frames=frames, window_s=window_s, trace=stretch, edt_pixels=list(edt_pixels),
                                 device_busy_s=device_busy_s)


def test_rate_counts_completed_frames_over_the_window():
    frames = [FrameRecord(0, i, 0, 10.0, "tracked") for i in range(9)] + [FrameRecord(0, 9, 0, 5.0, "raised")]
    assert frames_per_s.read(_run(frames, window_s=3.0)) == pytest.approx(3.0)
    assert frames_per_s.read(_run([], window_s=0.0)) is None


def test_device_ms_per_frame_is_the_windows_busy_time_over_its_completed_frames():
    frames = [FrameRecord(0, i, 0, 10.0, "tracked") for i in range(4)] + [FrameRecord(0, 4, 0, 5.0, "raised")]
    assert device_ms_per_frame.read(_run(frames, device_busy_s=0.25)) == pytest.approx(62.5)
    assert device_ms_per_frame.read(_run(frames)) is None
    assert device_ms_per_frame.read(_run(frames[4:], device_busy_s=0.25)) is None


class _Event:
    def __init__(self, a, b, device):
        self.a, self.b, self.device = a, b, device

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def device_type(self):
        return self.device


class _Torch:
    """What WindowTrace calls of torch, with a profiler that hands back
    `events` (start, end in ns, on the device or not)."""

    def __init__(self, events):
        self.events = events
        self.cuda = types.SimpleNamespace(synchronize=lambda: None)
        self.autograd = types.SimpleNamespace(DeviceType=types.SimpleNamespace(CUDA="cuda"))

    def profile(self):
        prof = types.SimpleNamespace(start=lambda: None, stop=lambda: None)
        events = types.SimpleNamespace(events=lambda: [_Event(a, b, d) for a, b, d in self.events])
        prof.profiler = types.SimpleNamespace(kineto_results=events)
        return prof


@pytest.mark.parametrize("covered, raises", [(1.0, False), (0.5, True)])
def test_the_window_trace_reads_busy_time_and_refuses_a_lost_tail(monkeypatch, covered, raises):
    import time

    torch = _Torch([])
    wt = trace.WindowTrace(torch, "cuda")
    monkeypatch.setattr(wt, "_profile", torch.profile)
    wt.start()
    time.sleep(0.05)
    end = int(covered * (time.perf_counter() - wt._t0 + 0.01) * 1e9)
    torch.events = [(0, 10_000_000, "cuda"), (5_000_000, 15_000_000, "cuda"), (0, end, "cpu"),
                    (end - 1_000_000, end, "cuda")]
    if raises:
        with pytest.raises(RuntimeError, match="lost records"):
            wt.stop_and_read()
        return
    busy, ops, _ = wt.stop_and_read()
    assert ops == 3 and busy == pytest.approx(16e-3)


def test_a_split_metric_is_read_by_its_quantitys_reader():
    from portbench import harness

    assert harness.reader("metrics", "track_ms.kitti") is track_ms
    assert harness.reader("metrics", "device_ms_per_frame") is device_ms_per_frame


def test_spans_leave_out_the_profiled_stretch():
    f = [FrameRecord(0, 0, 0, 1, "tracked", spans={"track.dispatch": (10.0, 1), "track.result_read": (2.0, 1)}),
         FrameRecord(0, 1, 0, 1, "kf", spans={"track.dispatch": (12.0, 1), "kf.total": (50.0, 1), "obj.ba": (900.0, 1)}),
         FrameRecord(0, 2, 0, 1, "kf", spans={"track.dispatch": (99.0, 1), "kf.total": (99.0, 1)}, traced=True),
         FrameRecord(0, 3, 0, 1, "kf", spans={"track.dispatch": (8.0, 1), "track.rescue": (4.0, 1),
                                           "kf.total": (70.0, 1), "obj.ba": (1100.0, 1)}, made={"lines": np.zeros((2, 4))},
                     feed_ms=30.0)]
    run = _run(f)
    assert track_ms.read(run) == pytest.approx((12 + 12 + 12) / 3)
    assert keyframe_ms.read(run) == pytest.approx(60.0)
    assert object_ba_ms.read(run) == pytest.approx(1000.0)
    assert lines_ms.read(run) == pytest.approx(30.0)
    assert object_ba_ms.read(_run(f[:1])) is None


class _Driver:
    """Episodes of `n` frames of `ms` each, on the host's clock."""

    def __init__(self, n, ms):
        self.n, self.ms = n, ms

    def episode(self, index, pool, frames, after_frame=None, deadline=None):
        import time

        from portbench.harness import EpisodeRecord

        run = 0
        for f in range(self.n):
            time.sleep(self.ms / 1000)
            run += 1
            frames.append(FrameRecord(index, f, pool, self.ms, "tracked"))
            if deadline is not None and time.perf_counter() >= deadline:
                break
        return EpisodeRecord(index, pool, [], 0, frames_run=run, t_end=time.perf_counter())


def test_the_window_closes_with_the_first_frame_after_its_seconds():
    from portbench import harness

    frames, eps, window = harness.measure(_Driver(5, 20.0), [1, 0], 0.25)
    assert 0.25 <= window < 0.3 and len(frames) == 13
    assert [e.pool for e in eps] == [1, 0, 1] and eps[-1].frames_run == 3
    frames, eps, window = harness.measure(_Driver(5, 1.0), [1, 0], None)
    assert [e.pool for e in eps] == [1, 0] and len(frames) == 10


@pytest.mark.parametrize("iv, want", [
    ([(0, 10), (5, 15), (20, 30)], 25), ([(0, 10), (10, 20)], 20), ([(5, 6), (0, 10)], 10), ([], 0)])
def test_union_of_intervals(iv, want):
    assert device_idle_pct.union_s(iv) == pytest.approx(want * 1e-9)
    st = trace.Stretch(wall_s=1e-7, device=[("k", a, b) for a, b in iv])
    assert trace.busy_s(st) == pytest.approx(want * 1e-9)


def test_idle_share_of_the_stretch():
    st = trace.Stretch(wall_s=100e-9, device=[("k", 0, 10), ("k", 5, 15), ("m", 40, 50)])
    assert device_idle_pct.read(_run([], stretch=st)) == pytest.approx(75.0)
    assert device_idle_pct.read(_run([], stretch=None)) is None


def test_edt_roofline_counts_five_bytes_per_pixel():
    # two calls on (1, 480, 640) maps, 20 us of column pass and 30 us of row pass each
    px = 480 * 640
    dev = [("edt_column_pass(...)", 0, 20_000), ("edt_row_pass(...)", 20_000, 50_000),
           ("edt_column_pass(...)", 60_000, 80_000), ("edt_row_pass(...)", 80_000, 110_000),
           ("other", 0, 1_000_000)]
    st = trace.Stretch(wall_s=1.0, device=dev)
    want = 100.0 * (5 * 2 * px / 3.35e12) / 100e-6
    assert edt_roofline_pct.read(_run([], stretch=st, edt_pixels=[px, px])) == pytest.approx(want)
    assert edt_roofline_pct.read(_run([], stretch=st)) is None


def test_breakdown_labels_gaps_with_the_host_range():
    st = trace.Stretch(wall_s=1.0, device=[("a", 100, 200), ("b", 500, 600), ("a", 650, 700)],
                       host=[("lsd f1", 0, 300), ("track f1", 300, 800)])
    out = trace.breakdown(st)
    assert out["device_ops"][0] == ["a", pytest.approx(150e-9)]
    assert out["idle_gaps"][0] == ["track f1", pytest.approx(300e-9)]
    assert {g[0] for g in out["idle_gaps"]} == {"lsd f1", "track f1"}


def test_line_sets_match_within_the_tolerance():
    a = np.array([[0, 0, 10, 0], [5, 5, 20, 5]], dtype=float)
    assert line_err.unmatched(a, a + 0.04) == 0.0
    assert line_err.unmatched(a, a[:1]) == 0.5
    assert line_err.unmatched(a, np.zeros((0, 4))) == 1.0
    assert line_err.unmatched(np.zeros((0, 4)), a) == 0.0


def test_every_seed_plays_the_same_pool_in_its_own_order():
    from portbench import harness

    cell = types.SimpleNamespace(spec={"episodes": 4})
    orders = {tuple(harness.pool_order(cell, s)) for s in (0, 1, 2, 3, 2**31 + 7)}
    assert all(sorted(o) == [0, 1, 2, 3] for o in orders) and len(orders) > 1
    assert harness.pool_order(cell, 5) == harness.pool_order(cell, 5)


def test_motion_errors_read_degenerate_poses_as_wrong():
    from portbench.reference import truth

    Twc = [np.eye(4) for _ in range(4)]
    for i, T in enumerate(Twc):
        T[:3, 3] = [0.1 * i, 0.0, 0.0]
    assert truth.motion_errors(list(enumerate(Twc)), Twc) == pytest.approx([0.0, 0.0, 0.0], abs=1e-6)
    frozen = [(i, Twc[0]) for i in range(4)]
    assert truth.motion_errors(frozen, Twc) == [180.0, 180.0, 180.0]
    broken = [(0, Twc[0]), (1, np.zeros((4, 4))), (2, np.full((4, 4), np.nan)), (3, Twc[3])]
    errs = truth.motion_errors(broken, Twc)
    assert len(errs) == 3 and errs[1] == 180.0 and errs[2] == 180.0
    assert truth.motion_errors([(0, Twc[0]), (1, None), (2, None), (3, None)], Twc) is None


def test_motion_err_judges_a_cut_episode_from_its_initialization():
    from portbench.checks import motion_err
    from portbench.harness import EpisodeRecord

    truth_Twc = [np.eye(4) for _ in range(10)]
    for i, T in enumerate(truth_Twc):
        T[:3, 3] = [0.1 * i, 0.02 * i * i, 0.0]
    ep = types.SimpleNamespace(frames=[None] * 10, truth_Twc=truth_Twc)

    def reads(n, posed, init=3):
        """motion_err of one episode that ran `n` frames, initialized at
        `init` on the reference frame 0, with `posed` frames posed truly."""
        Twc = [(f, truth_Twc[f] if f in posed else None) for f in range(n) if f == 0 or f >= init]
        e = EpisodeRecord(0, 0, Twc, init, frames_run=n)
        return motion_err.read(types.SimpleNamespace(episodes=[e], eps=[ep], ep=ep))

    assert reads(10, {0, *range(3, 10)}) == pytest.approx(0.0, abs=1e-6)    # whole: judged as it was
    assert reads(4, {0, 3}) == 0.0                                         # cut at its initialization
    assert reads(5, {0, 3, 4}) == pytest.approx(0.0, abs=1e-6)             # one frame tracked after it
    assert reads(6, {0, 3, 4}) == float("inf")                             # the frame after that lost
    assert reads(8, {0, 3, 4, 5}) == float("inf")                          # half of them lost
    assert reads(5, set()) == 0.0                                          # cut before its first pose
    bent = EpisodeRecord(0, 0, [(0, truth_Twc[0]), (3, truth_Twc[3]), (4, truth_Twc[3]), (5, truth_Twc[5])], 3,
                         frames_run=6)
    assert motion_err.read(types.SimpleNamespace(episodes=[bent], eps=[ep], ep=ep)) > 90.0
