"""The port's span store (cube_slam_tpu_torch/utils/profiler.py) on the CPU:
parents, frame ids, times, self time, counters, the views and the disabled
path. Gate A's frames as spans are checked in tests/test_torch_tracker.py,
beside the run they read."""

import json
import time
import tracemalloc

import pytest

from cube_slam_tpu_torch.utils import profiler


@pytest.fixture
def prof():
    profiler.disable()
    profiler.drain()
    profiler.enable()
    yield profiler
    profiler.disable()
    profiler.drain()


def _by_name(spans):
    return {s.name: s for s in spans}


def test_parents_and_nesting(prof):
    with prof.span("a"):
        with prof.span("b"):
            with prof.span("c"):
                pass
        with prof.span("d"):
            pass
    with prof.span("e"):
        pass
    recs = prof.records()
    assert [s.name for s in recs] == ["a", "b", "c", "d", "e"]  # the order they opened
    s = _by_name(recs)
    assert s["a"].parent is None and s["e"].parent is None
    assert s["b"].parent == s["a"].id and s["d"].parent == s["a"].id and s["c"].parent == s["b"].id


def test_frame_id(prof):
    with prof.span("feed"):
        pass
    with prof.frame(7):
        with prof.frame(8):  # a track() inside a track(): no second root
            with prof.span("inner"):
                pass
    with prof.span("after"):
        pass
    s = _by_name(prof.records())
    assert [r.name for r in prof.records()].count("frame") == 1
    assert s["frame"].frame == 7 and s["inner"].frame == 7 and s["inner"].parent == s["frame"].id
    assert s["feed"].frame is None and s["after"].frame is None


def test_start_end_and_children_inside_parent(prof):
    with prof.span("outer"):
        for _ in range(3):
            with prof.span("child"):
                time.sleep(0.001)
    recs = prof.records()
    outer = recs[0]
    for r in recs:
        assert r.start <= r.end
    for r in recs[1:]:
        assert outer.start <= r.start <= r.end <= outer.end
    assert all(a.end <= b.start for a, b in zip(recs[1:], recs[2:]))


def test_self_time():
    def mk(i, name, parent, start, end):
        s = profiler.Span(name)
        s.id, s.parent, s.start, s.end = i, parent, start, end
        return s

    spans = [mk(0, "a", None, 0, 100), mk(1, "b", 0, 10, 40), mk(2, "c", 1, 15, 25), mk(3, "d", 0, 50, 60)]
    assert profiler.self_ns(spans) == {0: 60, 1: 20, 2: 10, 3: 10}


def test_counters_land_on_the_innermost_span(prof):
    prof.count("nowhere")  # no span open: dropped
    with prof.span("outer"):
        prof.count("n", 2)
        with prof.span("inner"):
            prof.count("n")
            prof.count("m", 5)
        prof.count("n")
    s = _by_name(prof.records())
    assert s["outer"].counts == {"n": 3}
    assert s["inner"].counts == {"n": 1, "m": 5}
    assert prof.counters() == {("outer", "n"): 3, ("inner", "n"): 1, ("inner", "m"): 5}


def test_counters_of_one_name_on_two_spans_stay_apart(prof, capsys):
    """`keyframes` on `frame` (the map's) and on `obj.ba` (the window's) are
    two counters: neither the totals nor the printed view add them up."""
    for n_map in (5, 6):
        with prof.frame(n_map):
            prof.count("keyframes", n_map)
            with prof.span("obj.ba"):
                prof.count("keyframes", 3)
                prof.count("points", 40)
            with prof.span("kf.ba_dispatch"):
                prof.count("points", 100)
    assert prof.counters() == {("frame", "keyframes"): 11, ("obj.ba", "keyframes"): 6,
                               ("obj.ba", "points"): 80, ("kf.ba_dispatch", "points"): 200}
    prof.print_aggregated()
    out = capsys.readouterr().out
    for line in ("[counter] frame/keyframes 11", "[counter] obj.ba/keyframes 6", "[counter] obj.ba/points 80",
                 "[counter] kf.ba_dispatch/points 200"):
        assert line in out.splitlines()


def test_disabled_records_nothing_and_allocates_nothing():
    profiler.disable()
    profiler.drain()

    def calls():
        for i in range(2000):
            with profiler.frame(i):
                with profiler.span("x"):
                    profiler.count("sync")

    calls()  # warm
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        calls()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename.endswith("profiler.py") and d.size_diff > 0]
    assert grown == []
    assert profiler.records() == [] and profiler.drain() == [] and profiler.aggregated() == {}


def test_aggregated_is_the_sum_of_the_records(prof):
    for i in range(4):
        with prof.span("p"):
            with prof.span("q" if i % 2 else "r"):
                pass
    rows = prof.aggregated()
    for name in ("p", "q", "r"):
        ms = [(s.end - s.start) * 1e-6 for s in prof.records() if s.name == name]
        total, mn, avg, mx, n = rows[name]
        assert n == len(ms) and total == pytest.approx(sum(ms)) and (mn, mx) == (min(ms), max(ms))
        assert avg == pytest.approx(sum(ms) / len(ms))


def test_reset_starts_a_view_and_the_log_is_kept_until_drained(prof, tmp_path):
    with prof.span("old"):
        pass
    prof.reset()
    assert prof.records() == [] and prof.aggregated() == {} and prof.counters() == {}
    with prof.span("new"):
        prof.count("k", 3)
    assert [s.name for s in prof.records()] == ["new"]
    prof.reset()
    prof.reset()
    assert prof.records() == []
    path = tmp_path / "spans.jsonl"
    prof.dump_jsonl(str(path))
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["name"] for r in rows] == ["old", "new"]  # every record since the last drain
    assert set(rows[1]) == {"id", "name", "parent", "frame", "start_ns", "end_ns", "counts"}
    assert rows[1]["counts"] == {"k": 3} and rows[1]["start_ns"] <= rows[1]["end_ns"]
    assert [s.name for s in prof.drain()] == ["old", "new"]
    assert prof.drain() == []
    with prof.span("x"):
        pass
    assert [s.name for s in prof.records()] == ["x"]
    assert [s.name for s in prof.drain()] == ["x"] and prof.records() == []


def test_spans_close_when_the_body_raises(prof):
    with pytest.raises(ValueError):
        with prof.frame(3):
            with prof.span("boom"):
                raise ValueError
    with prof.span("next"):
        pass
    s = _by_name(prof.records())
    assert s["boom"].end is not None and s["frame"].end is not None
    assert s["next"].parent is None and s["next"].frame is None


def test_no_sync_counted_without_a_card(prof):
    """Without CUDA there is nothing to synchronize: the hook stays off and
    a read-back counts nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card's count is tests/test_torch_cuda.py::test_sync_counter_counts_one_per_read_back")
    with prof.span("read"):
        torch.ones(3).cpu().numpy()
        torch.ones(3).sum().item()
    assert prof.records()[0].counts is None
