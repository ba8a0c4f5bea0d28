"""The tracker slice's gate: Gate A (tests/torch_parity_utils.py) through
the JAX package's MonocularTracker (its local-BA fold forced synchronous)
and the port's, as a user drives them: track() frame by frame, then the
trajectory. Discrete outcomes must agree; map size and accuracy within the
stated bounds."""

import numpy as np
import pytest
import torch
from torch_parity_utils import GATE_A_CONFIG, GATE_A_K, gate_a_sequence, sync_fold_jax_tracker

from cube_slam_tpu.slam.tracking import evaluate_ate_scaled as jax_ate
from cube_slam_tpu_torch.slam import system as tsys
from cube_slam_tpu_torch.slam.tracking import evaluate_ate_scaled
from cube_slam_tpu_torch.utils import profiler


def _outcome(trk, poses):
    traj = trk.trajectory
    tracked = [fid for fid, T in traj if T is not None]
    est = np.stack([np.linalg.inv(T) for _, T in traj if T is not None])
    tru = np.stack([poses[fid] for fid in tracked])
    final = [np.linalg.inv(T) for _, T in trk.final_trajectory() if T is not None]
    return dict(tracked=tracked, n_kf=int(trk.map.kf_valid.sum()), n_mp=int(trk.map.mp_valid.sum()),
                ate=evaluate_ate_scaled(est, tru), ate_final=evaluate_ate_scaled(np.stack(final), tru))


@pytest.fixture(scope="module")
def runs():
    frames, poses = gate_a_sequence()
    J = sync_fold_jax_tracker(GATE_A_CONFIG)
    for f in frames:
        J.track(f)
    P = tsys.MonocularTracker(GATE_A_K, (320, 240), tsys.TrackerConfig(**GATE_A_CONFIG), device="cpu")
    profiler.reset()
    profiler.enable()
    try:
        for f in frames:
            P.track(f)
    finally:
        profiler.disable()
    spans = profiler.aggregated()
    records = profiler.records()
    profiler.reset()
    return dict(jax=_outcome(J, poses), port=_outcome(P, poses), P=P, spans=spans, records=records, poses=poses)


def test_gate_a_port_agrees_with_jax(runs):
    """JAX: frames 6-13 tracked (initialized at 6), 5 keyframes, 421 map
    points, scaled ATE 0.0332 m (as tracked) / 0.0320 m (recomposed). The
    port: the same frames and keyframes, 423-424 points depending on the
    CPU thread count (bound: within 10%), ATE 0.0342 m / 0.0323 m (bound:
    within 0.01 m). Measured on the CPU."""
    j, p = runs["jax"], runs["port"]
    assert j["tracked"] == list(range(6, 14)), j
    assert p["tracked"] == j["tracked"]
    assert p["n_kf"] == j["n_kf"] == 5
    assert abs(p["n_mp"] - j["n_mp"]) <= 0.1 * j["n_mp"], (p["n_mp"], j["n_mp"])
    assert abs(p["ate"] - j["ate"]) <= 0.01, (p["ate"], j["ate"])
    assert abs(p["ate_final"] - j["ate_final"]) <= 0.01, (p["ate_final"], j["ate_final"])
    assert p["ate"] < 0.1


def test_gate_a_metrics_and_profiler(runs):
    """The frames' outcomes, read from the counters of their root spans, and
    the profiler spans of the run."""
    frames = [r for r in runs["records"] if r.name == "frame"]
    assert len(frames) == 14 and [r.frame for r in frames] == list(range(14))
    assert sum(r.counts["tracked"] for r in frames) == 8
    assert frames[-1].counts["keyframes"] == 5 and frames[-1].counts["state.OK"] == 1
    spans = runs["spans"]
    for name in ("track.dispatch", "track.result_read", "kf.total", "kf.ba_dispatch", "ba.fold"):
        assert name in spans, sorted(spans)
    assert spans["track.result_read"][4] == 7  # the 7 frames after initialization


def test_gate_a_frame_spans(runs):
    """Every span of the run lies under one of the 14 `frame` roots, inside
    it and carrying its frame id; kf.total and ba.fold are among them."""
    recs = runs["records"]
    by_id = {r.id: r for r in recs}

    def root(r):
        while r.parent is not None:
            r = by_id[r.parent]
        return r

    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["frame"] * 14
    for r in recs:
        top = root(r)
        assert r.frame == top.frame and top.start <= r.start <= r.end <= top.end
    names = {r.name for r in recs}
    assert {"kf.total", "kf.ba_fold", "ba.fold", "track.dispatch", "step.orb"} <= names, sorted(names)
    for r in recs:
        if r.name == "kf.ba_fold":
            assert by_id[r.parent].name == "kf.total"


def test_ate_helper_matches_jax(runs):
    est = np.stack(runs["poses"][:10])
    tru = est.copy()
    tru[:, :3, 3] = 1.7 * est[:, :3, 3] + 0.01
    assert evaluate_ate_scaled(est, tru) == jax_ate(est, tru)


@pytest.mark.parametrize("flag", ["pipeline", "enable_loop_closing"])
def test_unported_modes_raise(flag):
    """Both modes are ported. pipeline=True builds and starts with no frame
    in flight (tests/test_torch_pipeline.py holds the mode itself); the
    tracker builds with loop closing (the default, as in the JAX package)
    and starts with no loop closed. Without a device the default tracker
    asks for the card."""
    cfg = tsys.TrackerConfig(**dict(GATE_A_CONFIG, **{flag: True}))
    if flag == "pipeline":
        t = tsys.MonocularTracker(GATE_A_K, (320, 240), cfg, device="cpu")
        assert t.cfg.pipeline and t._pending is None and t.flush() is None and t.trajectory == []
    else:
        t = tsys.MonocularTracker(GATE_A_K, (320, 240), cfg, device="cpu")
        assert t.cfg.enable_loop_closing and t.loops_closed == 0 and t.loop_edges == []
        assert tsys.TrackerConfig().enable_loop_closing
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsys.MonocularTracker(GATE_A_K, (320, 240))


def test_tracker_config_matches_jax():
    """The same fields with the same defaults as the JAX TrackerConfig."""
    import dataclasses

    from cube_slam_tpu.slam.system import TrackerConfig as JaxConfig

    def fields(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert fields(tsys.TrackerConfig) == fields(JaxConfig)


def test_profiler_api_matches_jax():
    """span / aggregated / print_aggregated behave as the JAX package's
    profiler (tests/test_aux.py::test_profiler_aggregation)."""
    profiler.reset()
    profiler.enable()
    try:
        for _ in range(3):
            with profiler.span("a"):
                pass
        with profiler.span("b"):
            pass
        rows = profiler.aggregated()
    finally:
        profiler.disable()
        profiler.reset()
    assert rows["a"][4] == 3 and rows["b"][4] == 1
    assert all(r[1] <= r[2] <= r[3] and abs(r[0] - r[2] * r[4]) < 1e-9 for r in rows.values())
    with profiler.span("off"):  # disabled: no record, no open span
        pass
    assert profiler.aggregated() == {}
