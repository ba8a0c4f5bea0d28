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
from cube_slam_tpu_torch.utils import metrics, profiler


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
    P.metrics = metrics.MetricsRecorder()
    profiler.reset()
    profiler.enable()
    try:
        for f in frames:
            P.track(f)
    finally:
        profiler.disable()
    spans = profiler.aggregated()
    profiler.reset()
    return dict(jax=_outcome(J, poses), port=_outcome(P, poses), P=P, spans=spans, poses=poses)


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
    """The per-frame metrics recorder and the profiler spans of the run."""
    rec = runs["P"].metrics
    assert len(rec.records) == 14
    s = rec.summary()
    assert s["frames"] == 14 and s["tracked_frac"] == 8 / 14 and s["final_keyframes"] == 5
    spans = runs["spans"]
    for name in ("track.dispatch", "track.result_read", "kf.total", "kf.ba_dispatch", "ba.fold"):
        assert name in spans, sorted(spans)
    assert spans["track.result_read"][4] == 7  # the 7 frames after initialization


def test_ate_helper_matches_jax(runs):
    est = np.stack(runs["poses"][:10])
    tru = est.copy()
    tru[:, :3, 3] = 1.7 * est[:, :3, 3] + 0.01
    assert evaluate_ate_scaled(est, tru) == jax_ate(est, tru)


@pytest.mark.parametrize("flag", ["pipeline", "enable_loop_closing"])
def test_unported_modes_raise(flag):
    """pipeline=True is still refused; loop closing is ported: the tracker
    builds with it (the default, as in the JAX package) and starts with no
    loop closed. Without a device the default tracker asks for the card."""
    cfg = tsys.TrackerConfig(**dict(GATE_A_CONFIG, **{flag: True}))
    if flag == "pipeline":
        with pytest.raises(NotImplementedError):
            tsys.MonocularTracker(GATE_A_K, (320, 240), cfg, device="cpu")
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
    """tictoc / span / aggregated / print_aggregated behave as the JAX
    package's profiler (tests/test_aux.py::test_profiler_aggregation)."""
    import torch

    profiler.reset()
    profiler.enable()
    try:
        for _ in range(3):
            profiler.tictoc("a")
            profiler.tictoc("a", sync_value=torch.zeros(2))
        with profiler.span("b", sync_value=[torch.ones(1)]):
            pass
        with profiler.trace("c"):
            pass
        rows = profiler.aggregated()
    finally:
        profiler.disable()
        profiler.reset()
    assert rows["a"][4] == 3 and rows["b"][4] == 1 and "c" not in rows
    profiler.tictoc("off")  # disabled: no record, no open span
    assert profiler.aggregated() == {}
