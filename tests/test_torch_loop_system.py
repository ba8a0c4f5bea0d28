"""The loop path of cube_slam_tpu_torch's trackers against the JAX package on
the CPU: MonocularTracker._try_close_loop (detect -> Sim3 verify ->
essential-graph correction -> loop fusion -> global BA) on the constructed
drifted loop of tests/test_loop_system.py, ObjectSlamTracker's landmark
re-anchoring, tracker-level relocalization, and utils/serialization.

Tolerances: MAP_TOL as in test_torch_loop_closing.py (float32 device work,
float64 host work, ~1e-6 measured); associations, counts and loop edges are
equal; the serialized text is identical.
"""

import collections
import os
import types

import numpy as np
import pytest
import torch
from torch_parity_utils import (GATE_A_CONFIG, GATE_A_K, LOOP_CONFIG, LOOP_K, LOOP_N_KF, assert_close,
                                build_drifted_loop, gate_a_sequence, sync_fold_jax_tracker)

from cube_slam_tpu.slam import objects as jobj
from cube_slam_tpu.slam import system as jsys
from cube_slam_tpu.utils import serialization as jser
from cube_slam_tpu_torch.slam import objects as tobj
from cube_slam_tpu_torch.slam import system as tsys
from cube_slam_tpu_torch.utils import geometry as tgeo
from cube_slam_tpu_torch.utils import serialization as tser

MAP_TOL = 1e-4
K_LAST = LOOP_N_KF - 1


def _closed(global_ba):
    """Both trackers after _try_close_loop on the drifted loop."""
    cfg = dict(LOOP_CONFIG, loop_global_ba=global_ba)
    J = jsys.MonocularTracker(LOOP_K, (640, 480), jsys.TrackerConfig(**cfg))
    P = tsys.MonocularTracker(LOOP_K, (640, 480), tsys.TrackerConfig(**cfg), device="cpu")
    for tr in (J, P):
        true_tcw, est_tcw, mp_ids = build_drifted_loop(tr)
        tr.frame_id = LOOP_N_KF  # the RANSAC seed
        tr._try_close_loop(K_LAST, tr.map.covisibility_counts(K_LAST))
    return J, P, true_tcw, est_tcw, mp_ids


@pytest.mark.parametrize("global_ba", [True, False])
def test_try_close_loop_matches_jax(global_ba):
    """With and without the global BA, every array is JAX's. (The global BA
    over this map, whose single-view points leave their depths free, fails
    every Cholesky factor of its 6 LM steps: both packages reject them.)"""
    J, P, true_tcw, est_tcw, mp_ids = _closed(global_ba)
    assert P.loops_closed == J.loops_closed == 1
    assert P.loop_edges == J.loop_edges == [(0, K_LAST)]
    # the fused associations and observation counts are equal
    assert np.array_equal(P.map.kf_kp_mp, J.map.kf_kp_mp)
    assert np.array_equal(P.map.mp_nobs, J.map.mp_nobs)
    assert np.array_equal(P.map.mp_valid, J.map.mp_valid)
    revisit = set(P.map.kf_kp_mp[K_LAST][P.map.kf_kp_mp[K_LAST] >= 0].tolist())
    assert revisit & set(mp_ids[0].tolist()), "no loop-side point fused into the revisit keyframe"
    # poses and points after the correction (and the global BA)
    assert_close(P.map.kf_tcw, J.map.kf_tcw, MAP_TOL)
    live = P.map.mp_valid
    assert_close(P.map.mp_pos[live], J.map.mp_pos[live], MAP_TOL)
    assert_close(P.last_Tcw, P.map.kf_tcw[K_LAST], 0)
    assert np.array_equal(P.velocity, np.eye(4, dtype=np.float32))
    # final_trajectory() recomposes through the corrected keyframes
    fj, fp = dict(J.final_trajectory()), dict(P.final_trajectory())
    assert sorted(fp) == sorted(fj) == list(range(LOOP_N_KF))
    for i in range(LOOP_N_KF):
        assert_close(fp[i], fj[i], MAP_TOL)
        assert_close(fp[i], P.map.kf_tcw[i], 1e-4)
    # the loop closed (tests/test_loop_system.py's outcome)
    rel_true = true_tcw[0] @ np.linalg.inv(true_tcw[K_LAST])

    def gap(T_last, T_first):
        g = rel_true @ T_last.astype(np.float64) @ np.linalg.inv(T_first.astype(np.float64))
        return float(np.linalg.norm(tgeo.se3_log(torch.tensor(g.astype(np.float32))).numpy()))

    assert gap(P.map.kf_tcw[K_LAST], P.map.kf_tcw[0]) < 0.05 * gap(est_tcw[K_LAST], est_tcw[0])


def test_loop_state_resets():
    P = tsys.MonocularTracker(LOOP_K, (640, 480), tsys.TrackerConfig(**LOOP_CONFIG), device="cpu")
    build_drifted_loop(P)
    P.frame_id = LOOP_N_KF
    P._try_close_loop(K_LAST, P.map.covisibility_counts(K_LAST))
    assert P.loops_closed == 1 and P.loop_edges
    P.reset()
    # JAX's reset clears the loop edges and keeps the closure count
    assert P.loop_edges == [] and P.loops_closed == 1 and not P.map.kf_valid.any()


def _object_state(pkg):
    """Three landmarks: one free, one fix_scale, one whose measurements lie
    on keyframes outside the correction; measurement rings in `meas`."""
    obj = jobj if pkg == "jax" else tobj
    r = np.random.default_rng(7)
    store = obj.ObjectStore(max_obj=6)
    meas = {}
    for o, kfs, fix in ((0, [1, 3, 5], False), (2, [4, 2], True), (3, [9], False)):
        store.valid[o] = True
        T = tgeo.se3_exp(torch.tensor(r.normal(0, 0.3, 6), dtype=torch.float32)).numpy()
        T[:3, 3] += [0.0, 3.0, 0.5]
        store.pose[o] = T
        store.scale[o] = r.uniform(0.3, 0.7, 3).astype(np.float32)
        store.fix_scale[o] = fix
        meas[o] = collections.deque(
            obj.Detection(kf_id=k, local_pose=np.eye(4, dtype=np.float32), scale=np.ones(3, np.float32),
                          bbox=np.zeros(4, np.float32), quality=1.0, owned_kps=np.zeros(0, np.int64))
            for k in kfs)
    return types.SimpleNamespace(objects=types.SimpleNamespace(store=store, meas=meas))


def test_object_on_loop_corrected_matches_jax():
    """Each landmark rides the correction of its latest measured keyframe
    (5 and 2 here; landmark 3's keyframe 9 is not corrected); the free one's
    scale is divided by the Sim3 scale, the fix_scale one keeps its extent."""
    r = np.random.default_rng(8)
    corrections = {}
    for k in range(6):
        old = tgeo.se3_exp(torch.tensor(r.normal(0, 0.2, 6), dtype=torch.float32)).numpy().astype(np.float64)
        new = tgeo.se3_exp(torch.tensor(r.normal(0, 0.05, 6), dtype=torch.float32)).numpy().astype(np.float64) @ old
        corrections[k] = (new, old, float(r.uniform(0.7, 1.3)))
    J, P = _object_state("jax"), _object_state("port")
    before = (P.objects.store.pose.copy(), P.objects.store.scale.copy())
    jsys.ObjectSlamTracker._on_loop_corrected(J, corrections)
    tsys.ObjectSlamTracker._on_loop_corrected(P, corrections)
    sj, sp = J.objects.store, P.objects.store
    assert np.array_equal(sp.pose, sj.pose) and np.array_equal(sp.scale, sj.scale)
    assert not np.allclose(sp.pose[0], before[0][0]) and not np.allclose(sp.pose[2], before[0][2])
    assert_close(sp.scale[0], before[1][0] / corrections[5][2], 1e-6)
    assert np.array_equal(sp.scale[2], before[1][2])  # fix_scale keeps its extent
    assert np.array_equal(sp.pose[3], before[0][3]) and np.array_equal(sp.scale[3], before[1][3])


def test_relocalization_via_keyframe_database():
    """tests/test_reset.py:110's scenario through both trackers (local-BA
    fold synchronous) on Gate A's frames, where both initialize (that
    test's slower path starves the initializer in both packages, ROADMAP
    queue 3): a keyframe every 2 frames builds a map of > 5 keyframes, two
    noise frames lose tracking without a reset, and a revisited view
    relocalizes through the keyframe database in both packages, within 0.1
    of the pose tracked there before. (The packages' maps differ in their
    free monocular scale, so their poses are not compared in metres.)"""
    cfg = dict(GATE_A_CONFIG, new_kf_max_frames=2)
    frames, _ = gate_a_sequence()
    noise = np.random.default_rng(1).uniform(0, 255, size=frames[0].shape).astype(np.uint8)
    J = sync_fold_jax_tracker(cfg)
    P = tsys.MonocularTracker(GATE_A_K, (320, 240), tsys.TrackerConfig(**cfg), device="cpu")
    for tr in (J, P):
        est = {}
        for i, f in enumerate(frames):
            T = tr.track(f)
            if T is not None:
                est[i] = T.copy()
        assert tr.state == "OK" and len(tr.map.kf_ids()) > 5
        for _ in range(2):
            tr.track(noise)
        assert tr.state == "LOST" and tr.map.kf_valid.any()
        T = tr.track(frames[10])
        assert T is not None and tr.state == "OK"
        assert np.linalg.norm(np.linalg.inv(T)[:3, 3] - np.linalg.inv(est[10])[:3, 3]) < 0.1
    assert len(P.map.kf_ids()) == len(J.map.kf_ids())
    assert [f for f, T in P.trajectory if T is not None] == [f for f, T in J.trajectory if T is not None]


def _trajectory():
    r = np.random.default_rng(9)
    poses = [tgeo.se3_exp(torch.tensor(r.normal(0, 0.5, 6), dtype=torch.float32)).numpy() for _ in range(6)]
    poses[2] = None
    return np.arange(6, dtype=np.float64) * 0.033 + 1305031102.175, poses


def _store(pkg):
    store = (jobj if pkg == "jax" else tobj).ObjectStore(max_obj=4)
    r = np.random.default_rng(10)
    for o in (0, 2):
        store.valid[o] = True
        store.pose[o] = tgeo.se3_exp(torch.tensor(r.normal(0, 0.5, 6), dtype=torch.float32)).numpy()
        store.scale[o] = r.uniform(0.2, 1.0, 3)
        store.n_obs[o] = 3 + o
        store.fix_scale[o] = o == 2
    return store


def test_serialization_text_matches_jax(tmp_path):
    stamps, poses = _trajectory()
    for name, write in (("tum", lambda m, p: m.save_trajectory_tum(p, stamps, poses)),
                        ("kitti", lambda m, p: m.save_trajectory_kitti(p, poses)),
                        ("cuboids", lambda m, p: m.save_cuboids_txt(p, _store("jax" if m is jser else "port")))):
        pj, pt = str(tmp_path / f"{name}_jax.txt"), str(tmp_path / f"{name}_port.txt")
        write(jser, pj)
        write(tser, pt)
        text = open(pt).read()
        assert text == open(pj).read() and text
    rows = np.loadtxt(str(tmp_path / "tum_port.txt"))
    assert rows.shape == (5, 8)
    assert_close(rows[-1, 1:4], np.linalg.inv(poses[-1].astype(np.float64))[:3, 3], 1e-6)


def test_save_map_load_map_round_trip_across_packages(tmp_path):
    """save_map -> load_map round-trips every field, and a map saved by one
    package loads in the other."""
    P = tsys.MonocularTracker(LOOP_K, (640, 480), tsys.TrackerConfig(**LOOP_CONFIG), device="cpu")
    build_drifted_loop(P)
    P.map.mp_best_obj[:5] = 1
    store = _store("port")
    path = str(tmp_path / "map_port.npz")
    tser.save_map(path, P.map, store)
    for load in (tser.load_map, jser.load_map):
        m, st = load(path)
        for f in tser._MAP_FIELDS:
            assert np.array_equal(getattr(m, f), getattr(P.map, f)), f
            assert getattr(m, f).dtype == getattr(P.map, f).dtype, f
        for f in tser._OBJ_FIELDS:
            assert np.array_equal(getattr(st, f), getattr(store, f)), f
    path_j = str(tmp_path / "map_jax.npz")
    jser.save_map(path_j, m)  # the JAX package's map, without objects
    m2, st2 = tser.load_map(path_j)
    assert isinstance(m2, type(P.map)) and st2 is None
    assert all(np.array_equal(getattr(m2, f), getattr(P.map, f)) for f in tser._MAP_FIELDS)
    assert tser._MAP_FIELDS == jser._MAP_FIELDS and tser._OBJ_FIELDS == jser._OBJ_FIELDS
    assert os.path.getsize(path) > 0
