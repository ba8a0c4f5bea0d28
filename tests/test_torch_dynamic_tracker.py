"""The dynamic trackers of cube_slam_tpu_torch (slam/dynamic.py:
DynamicRgbdTracker; slam/kitti.py: KittiMonoTracker(dynamic=True) and
run_kitti_sequence(dynamic=True)) against the JAX package on the CPU.

The gates are tests/test_dynamic_tracker.py's RGBD scene and
tests/test_kitti_dynamic.py's monocular one (chip_smoke.dynamic_gate_scene:
the room box driving along world +x at 0.15 m per frame, 12 frames
320x240, 2 cm measurement noise), every tracker's local-BA fold forced
synchronous. Like the KITTI gates, they are chaotic on rounding in JAX
itself: the whole runs are held to the radius of JAX's own spread under
1-ulp perturbations (chip_smoke.DYNAMIC_GATE_BOUNDS, measured by
tools/kitti_gate_spread.py, which phase 13C holds card against CPU to),
and each keyframe step from JAX's carried state to the radius of JAX's own
step spread (KF_STEP_*)."""

import copy

import numpy as np
import pytest
import torch_parity_utils as tpu

import cube_slam_tpu.slam as jslam
import cube_slam_tpu.slam.dynamic  # noqa: F401
import cube_slam_tpu.slam.kitti  # noqa: F401
import cube_slam_tpu.slam.system  # noqa: F401
from cube_slam_tpu_torch.slam import dynamic as tdyn
from cube_slam_tpu_torch.slam import state as tstate

cs = tpu.cs
JAX = (jslam.dynamic, jslam.kitti, jslam.system)
FIELDS = ("xy", "level", "angle", "desc", "valid")

# One keyframe step (the static keyframe step with its local BA, then the
# manager's snapshot and dynamic BA) from JAX's state: the radius of JAX's
# own step under 16 1-ulp perturbations of the map points, keyframe
# translations and the chains' per-keyframe translations and velocities,
# over the keyframe steps of both gates (tools/kitti_gate_spread.py --gate
# dynamic-rgbd / dynamic-kitti --kf-steps): keyframe pose entries 0.0936,
# map points moved (m) in the median 0.137 and at the 90th percentile 1.59
# (their largest move, 24.4 m, is an ill-conditioned monocular point), map
# points alive 2 apart, the object's per-keyframe pose entries 0.0564, its
# speed 0.0450 m per frame. The port measured 0.0935 (the mono gate's frame
# 4, where JAX's own step spreads 0.0936), 0.129, 0.260, 0, 0.0395 and
# 1.46e-3. The steering angle is its dynamic BA's, held to that BA's step
# radius (tests/test_torch_dynamic.py STEP_STEER, 0.054): the port's step
# moved it 0.0414 on the RGBD gate's frame 9, where JAX's own keyframe
# step spreads it 0.0279 and its speed 0.045.
KF_STEP_TCW, KF_STEP_MP_MEDIAN, KF_STEP_MP_P90, KF_STEP_MP_ALIVE = 0.094, 0.137, 1.59, 2
KF_STEP_OBJ, KF_STEP_SPEED, KF_STEP_STEER = 0.0565, 0.045, 0.054


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs of the three gate paths."""
    tmp = str(tmp_path_factory.mktemp("dyn"))
    out = {}
    for name in ("rgbd", "kitti", "kitti-entry"):
        out[name] = (cs.dynamic_gate_run(name, None, tmp, JAX), cs.dynamic_gate_run(name, "cpu", tmp))
    return out


@pytest.mark.parametrize("name", ["rgbd", "kitti", "kitti-entry"])
def test_dynamic_gate_matches_jax(runs, name):
    """The gate from scratch through both packages: the same tracked
    frames, and the keyframe count, camera centres and rotations, the
    object's per-keyframe positions, speed and steering angle within the
    radius of JAX's own 1-ulp spread (chip_smoke.DYNAMIC_GATE_BOUNDS). Both
    track every frame and keep the moving box: a per-keyframe pose on at
    least three keyframes and a velocity history."""
    j, p = runs[name]
    bound = cs.DYNAMIC_GATE_BOUNDS[name]
    assert p["tracked"] == j["tracked"] == list(range(cs.DYNAMIC_GATE_FRAMES))
    for o in (j["obj"], p["obj"]):
        assert o is not None and o["n_kf"] >= 3 and o["history"] >= 1
    gaps = cs.dynamic_gaps(p, j)
    for k, v in gaps.items():
        assert bound[k] is None or v <= bound[k], (k, v, bound[k], gaps)


def test_entry_point_writes_the_dynamic_files(runs):
    """run_kitti_sequence(dynamic=True, output_prefix) writes the JAX
    package's files: the same rows of the TUM and KITTI trajectories (the
    tracked frames), no static cuboid, and per-keyframe dynamic rows and
    velocity rows for tracklet 7 on the same keyframe frames."""
    j, p = (r["files"] for r in runs["kitti-entry"])
    for ext in ("tum", "kitti"):
        assert len(p[ext].splitlines()) == len(j[ext].splitlines()) == cs.DYNAMIC_GATE_FRAMES
    assert p["cuboids"] == j["cuboids"] == ""
    dj = np.loadtxt(j["cuboids_dynamic"].splitlines(), ndmin=2)
    dp = np.loadtxt(p["cuboids_dynamic"].splitlines(), ndmin=2)
    assert dp.shape[1] == 6 and (dp[:, 0] == cs.DYNAMIC_GATE_TID).all() and dp.shape[0] >= 3
    assert np.array_equal(dp[:, :2], dj[:, :2])
    vj = np.loadtxt(j["cuboids_velocity"].splitlines(), ndmin=2)
    vp = np.loadtxt(p["cuboids_velocity"].splitlines(), ndmin=2)
    assert vp.shape == vj.shape and vp.shape[1] == 4


def _state(t):
    return (t.map.kf_tcw.copy(), t.map.mp_pos.copy(), t.map.mp_valid.copy(), t.map.kf_valid.copy(),
            {tid: ({k: v.copy() for k, v in ch.kf_pose.items()}, ch.velocity.copy())
             for tid, ch in t.dynamic.chains.items()})


def _kf_steps(name):
    """At each keyframe of JAX's run of the gate, the port carried from
    JAX's state takes the same keyframe step; (JAX's state after, the
    port's) per step."""
    g = tpu.dynamic_gate()
    steps = []
    trk = []

    def hooked(base):
        class Hooked(base):
            def _create_keyframe(self, feats, fid=None):
                J = trk[0]
                h = {k: getattr(feats, k).copy() for k in FIELDS}
                port = tpu.carry_tracker(J) if name == "rgbd" else tpu.carry_kitti_tracker(J)
                impl = port._impl if name == "rgbd" else port
                impl.__class__ = tpu.sync_fold(type(impl))
                impl._create_keyframe(tstate.FrameFeatures(**h, mp=feats.mp.copy()), fid=fid)
                super()._create_keyframe(feats, fid=fid)
                steps.append((fid, _state(J), _state(port)))
        return Hooked

    if name == "rgbd":
        J = tpu.dynamic_rgbd_tracker(jslam.dynamic, g)
        J._impl.__class__ = hooked(type(J._impl))
        inputs = list(zip(g["frames"], g["depths"], tpu.dynamic_gate_dets(g, jslam.dynamic.DynamicDetection)))
    else:
        J = tpu.dynamic_kitti_tracker(jslam.kitti, g)
        J.__class__ = hooked(type(J))
        inputs = [(f,) for f in g["frames"]]
    trk.append(J)
    for a in inputs:
        J.track(*a)
    return steps


@pytest.fixture(scope="module")
def kf_steps():
    return {name: _kf_steps(name) for name in ("rgbd", "kitti")}


@pytest.mark.parametrize("name", ["rgbd", "kitti"])
def test_keyframe_steps_from_carried_state(kf_steps, name):
    """Each keyframe step of the gate from JAX's carried state: the same
    keyframes, the same chains with per-keyframe poses on the same
    keyframes; map points alive, keyframe poses, map points (median and
    90th percentile of their moves), the object's per-keyframe poses, speed
    and steering angle within the KF_STEP_* radii of JAX's own step
    spread."""
    steps = kf_steps[name]
    assert len(steps) >= 4
    for fid, (jt, jm, jv, jk, jc), (pt, pm, pv, pk, pc) in steps:
        assert np.array_equal(jk, pk) and int((jv != pv).sum()) <= KF_STEP_MP_ALIVE, fid
        assert np.abs(pt - jt).max() <= KF_STEP_TCW, (fid, np.abs(pt - jt).max())
        moved = np.abs(pm - jm)[jv & pv].max(axis=1)
        assert np.median(moved) <= KF_STEP_MP_MEDIAN and np.percentile(moved, 90) <= KF_STEP_MP_P90, fid
        assert set(jc) == set(pc)
        for tid in jc:
            assert set(jc[tid][0]) == set(pc[tid][0])
            for k in jc[tid][0]:
                assert np.abs(jc[tid][0][k] - pc[tid][0][k]).max() <= KF_STEP_OBJ, (fid, k)
            assert abs(jc[tid][1][0] - pc[tid][1][0]) <= KF_STEP_SPEED
            assert abs(jc[tid][1][1] - pc[tid][1][1]) <= KF_STEP_STEER


def test_copy_of_a_jax_state_is_independent():
    """carry_tracker builds a port DynamicRgbdTracker whose manager and
    inner tracker are its own: a step of the carried tracker leaves the JAX
    tracker it came from unchanged."""
    g = tpu.dynamic_gate()
    J = tpu.dynamic_rgbd_tracker(jslam.dynamic, g)
    dets = tpu.dynamic_gate_dets(g, jslam.dynamic.DynamicDetection)
    for i in range(4):
        J.track(g["frames"][i], g["depths"][i], dets[i])
    J._apply_pending_map()
    before = copy.deepcopy((J.map.kf_tcw, J.map.mp_pos, {t: dict(c.kf_pose) for t, c in J.dynamic.chains.items()},
                            {t: c.xy.copy() for t, c in J.dynamic.chains.items()}))
    P = tpu.carry_tracker(J)
    P._impl.__class__ = tpu.sync_fold(type(P._impl))
    assert P.dynamic is not J.dynamic and P._impl.map is not J.map
    tdets = tpu.dynamic_gate_dets(g, tdyn.DynamicDetection)
    for i in range(4, 7):
        P.track(g["frames"][i], g["depths"][i], tdets[i])
    assert np.array_equal(J.map.kf_tcw, before[0]) and np.array_equal(J.map.mp_pos, before[1])
    for t, c in J.dynamic.chains.items():
        assert np.array_equal(c.xy, before[3][t])
        assert set(c.kf_pose) == set(before[2][t])
    assert P.frame_id == 6 and P.state == "OK"
