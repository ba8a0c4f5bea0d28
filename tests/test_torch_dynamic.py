"""slam/dynamic.py of cube_slam_tpu_torch (DynamicObjectManager,
static_anchor_edges, track_dynamic_object) and the dynamic files of
utils/serialization.save_cuboids_txt against the JAX package on the CPU.

The manager is held step by step: the JAX package's DynamicRgbdTracker and
KittiMonoTracker(dynamic=True) run the two dynamic gates (chip_smoke.py's
dynamic_gate_scene: the moving box of tests/test_dynamic_tracker.py and
tests/test_kitti_dynamic.py, 12 frames 320x240), and before each of their
manager's steps (advance, on_keyframe, run_dynamic_ba) its state and the
map are carried into a port manager
(torch_parity_utils.carry_dynamic_manager), which takes the same step on
the same inputs. The host bookkeeping is numpy in both packages; KLT, the
triangulation and the dynamic BA are torch against XLA, so their outputs
are held to the tolerances of tests/test_torch_klt.py and
tests/test_torch_dynamic_ba.py."""

import copy
import os

import numpy as np
import pytest
import torch
import torch_parity_utils as tpu

from cube_slam_tpu.slam import dynamic as jdyn
from cube_slam_tpu.slam import kitti as jk
from cube_slam_tpu.utils import serialization as jser
from cube_slam_tpu_torch.slam import dynamic as tdyn
from cube_slam_tpu_torch.slam import state as tstate
from cube_slam_tpu_torch.utils import serialization as tser

# KLT tracks (pixels; tests/test_torch_klt.py's bound)
TRACK_TOL = tpu.cs.KLT_TRACK_TOL
# object coordinates from the port's triangulation (m; a closed-form 3x3
# solve in float32 of the same projection matrices; measured <= 2.4e-7)
LOCAL_TOL = 1e-4
# the dynamic BA from the same inputs (tests/test_torch_dynamic_ba.py's
# SOLVE_TOL): per-frame object pose entries, velocity entries, points
BA_TOL = tpu.cs.DYNAMIC_BA_TOL
# One run_dynamic_ba from the same carried state: the radius of JAX's own
# step spread, the largest gap of its step under 24 1-ulp perturbations of
# the chains' per-keyframe translations, velocities and the keyframe
# translations from its unperturbed step, over the keyframe steps of both
# gates (tools/kitti_gate_spread.py --gate dynamic-rgbd / dynamic-kitti
# --steps): window camera entries 3.64e-5, object pose entries 8.07e-3,
# speed 1.46e-3, steering angle 0.0537 rad, final cost 1.89e-6 relative.
# The port measured 1.2e-5, 5.96e-3, 1.39e-3, 0.023 and 1.22e-6. The
# steering angle is flat in the cost on a straight drive: on the mono
# gate's frame-9 step the port's solve ends at JAX's cost exactly with its
# steering 0.023 rad from JAX's (JAX's own spread there: 0.0055; on the
# RGBD gate it reaches 0.0537).
STEP_CAM, STEP_POSE, STEP_SPEED, STEP_STEER, STEP_COST = 3.7e-5, 8.1e-3, 1.5e-3, 0.054, 1.9e-6
# One run_dynamic_ba with the point edges on (the two-stage solve) from the
# RGBD gate's final state, at point-edge capacities 1024, 40 and 20: the
# radius of JAX's own spread under 32 1-ulp perturbations, over the three
# capacities (tools/kitti_gate_spread.py --gate dynamic-rgbd --two-stage):
# camera entries 1.44e-4, the object's points in the world 0.590 m, its
# motion 0.116 m, speed 5.17e-3 and steering 0.0144 rad. The chi-square
# pruning between the solves is a discrete decision: with 40 or 1,024
# edges JAX's own points move 0.40-0.59 m. The port measured 6.5e-5,
# 0.441 m (at 40; 2e-5 at 20), 0.0751 m, 4.26e-3 and 1.66e-3.
TWO_STAGE_CAM, TWO_STAGE_WORLD, TWO_STAGE_MOTION, TWO_STAGE_SPEED, TWO_STAGE_STEER = 1.45e-4, 0.591, 0.117, 5.2e-3, 0.0144


def _det(d):
    return tdyn.DynamicDetection(**{k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in vars(d).items()})


def _chains(mgr):
    return {tid: dict(xy=ch.xy.copy(), alive=ch.alive.copy(), local=ch.local.copy(), has_local=ch.has_local.copy(),
                      spawn_kf=ch.spawn_kf.copy(), kf_pose={k: v.copy() for k, v in ch.kf_pose.items()},
                      kf_obs={k: (a.copy(), b.copy()) for k, (a, b) in ch.kf_obs.items()},
                      kf_stamp=dict(ch.kf_stamp), kf_frame=dict(ch.kf_frame),
                      kf_bbox={k: v.copy() for k, v in ch.kf_bbox.items()}, velocity=ch.velocity.copy(),
                      history=[(k, v.copy()) for k, v in ch.velocity_history])
            for tid, ch in mgr.chains.items()}


class _Costs:
    """The final cost of each dynamic_object_ba call of either package while
    a gate runs (both modules' name wrapped, restored on exit)."""

    def __init__(self):
        self.last = {}

    def __enter__(self):
        self.orig = (jdyn.dynamic_object_ba, tdyn.dynamic_object_ba)
        for mod, key, fn in ((jdyn, "jax", self.orig[0]), (tdyn, "port", self.orig[1])):
            def wrapped(*a, fn=fn, key=key, **k):
                out = fn(*a, **k)
                self.last[key] = float(out[4])
                return out
            mod.dynamic_object_ba = wrapped
        return self

    def __exit__(self, *exc):
        jdyn.dynamic_object_ba, tdyn.dynamic_object_ba = self.orig


def _recording(steps, costs):
    """A JAX DynamicObjectManager whose every step is also taken by a port
    manager carried from its state (on a copy of its map); `steps` collects
    (kind, JAX's result, the port's result) after each, a dynamic BA's with
    its final cost."""

    class Recording(jdyn.DynamicObjectManager):
        def advance(self, gray, dets):
            port = tpu.carry_dynamic_manager(self)
            port.advance(gray, [_det(d) for d in dets or []])
            super().advance(gray, dets)
            steps.append(("advance", _chains(self), _chains(port)))

        def on_keyframe(self, m, kf_id, dets, stamp, K, img_wh=None):
            port = tpu.carry_dynamic_manager(self)
            port.on_keyframe(tstate.map_state_from_arrays(vars(m)), kf_id, [_det(d) for d in dets or []],
                             stamp=stamp, K=K, img_wh=img_wh)
            super().on_keyframe(m, kf_id, dets, stamp=stamp, K=K, img_wh=img_wh)
            steps.append(("on_keyframe", _chains(self), _chains(port)))

        def run_dynamic_ba(self, m, K, static_edges_fn=None):
            port = tpu.carry_dynamic_manager(self)
            pm = tstate.map_state_from_arrays(vars(m))
            costs.last.clear()
            wp = port.run_dynamic_ba(pm, K, static_edges_fn=lambda w: tdyn.static_anchor_edges(pm, w))
            wj = super().run_dynamic_ba(m, K, static_edges_fn=static_edges_fn)
            steps.append(("run_dynamic_ba", (wj, m.kf_tcw.copy(), _chains(self), costs.last.get("jax")),
                          (wp, pm.kf_tcw.copy(), _chains(port), costs.last.get("port"))))
            return wj

    return Recording


@pytest.fixture(scope="module")
def rgbd_run():
    """JAX's DynamicRgbdTracker over the RGBD gate, its manager recorded."""
    g = tpu.dynamic_gate()
    steps = []
    with _Costs() as costs:
        J = tpu.dynamic_rgbd_tracker(jdyn, g, manager=_recording(steps, costs)())
        dets = tpu.dynamic_gate_dets(g, jdyn.DynamicDetection)
        for i, f in enumerate(g["frames"]):
            J.track(f, g["depths"][i], dets[i])
    return dict(J=J, steps=steps, g=g)


@pytest.fixture(scope="module")
def kitti_run():
    """JAX's KittiMonoTracker(dynamic=True) over the mono gate, its manager
    recorded."""
    g = tpu.dynamic_gate()
    steps = []
    with _Costs() as costs:
        J = tpu.dynamic_kitti_tracker(jk, g, dyn_manager=_recording(steps, costs)(world_T_slam=g["poses"][0]))
        for f in g["frames"]:
            J.track(f)
        J.flush()
    return dict(J=J, steps=steps, g=g)


def _same_chains(a, b, bookkeeping_only=False):
    assert set(a) == set(b)
    for tid in a:
        x, y = a[tid], b[tid]
        for k in ("alive", "has_local", "spawn_kf"):
            assert np.array_equal(x[k], y[k]), (tid, k)
        for k in ("kf_stamp", "kf_frame"):
            assert x[k] == y[k], (tid, k)
        assert set(x["kf_pose"]) == set(y["kf_pose"]) and set(x["kf_obs"]) == set(y["kf_obs"])
        assert set(x["kf_bbox"]) == set(y["kf_bbox"]) and len(x["history"]) == len(y["history"])
        for k in x["kf_bbox"]:
            assert np.array_equal(x["kf_bbox"][k], y["kf_bbox"][k])
        for k in x["kf_obs"]:
            assert np.array_equal(x["kf_obs"][k][1], y["kf_obs"][k][1])
            assert np.abs(x["kf_obs"][k][0] - y["kf_obs"][k][0]).max() <= TRACK_TOL
        if not bookkeeping_only:
            assert np.abs(x["xy"] - y["xy"])[x["alive"]].max(initial=0.0) <= TRACK_TOL


def _same_ba_step(j, p):
    """One run_dynamic_ba of both packages from the same state within the
    STEP_* radii; returns the two packages' chains after it."""
    (wj, tj, cj, costj), (wp, tp, cp, costp) = j, p
    assert wj == wp
    if wj is not None:
        assert np.abs(tp - tj).max() <= STEP_CAM
        assert abs(costp / costj - 1.0) <= STEP_COST, (costp, costj)
        for tid in cj:
            x, y = cj[tid], cp[tid]
            assert max(np.abs(x["kf_pose"][k] - y["kf_pose"][k]).max() for k in x["kf_pose"]) <= STEP_POSE
            assert abs(x["velocity"][0] - y["velocity"][0]) <= STEP_SPEED
            assert abs(x["velocity"][1] - y["velocity"][1]) <= STEP_STEER
    return cj, cp


@pytest.mark.parametrize("kind", ["advance", "on_keyframe", "run_dynamic_ba"])
def test_rgbd_gate_manager_steps_from_carried_state(rgbd_run, kind):
    """Every step of that kind on the RGBD gate (KLT chains with Harris
    re-seeding, keyframe snapshots with motion-compensated triangulation
    and the cuboid-depth initialization, the two-stage dynamic BA with
    static anchors): the same liveness, object-coordinate flags, spawn
    keyframes, per-keyframe entries and history; tracks within TRACK_TOL,
    object coordinates within LOCAL_TOL; the keyframe snapshot's object
    poses exactly; the BA's window equal, and its cameras, object poses,
    speed, steering angle and final cost within the STEP_* radii of JAX's
    own step spread."""
    steps = [s for s in rgbd_run["steps"] if s[0] == kind]
    assert len(steps) >= (10 if kind == "advance" else 4)
    for _, j, p in steps:
        if kind == "run_dynamic_ba":
            j, p = _same_ba_step(j, p)
        _same_chains(j, p)
        for tid in j:
            x, y = j[tid], p[tid]
            assert np.abs(x["local"] - y["local"])[x["has_local"]].max(initial=0.0) <= LOCAL_TOL
            if kind != "run_dynamic_ba":
                for k in x["kf_pose"]:
                    assert np.array_equal(x["kf_pose"][k], y["kf_pose"][k])
                assert np.array_equal(x["velocity"], y["velocity"])
    if kind == "advance":
        # the box's points were tracked and re-seeded on the way
        assert any(p[0]["alive"].sum() >= 12 for _, _, p in steps)
    if kind == "run_dynamic_ba":
        assert any(s[1][0] is not None for s in steps)


@pytest.mark.parametrize("kind", ["advance", "on_keyframe", "run_dynamic_ba"])
def test_kitti_gate_manager_steps_from_carried_state(kitti_run, kind):
    """The mono gate's manager (the offline rows, no masks: no KLT, so
    advance only spawns chains; every point edge gated off, one solve with
    the window cameras free and the object rotations fixed, which stay
    exactly the measurements'): each step as on the RGBD gate."""
    steps = [s for s in kitti_run["steps"] if s[0] == kind]
    if kind == "advance":
        assert not steps  # the mono tracker never advances chains
        return
    assert len(steps) >= 4
    for _, j, p in steps:
        if kind == "run_dynamic_ba":
            j, p = _same_ba_step(j, p)
        _same_chains(j, p, bookkeeping_only=True)
        for tid in j:
            x, y = j[tid], p[tid]
            assert not x["has_local"].any() and not y["has_local"].any()
            for k in x["kf_pose"]:
                # fix_rotation: the rotations are the measurements'
                assert np.array_equal(x["kf_pose"][k][:3, :3], y["kf_pose"][k][:3, :3])
                if kind != "run_dynamic_ba":
                    assert np.array_equal(x["kf_pose"][k], y["kf_pose"][k])


def _two_stage_state(mgr, m):
    """Keyframe poses and, per chain, the points with object coordinates in
    the world at each keyframe (free of the object-frame gauge), the
    object's motion since its first keyframe and its velocity."""
    out = {}
    for tid, ch in mgr.chains.items():
        ks = sorted(ch.kf_pose)
        pts = ch.local[ch.has_local]
        out[tid] = ({k: pts @ ch.kf_pose[k][:3, :3].T + ch.kf_pose[k][:3, 3] for k in ks},
                    {k: ch.kf_pose[k][:3, 3] - ch.kf_pose[ks[0]][:3, 3] for k in ks}, ch.velocity.copy())
    return m.kf_tcw.copy(), out


@pytest.mark.parametrize("cap", [1024, 40, 20])
def test_two_stage_dynamic_ba_from_carried_state(rgbd_run, cap):
    """run_dynamic_ba with the point edges on (ba_pt_obj_cam: a first solve,
    chi-square pruning, a second solve) from the RGBD gate's final JAX
    state, its 69 point edges clipped to `cap` as JAX clips them: the same
    window, and the cameras, the object's points in the world, its motion
    and its velocity within the TWO_STAGE_* radii of JAX's own spread."""
    J = rgbd_run["J"]
    J._apply_pending_map()
    base = copy.deepcopy(J.dynamic)
    base.__class__ = jdyn.DynamicObjectManager
    base.ba_pt_obj_cam, base.max_dp_edges = True, cap
    port, pm, jm = tpu.carry_dynamic_manager(base), tstate.map_state_from_arrays(vars(J.map)), copy.deepcopy(J.map)
    wj = base.run_dynamic_ba(jm, J.K, static_edges_fn=lambda w: jdyn.static_anchor_edges(jm, w))
    wp = port.run_dynamic_ba(pm, J.K, static_edges_fn=lambda w: tdyn.static_anchor_edges(pm, w))
    assert wj is not None and wp == wj
    (tj, cj), (tp, cp) = _two_stage_state(base, jm), _two_stage_state(port, pm)
    assert np.abs(tp - tj).max() <= TWO_STAGE_CAM
    for tid in cj:
        assert max(np.abs(cp[tid][0][k] - cj[tid][0][k]).max() for k in cj[tid][0]) <= TWO_STAGE_WORLD
        assert max(np.abs(cp[tid][1][k] - cj[tid][1][k]).max() for k in cj[tid][1]) <= TWO_STAGE_MOTION
        assert abs(cp[tid][2][0] - cj[tid][2][0]) <= TWO_STAGE_SPEED
        assert abs(cp[tid][2][1] - cj[tid][2][1]) <= TWO_STAGE_STEER
        assert port.chains[tid].has_local.sum() == base.chains[tid].has_local.sum() >= 8


@pytest.mark.parametrize("cap", [1024, 40, 8])
def test_static_anchor_edges_bit_for_bit(rgbd_run, cap):
    """static_anchor_edges on the RGBD gate's final map over its last six
    keyframes: the same arrays bit for bit at the default cap, at a cap
    that limits each keyframe, and None below ten edges (cap 8)."""
    m = rgbd_run["J"].map
    window = sorted(m.kf_ids(), key=lambda k: int(m.kf_frame_id[k]))[-6:]
    j = jdyn.static_anchor_edges(m, window, cap)
    t = tdyn.static_anchor_edges(tstate.map_state_from_arrays(vars(m)), window, cap)
    if cap == 8:
        assert j is None and t is None
        return
    assert j is not None and len(j) == len(t) == 5
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    n = int(j[4].sum())
    assert 10 <= n <= cap
    if cap < 1024:  # at most cap // len(window) per keyframe
        assert np.bincount(j[0][:n]).max() <= cap // len(window)


def test_erode_bit_for_bit():
    """The zero-padded 3-pixel erosion of an instance mask touching the
    borders."""
    r = tpu.rng(3)
    mask = r.uniform(size=(40, 60)) < 0.8
    mask[:, :5] = True
    assert np.array_equal(tdyn._erode(mask), jdyn._erode(mask))
    for dy, dx in ((3, -3), (-3, 0), (0, 3)):
        assert np.array_equal(tdyn._shift2d(mask, dy, dx), jdyn._shift2d(mask, dy, dx))


def test_load_state_round_trip(rgbd_run):
    """carry_dynamic_manager copies every chain field: the port manager
    carried from JAX's final state holds the same chains, and changing it
    leaves JAX's untouched."""
    jm = rgbd_run["J"].dynamic
    pm = tpu.carry_dynamic_manager(jm)
    _same_chains(_chains(jm), _chains(pm))
    for tid, ch in pm.chains.items():
        assert np.array_equal(ch.local, jm.chains[tid].local)
        ch.alive[:] = False
        for _, a in ch.kf_obs.values():
            a[:] = False
    assert any(ch.alive.any() for ch in jm.chains.values())
    assert torch.equal(pm._prev_gray, torch.as_tensor(np.asarray(jm._prev_gray, dtype=np.float32)))


def _files(ser, store, mgr, tmp, name):
    stem = os.path.join(tmp, name + ".txt")
    ser.save_cuboids_txt(stem, store, dynamic_manager=mgr)
    return [open(stem[:-4] + s).read() for s in (".txt", "_dynamic.txt", "_velocity.txt")]


def test_save_cuboids_txt_dynamic_files(kitti_run, tmp_path):
    """The port's save_cuboids_txt with a dynamic manager writes the JAX
    package's three files character for character from the same state (the
    mono gate's final manager carried over): the cuboids, the per-keyframe
    `tracklet frame x y z yaw` rows and the `tracklet frame v steer`
    velocity history."""
    J = kitti_run["J"]
    from cube_slam_tpu_torch.slam import objects as tobj

    store = tobj.ObjectStore.from_arrays(vars(J.objects.store))
    j = _files(jser, J.objects.store, J.dynamic, str(tmp_path), "jax")
    t = _files(tser, store, tpu.carry_dynamic_manager(J.dynamic), str(tmp_path), "port")
    assert t == j
    dyn = np.loadtxt(str(tmp_path / "port_dynamic.txt"), ndmin=2)
    vel = np.loadtxt(str(tmp_path / "port_velocity.txt"), ndmin=2)
    assert dyn.shape[0] >= 3 and dyn.shape[1] == 6 and (dyn[:, 0] == tpu.DYNAMIC_GATE_TID).all()
    assert vel.shape[0] >= 1 and vel.shape[1] == 4


def test_track_dynamic_object_matches_jax():
    """track_dynamic_object on tests/test_dynamic_pipeline.py's scene
    through both packages: the same tracked-point count, per-frame object
    poses, velocity and points within BA_TOL, and both recover the box's
    speed and per-frame motion as that test asks."""
    args, kw, true, v_true = tpu.cs.dynamic_pipeline_scene()
    j = jdyn.track_dynamic_object(*args, **kw)
    t = tdyn.track_dynamic_object(*args, device="cpu", **kw)
    assert t.n_tracked_pts == j.n_tracked_pts >= 10
    assert np.abs(t.obj_pose_per_frame - j.obj_pose_per_frame).max() <= BA_TOL
    assert np.abs(t.velocity - j.velocity).max() <= BA_TOL
    assert np.abs(t.local_pts - j.local_pts).max() <= BA_TOL
    assert abs(float(t.velocity[0]) - v_true) < 0.15
    rel = t.obj_pose_per_frame[1:, :3, 3] - t.obj_pose_per_frame[:-1, :3, 3]
    np.testing.assert_allclose(rel, true[1:, :3, 3] - true[:-1, :3, 3], atol=0.08)
