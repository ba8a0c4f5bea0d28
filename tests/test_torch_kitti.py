"""The monocular KITTI tracker of cube_slam_tpu_torch (slam/kitti.py:
KittiMonoTracker, static objects) against the JAX package on the CPU: the
offline rows, both first-frame bootstraps and the object-depth scale anchor
bit for bit on the same inputs, each keyframe step of the monocular KITTI
gate from JAX's state carried into the port, its fork frame from JAX's
state, and the gate itself through both packages, from scratch and from
JAX's state past the fork; the JAX tracker with its local-BA fold forced
synchronous.

The gate is tests/test_kitti_mode.py:37's scene (14 frames 320x240, the
box as offline cuboid with tracklet 7, the car prior = the box's half
extents, ground recovery every 3 keyframes). Two-view initialization never
succeeds on it, in either package (that JAX test fails with "nothing
tracked" on the CPU), so the gate bootstraps its map from the first
frame's object depth (firstframe_depth_init). Frame 5's pose forks on
rounding, and the anchors and the object BA carry the fork through the
run: 1-ulp perturbations of JAX's own state move its keyframes, anchors,
trajectory and landmark (tools/kitti_gate_spread.py). Every bound below is
that spread's radius about JAX's run, measured on this CPU."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch_parity_utils as tpu

import cube_slam_tpu.slam as jslam
import cube_slam_tpu.slam.ground  # noqa: F401
import cube_slam_tpu_torch.slam as tslam
import cube_slam_tpu_torch.slam.ground  # noqa: F401
from cube_slam_tpu.ops import orb as jorb
from cube_slam_tpu.slam import kitti as jk
from cube_slam_tpu.slam import state as jstate
from cube_slam_tpu_torch.slam import kitti as tk
from cube_slam_tpu_torch.slam import state as tstate

FIELDS = ("xy", "level", "angle", "desc", "valid")

# One keyframe step from the same JAX state (tools/kitti_gate_spread.py
# --steps: the largest difference of JAX's own step under 8 1-ulp
# perturbations of its state, over the gate's 4 keyframe steps): landmark
# pose entries 0.6587, landmark half-scale 0.0125, keyframe pose entries
# 6.65e-4, map points 0.0183, relative anchor scale 1.31e-3. The port
# measured 0.316, 0.00685, 5.58e-4, 0.0066 and 1.09e-3.
STEP_LANDMARK_POSE, STEP_LANDMARK_SCALE = 0.66, 0.0126
STEP_KF_TCW, STEP_MP_POS, STEP_ANCHOR_REL = 6.7e-4, 0.0184, 1.32e-3
# The whole gate from scratch: the radius of JAX's 1-ulp spread, the
# largest gap of any of its 72 perturbed runs from its unperturbed one
# (tools/kitti_gate_spread.py: 36 runs perturbed after the bootstrap, 36
# after every keyframe step too): keyframe and anchor counts 1 apart, the
# second anchor 4.55e-3 relative, the final trajectory's rotation entries
# 0.0329 and the tracklet-7 landmark's half-scale 0.118. Every run tracks
# the same frames and recovers no ground scale (observed on this CPU). The
# port measured 1, 0, 4.10e-3, 0.0239 and 0.107.
GATE_KEYFRAMES, GATE_ANCHORS, GATE_ANCHOR = 1, 1, 4.6e-3
GATE_ROTATION, GATE_SCALE = 0.033, 0.118
# Frame 5 forks: its pose LM, on 37 matches to a 46-point map bootstrapped
# from the box, keeps 3 inliers after its first round and lands in one of
# two basins on rounding alone (19 or 21 final inliers; JAX's own 1-ulp
# perturbations reach both). From JAX's state just before frame 5, the
# radius of 8 perturbed JAX steps (tools/kitti_gate_spread.py --frames):
# the pose and motion model's entries 0.0338 and 0.0336, the inliers 2, the
# associations handed to the next frame 38. The port measured 0.0256,
# 0.0253, 2 and 33.
FORK = 5
FORK_POSE, FORK_INLIERS, FORK_ASSOC = 0.034, 2, 38
# Past the fork: the port carried from JAX's state just before frame 6 runs
# to the end; the radius of 24 JAX runs perturbed there (--from-frame 6
# --at keyframes): the later anchors 0.0432 relative, the final
# trajectory's Tcw entries 0.0587, its rotation entries 0.0151 and its
# camera centres 0.0560 m, the landmark's centre 0.183 m and its half-scale
# 0.0188; every run makes as many keyframes and anchors and tracks the same
# frames. The port measured 1.07e-3, 6.2e-4, 1.6e-4, 6.5e-4 m, 0.0343 m and
# 0.0027; a pose LM that relinearizes at every iteration reads Tcw 0.0585
# and centres 0.0672 m here.
PAST_FORK = FORK + 1
PAST_ANCHORS, PAST_TCW, PAST_ROTATION, PAST_CENTRE = 0.0432, 0.0587, 0.0151, 0.0560
PAST_LANDMARK, PAST_SCALE = 0.183, 0.0188


def _arrays(obj):
    return {k: v.copy() for k, v in vars(obj).items() if isinstance(v, np.ndarray)}


def _same_arrays(a, b):
    assert set(a) == set(b)
    for name in a:
        assert np.array_equal(a[name], b[name]), name


@pytest.fixture(scope="module")
def gate():
    """The JAX gate run, with the port's keyframe step from JAX's carried
    state at each of its keyframes and a copy of JAX's tracker before the
    first keyframe step; then the port's own run of the gate."""
    frames, poses, offline, scene = tpu.kitti_mono_sequence()
    steps, before = [], []
    base = tpu.sync_fold(jk.KittiMonoTracker)

    class Hooked(base):
        def _create_keyframe(self, feats, fid=None):
            if not before:
                before.append(copy.deepcopy(self))
            port = tpu.carry_kitti_tracker(self)
            h = {k: getattr(feats, k).copy() for k in FIELDS}
            port._create_keyframe(tstate.FrameFeatures(**h, mp=feats.mp.copy()), fid=fid)
            super()._create_keyframe(feats, fid=fid)
            steps.append((fid, self.ref_kf, _arrays(self.map), _arrays(self.objects.store),
                          list(self._anchor_scales), self.n_scale_recoveries, port))

    J = tpu.kitti_mono_tracker(jslam, offline, poses[0], firstframe_depth_init=True)
    J.__class__ = Hooked
    P = tpu.kitti_mono_tracker(tslam, offline, poses[0], device="cpu", firstframe_depth_init=True)
    snaps = {}
    for f, gray in enumerate(frames):
        if f >= FORK:
            J._apply_pending_map()
            snaps[f] = copy.deepcopy(J)
            snaps[f].__class__ = base
        J.track(gray)
        P.track(gray)
    J.flush()
    P.flush()
    # the port from JAX's state past the frame-5 fork, to the end
    Pc = tpu.carry_kitti_tracker(snaps[PAST_FORK])
    Pc.__class__ = tpu.sync_fold(type(Pc))
    for gray in frames[PAST_FORK:]:
        Pc.track(gray)
    Pc.flush()
    return dict(J=J, P=P, Pc=Pc, steps=steps, before=before[0], snaps=snaps, poses=poses, scene=scene,
                frames=frames, offline=offline)


@pytest.mark.parametrize("case", ["rows", "empty", "none", "outside"])
def test_rows_for(case):
    """_rows_for: a frame's rows as a 2-D array, None for an empty or
    missing entry and for a frame outside the list; the same in both
    packages (exact)."""
    rows = [np.arange(13.0), np.zeros((0, 13)), None]
    fid = {"rows": 0, "empty": 1, "none": 2, "outside": 3}[case]

    class Holder:
        offline = rows

    j, t = jk.KittiMonoTracker._rows_for(Holder, fid), tk.KittiMonoTracker._rows_for(Holder, fid)
    if case == "rows":
        assert t.shape == (1, 13) and np.array_equal(t, j)
    else:
        assert t is None and j is None
    assert tk.KittiMonoTracker._rows_for(Holder, -1) is None


def _background(trk, frac=0.7, depth_factor=1.6):
    """Move `frac` of the reference keyframe's in-box points whose rays hit
    the cuboid to `depth_factor` times their ray-cuboid depth (background
    leaking into the 2D box, behind the object). Returns (moved, kept)."""
    m = trk.map
    k = trk.ref_kf
    rows = trk._rows_for(trk.frame_id)
    r = rows[0]
    local_pose, scale = tk._local_pose(trk.init_to_ground, r)
    x, y, w, h = r[7:11]
    xy, mp = m.kf_kp_xy[k], m.kf_kp_mp[k]
    sel = np.where((mp >= 0) & (xy[:, 0] >= x) & (xy[:, 0] <= x + w) & (xy[:, 1] >= y) & (xy[:, 1] <= y + h))[0]
    sel = sel[m.mp_valid[mp[sel]]]
    d = tk._ray_cuboid_depth(trk.K, xy[sel], local_pose, scale)
    sel, d = sel[d > 0], d[d > 0]
    n = int(frac * len(sel))
    rays = np.concatenate([xy[sel[:n]], np.ones((n, 1))], axis=1) @ np.linalg.inv(trk.K.astype(np.float64)).T
    pc = rays * (depth_factor * d[:n, None])
    Twc = np.linalg.inv(m.kf_tcw[k].astype(np.float64))
    m.mp_pos[mp[sel[:n]]] = (pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)
    return n, len(sel) - n


@pytest.mark.parametrize("case", ["rescaled", "background"])
def test_offline_depth_scale_init_is_bit_equal(gate, case):
    """_offline_depth_scale_init on the gate's map (JAX's tracker before
    its first keyframe step, the frame set to the reference keyframe's),
    rescaled by 0.37 so the anchor has work; "background" also moves 70%
    of the in-box points behind the cuboid, so they outnumber the box's
    and the densest-cluster rule decides. The same scale bit for bit, and
    every map array, the pose, the motion model and the relative trajectory
    equal afterwards."""
    J = copy.deepcopy(gate["before"])
    J.frame_id = int(J.map.kf_frame_id[J.ref_kf])
    jk.GroundScaleEstimator.apply_scale(J.map, J.ref_kf, 0.37)
    if case == "background":
        moved, kept = _background(J)
        assert moved > kept >= 5, (moved, kept)
    P = tpu.carry_kitti_tracker(J)
    n = len(J._anchor_scales)
    J._offline_depth_scale_init()
    P._offline_depth_scale_init()
    assert len(J._anchor_scales) == n + 1 and P._anchor_scales == J._anchor_scales
    scale = J._anchor_scales[-1]
    # the box's points read ~1/0.37; the moved ones sit at 1.6 times their
    # metric depth, read 1/1.6, and being the denser cluster they win
    assert (2.5 < scale < 2.9) if case == "rescaled" else abs(scale - 0.625) < 0.01, scale
    _same_arrays(_arrays(J.map), _arrays(P.map))
    assert np.array_equal(P.last_Tcw, J.last_Tcw) and np.array_equal(P.velocity, J.velocity)
    assert all(a[:3] == b[:3] and np.array_equal(a[3], b[3]) for a, b in zip(P._traj_rel, J._traj_rel))
    assert P.mono_scale_initialized and J.mono_scale_initialized


def _orb(gray):
    f = jorb.extract_orb_fused(jnp.asarray(gray, dtype=jnp.float32), jorb.OrbPyramidConfig(600, n_levels=3))
    return {k: np.array(f[k]) for k in FIELDS}


@pytest.mark.parametrize("bootstrap", ["first_depth", "object_depth"])
def test_first_frame_bootstraps_build_the_same_map(gate, bootstrap):
    """_try_initialize on the gate's first frame with a rendered depth
    image (first_depth) or the object's ray-cuboid depth
    (firstframe_depth_init), through _depth_seed_initialize: every map
    array bit for bit, the pose, the frame's associations and the scale
    flag."""
    poses, offline = gate["poses"], gate["offline"]
    kw = (dict(first_depth=gate["scene"].render(poses[0], tpu.GATE_A_K, wh=(320, 240), return_depth=True)[1])
          if bootstrap == "first_depth" else dict(firstframe_depth_init=True))
    J = tpu.kitti_mono_tracker(jslam, offline, poses[0], **kw)
    P = tpu.kitti_mono_tracker(tslam, offline, poses[0], device="cpu", **kw)
    h = _orb(gate["frames"][0])
    fj = jstate.FrameFeatures(**{k: v.copy() for k, v in h.items()})
    fp = tstate.FrameFeatures(**{k: v.copy() for k, v in h.items()})
    J.frame_id = P.frame_id = 0
    assert J._try_initialize(fj) and P._try_initialize(fp)
    _same_arrays(_arrays(J.map), _arrays(P.map))
    assert int(P.map.mp_valid.sum()) >= 30 and len(P.map.kf_ids()) == 1
    assert np.array_equal(fp.mp, fj.mp) and P.last_frame is fp
    assert np.array_equal(P.last_Tcw, J.last_Tcw) and P.ref_kf == J.ref_kf
    assert P.mono_scale_initialized and J.mono_scale_initialized
    assert P.first_depth is None and J.first_depth is None  # consumed (or never given)


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_create_keyframe_on_a_carried_map(gate, i):
    """One static keyframe step (the plain step, the anchor, ingest,
    tracklet association, cull, object BA, ground recovery) from JAX's
    state at each of the gate's keyframes: the same keyframe slot, anchor
    count and recovery count, the scale anchor within STEP_ANCHOR_REL
    relative, keyframe poses within STEP_KF_TCW, map points within
    STEP_MP_POS, the landmark's pose entries within STEP_LANDMARK_POSE and
    its half-scale within STEP_LANDMARK_SCALE (JAX's own step spread). The
    four cases spread over the keyframe steps JAX made (four here: each
    one; JAX's 1-ulp spread makes four or five)."""
    steps = gate["steps"]
    assert len(steps) >= 2
    fid, k, mj, sj, anchors, recoveries, P = steps[i * (len(steps) - 1) // 3]
    assert P.ref_kf == k and P.n_scale_recoveries == recoveries
    assert len(P._anchor_scales) == len(anchors)
    if anchors:
        assert abs(P._anchor_scales[-1] / anchors[-1] - 1.0) <= STEP_ANCHOR_REL, (P._anchor_scales, anchors)
    mp = _arrays(P.map)
    assert np.array_equal(mp["kf_valid"], mj["kf_valid"]) and np.array_equal(mp["mp_valid"], mj["mp_valid"])
    assert np.abs(mp["kf_tcw"] - mj["kf_tcw"]).max() <= STEP_KF_TCW
    assert np.abs(mp["mp_pos"] - mj["mp_pos"]).max() <= STEP_MP_POS
    sp = _arrays(P.objects.store)
    assert np.array_equal(sp["valid"], sj["valid"]) and np.array_equal(sp["fix_scale"], sj["fix_scale"])
    assert sj["valid"].sum() == 1
    assert np.abs(sp["pose"] - sj["pose"]).max() <= STEP_LANDMARK_POSE
    assert np.abs(sp["scale"] - sj["scale"]).max() <= STEP_LANDMARK_SCALE


@pytest.mark.parametrize("where", ["tracker", "entry_point"])
def test_dynamic_mode_raises(where, tmp_path):
    """dynamic=True (the mono_dynamic configuration) and a dynamic manager
    are taken: the tracker builds its DynamicObjectManager on its own device,
    with the first camera's ground alignment, keeps a given manager, and
    drops the chains on reset; the entry point runs the mono dynamic gate
    (chip_smoke.dynamic_gate_scene through run_kitti_sequence) and writes
    the dynamic files beside the trajectories."""
    from cube_slam_tpu_torch.slam import dynamic as tdyn

    if where == "tracker":
        G = tpu.gate_a_sequence(2)[1][0]
        t = tk.KittiMonoTracker(tpu.GATE_A_K, (320, 240), [], G, dynamic=True, device="cpu")
        assert isinstance(t.dynamic, tdyn.DynamicObjectManager) and t.dynamic.device.type == "cpu"
        assert np.array_equal(t.dynamic.G, G) and t.dynamic.fix_rotation and not t.dynamic.ba_pt_obj_cam
        t.dynamic.chains[7] = object()
        t.reset()
        assert t.dynamic.chains == {}
        mgr = tdyn.DynamicObjectManager(device="cpu")
        assert tk.KittiMonoTracker(tpu.GATE_A_K, (320, 240), [], G, dynamic=True, dyn_manager=mgr,
                                   device="cpu").dynamic is mgr
        assert tk.KittiMonoTracker(tpu.GATE_A_K, (320, 240), [], G, device="cpu").dynamic is None
    else:
        out = tpu.cs.dynamic_gate_run("kitti-entry", "cpu", str(tmp_path))
        assert out["tracked"] == list(range(tpu.cs.DYNAMIC_GATE_FRAMES)) and out["obj"]["n_kf"] >= 3
        assert len(out["files"]["cuboids_dynamic"].splitlines()) == out["obj"]["n_kf"]
        assert out["files"]["cuboids_velocity"].strip()


def _outcome(trk):
    traj = trk.final_trajectory()
    st = trk.objects.store
    o = trk.objects.trackletid_to_landmark[7]
    return dict(tracked=[f for f, T in traj if T is not None], Tcw={f: T for f, T in traj if T is not None},
                kf_frames=sorted(int(trk.map.kf_frame_id[k]) for k in trk.map.kf_ids()),
                anchors=list(trk._anchor_scales), recoveries=trk.n_scale_recoveries, landmark=o,
                centre=st.pose[o][:3, 3].astype(np.float64), scale=st.scale[o].copy(), valid=bool(st.valid[o]),
                fix=bool(st.fix_scale[o]))


def test_mono_gate_outcome_matches_jax(gate):
    """The gate through both packages from scratch, within what JAX itself
    does under 1-ulp perturbations of its state (the GATE_* radii): the
    same tracked frames and no ground recovery, keyframe and anchor counts
    within GATE_KEYFRAMES / GATE_ANCHORS, the first anchor (after the
    bootstrap) equal and the second within GATE_ANCHOR relative, a live
    fixed-scale landmark for tracklet 7 whose half-scale lies within
    GATE_SCALE of JAX's, and every final-trajectory rotation within
    GATE_ROTATION (Tcw rotation entries).

    Frame 5 forks (FORK): which of its two poses a run takes is rounding,
    and the anchors after it rescale the map about their keyframes, so the
    translations and the landmark's centre of two whole runs are as far
    apart as the branches (the port's run here takes the other branch from
    JAX's and JAX's anchor from the port's state at its keyframe 9 is the
    port's 4.23). The fork is held to JAX's spread in
    test_frame_5_from_carried_state, and the rest of the run, translations
    and landmark included, in test_mono_gate_past_the_fork_matches_jax."""
    j, p = _outcome(gate["J"]), _outcome(gate["P"])
    assert len(j["tracked"]) >= 0.7 * 14
    assert p["tracked"] == j["tracked"]
    assert p["recoveries"] == j["recoveries"] == 0
    assert abs(len(p["kf_frames"]) - len(j["kf_frames"])) <= GATE_KEYFRAMES, (p["kf_frames"], j["kf_frames"])
    assert abs(len(p["anchors"]) - len(j["anchors"])) <= GATE_ANCHORS and len(j["anchors"]) >= 2
    assert p["anchors"][0] == j["anchors"][0]
    assert abs(p["anchors"][1] / j["anchors"][1] - 1.0) <= GATE_ANCHOR, (p["anchors"], j["anchors"])
    assert p["valid"] and p["fix"] and j["valid"] and j["fix"]
    assert gate["J"].mono_scale_initialized and gate["P"].mono_scale_initialized
    assert np.abs(p["scale"] - j["scale"]).max() <= GATE_SCALE
    rot = max(float(np.abs(p["Tcw"][f][:3, :3] - j["Tcw"][f][:3, :3]).max()) for f in j["tracked"])
    assert rot <= GATE_ROTATION, rot


def _frame_state(trk, out):
    return dict(Tcw=out, velocity=trk.velocity.copy(), kf=trk.last_kf_frame_id, anchors=len(trk._anchor_scales),
                inliers=int(trk.tracked_inliers), assoc=int((trk.last_frame.mp >= 0).sum()),
                reseed=trk._dev_state is None)


def test_frame_5_from_carried_state(gate):
    """Frame 5, the fork, from JAX's state just before it in both packages:
    tracked in both, the same keyframe decision and anchor count; the pose
    it returns and the motion model within FORK_POSE (entries), the tracked
    inliers within FORK_INLIERS and the keypoint associations it hands the
    next frame within FORK_ASSOC (JAX's own spread at this frame, which
    reaches both of its basins); and the device tracker state re-seeds from
    those host values in both (the keyframe step drops it)."""
    J = copy.deepcopy(gate["snaps"][FORK])
    P = tpu.carry_kitti_tracker(J)
    P.__class__ = tpu.sync_fold(type(P))
    gray = gate["frames"][FORK]
    j, p = _frame_state(J, J.track(gray)), _frame_state(P, P.track(gray))
    assert j["Tcw"] is not None and p["Tcw"] is not None
    assert p["kf"] == j["kf"] == FORK and p["anchors"] == j["anchors"]
    assert p["reseed"] and j["reseed"]
    assert np.abs(p["Tcw"] - j["Tcw"]).max() <= FORK_POSE
    assert np.abs(p["velocity"] - j["velocity"]).max() <= FORK_POSE
    assert abs(p["inliers"] - j["inliers"]) <= FORK_INLIERS and abs(p["assoc"] - j["assoc"]) <= FORK_ASSOC


def test_mono_gate_past_the_fork_matches_jax(gate):
    """The port carried from JAX's state just before frame 6 runs the rest
    of the gate (frames 6-13: three keyframe steps with their anchors and
    object BAs) within JAX's own 1-ulp spread from that state (the PAST_*
    radii): the same tracked frames and as many keyframes and anchors, the
    later anchors within PAST_ANCHORS relative, every final-trajectory pose
    within PAST_TCW (Tcw entries), its rotation entries within
    PAST_ROTATION and its camera centres within PAST_CENTRE, tracklet 7's
    landmark live and fixed-scale with its centre within PAST_LANDMARK and
    its half-scale within PAST_SCALE."""
    j, p = _outcome(gate["J"]), _outcome(gate["Pc"])
    assert p["tracked"] == j["tracked"] and p["recoveries"] == j["recoveries"]
    assert len(p["kf_frames"]) == len(j["kf_frames"]) and len(p["anchors"]) == len(j["anchors"])
    assert p["anchors"][:2] == j["anchors"][:2]
    later = max(abs(a / b - 1.0) for a, b in zip(p["anchors"][2:], j["anchors"][2:]))
    assert later <= PAST_ANCHORS, (p["anchors"], j["anchors"])
    tcw = max(float(np.abs(p["Tcw"][f] - j["Tcw"][f]).max()) for f in j["tracked"])
    rot = max(float(np.abs(p["Tcw"][f][:3, :3] - j["Tcw"][f][:3, :3]).max()) for f in j["tracked"])
    centre = max(float(np.linalg.norm(np.linalg.inv(p["Tcw"][f])[:3, 3] - np.linalg.inv(j["Tcw"][f])[:3, 3]))
                 for f in j["tracked"])
    assert tcw <= PAST_TCW and rot <= PAST_ROTATION and centre <= PAST_CENTRE, (tcw, rot, centre)
    assert p["valid"] and p["fix"]
    assert np.linalg.norm(p["centre"] - j["centre"]) <= PAST_LANDMARK
    assert np.abs(p["scale"] - j["scale"]).max() <= PAST_SCALE
