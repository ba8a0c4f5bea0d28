"""cube_slam_tpu_torch/slam/objects.py (a host-numpy copy) against
cube_slam_tpu/slam/objects.py, step by step on built maps: association with
promotion and with disjoint points (the cases of
tests/test_object_ba.py::test_association_promotes_by_shared_points and
more), the owned-point filter, the BA edge arrays, culling, the KITTI-mode
offline ingest and tracklet association, the state carry, and
detect_on_keyframe through the port's detector on a rendered keyframe."""

import numpy as np
import pytest
from torch_parity_utils import GATE_A_K, rng, room_scene

from cube_slam_tpu.slam import objects as jo
from cube_slam_tpu.slam.state import MapState as JaxMapState
from cube_slam_tpu_torch.slam import objects as to
from cube_slam_tpu_torch.slam.state import map_state_from_arrays


def _map():
    """A JAX MapState: 3 keyframes (identity rotation, shifted along x),
    map points 0..59 on a box 3 m ahead seen by all three at keypoints
    0..59, points 60..79 seen only by keyframe 2 (a second box), and
    background points 80..99."""
    r = rng(0)
    m = JaxMapState(max_kf=6, max_mp=128, n_kp=120)
    for k in range(3):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -0.2 * k
        m.kf_tcw[k] = T
        m.kf_valid[k] = True
        m.kf_frame_id[k] = 5 * k
    box = r.uniform(-0.4, 0.4, (60, 3)) + [0.0, 0.0, 3.0]
    box2 = r.uniform(-0.3, 0.3, (20, 3)) + [1.5, 0.0, 4.0]
    bg = r.uniform(-2, 2, (20, 3)) + [0.0, 0.0, 6.0]
    m.mp_pos[:100] = np.concatenate([box, box2, bg])
    m.mp_valid[:100] = True
    K = GATE_A_K.astype(np.float64)
    for k in range(3):
        ids = np.r_[0:60, 80:100] if k < 2 else np.arange(100)
        pc = m.mp_pos[ids] @ m.kf_tcw[k][:3, :3].T + m.kf_tcw[k][:3, 3]
        uv = (pc @ K.T)[:, :2] / pc[:, 2:3]
        m.kf_kp_xy[k, ids] = uv
        m.kf_kp_valid[k, ids] = True
        m.kf_kp_mp[k, ids] = ids
    return m


def _det(pkg, m, kf, box, local_t, scale=(0.4, 0.4, 0.4), quality=0.8, at_border=False):
    x, y, w, h = box
    kp = m.kf_kp_xy[kf]
    inside = (m.kf_kp_valid[kf] & (kp[:, 0] >= x) & (kp[:, 0] <= x + w) & (kp[:, 1] >= y) & (kp[:, 1] <= y + h))
    P = np.eye(4, dtype=np.float32)
    P[:3, 3] = local_t
    return pkg.Detection(kf_id=kf, local_pose=P, scale=np.array(scale, np.float32),
                         bbox=np.array([x + w / 2, y + h / 2, w, h], np.float32), quality=quality,
                         owned_kps=np.where(inside)[0], at_border=at_border)


def _both(**kw):
    jm = _map()
    tm = map_state_from_arrays(vars(jm))
    return (jm, jo.ObjectManager(detector=None, **kw)), (tm, to.ObjectManager(detector=None, **kw))


def _same_manager(a, b):
    for name in ("pose", "scale", "valid", "n_obs", "quality", "fix_scale", "gen"):
        assert np.array_equal(getattr(a.store, name), getattr(b.store, name)), name
    assert a._kf_counter == b._kf_counter and a.first_seen == b.first_seen
    assert [(d.kf_id, d.landmark, d.age) for d in a.detections] == [(d.kf_id, d.landmark, d.age) for d in b.detections]
    assert sorted(a.meas) == sorted(b.meas)
    for o in a.meas:
        assert [(d.kf_id, d.landmark) for d in a.meas[o]] == [(d.kf_id, d.landmark) for d in b.meas[o]]


BOX = (100.0, 70.0, 120.0, 100.0)  # the first box in every keyframe's view


def _sequence(pkg, m, mgr):
    """Keyframe 0: a candidate; keyframe 1: the same box again (promotion by
    shared points); keyframe 2: the box (votes for the landmark) and the
    second box (a new candidate over disjoint points)."""
    mgr.associate(m, 0, [_det(pkg, m, 0, BOX, (0.0, 0.0, 3.0))])
    mgr.associate(m, 1, [_det(pkg, m, 1, BOX, (0.2, 0.0, 3.0), quality=0.9)])
    box2 = (200.0, 90.0, 80.0, 60.0)
    mgr.associate(m, 2, [_det(pkg, m, 2, BOX, (0.4, 0.0, 3.05)), _det(pkg, m, 2, box2, (1.9, 0.0, 4.0))])


def test_associate_promotes_and_votes_like_jax():
    (jm, jmgr), (tm, tmgr) = _both(min_owned_points=5, min_shared_promote=5, min_shared_votes=8)
    _sequence(jo, jm, jmgr)
    _sequence(to, tm, tmgr)
    _same_manager(jmgr, tmgr)
    assert np.array_equal(jm.mp_best_obj, tm.mp_best_obj)
    assert tmgr.store.valid.sum() == 1 and tmgr.store.n_obs[0] == 3
    assert len(tmgr.detections) == 1 and tmgr.detections[0].landmark == -2  # the second box waits


@pytest.mark.parametrize("disjoint", [False, True])
def test_association_cases_of_the_jax_test(disjoint):
    """tests/test_object_ba.py::test_association_promotes_by_shared_points,
    through both packages: shared points promote one landmark, disjoint ones
    stay provisional."""
    outs = []
    for pkg, MapState in ((jo, JaxMapState), (to, None)):
        m = JaxMapState(max_kf=4, max_mp=64, n_kp=32)
        for k in range(2):
            m.kf_valid[k] = True
            m.kf_tcw[k] = np.eye(4, dtype=np.float32)
        m.mp_valid[:10] = True
        for k in range(2):
            m.kf_kp_valid[k, :10] = True
            m.kf_kp_mp[k, :10] = np.arange(10)
        m.mp_valid[20:25] = True
        m.kf_kp_valid[1, 20:25] = True
        m.kf_kp_mp[1, 20:25] = np.arange(20, 25)
        if pkg is to:
            m = map_state_from_arrays(vars(m))

        def det(kf, kps):
            return pkg.Detection(kf_id=kf, local_pose=np.eye(4, dtype=np.float32),
                                 scale=np.array([0.5, 0.4, 0.3], np.float32),
                                 bbox=np.array([50, 50, 40, 40], np.float32), quality=0.8, owned_kps=np.asarray(kps))

        mgr = pkg.ObjectManager(detector=None, min_owned_points=5, min_shared_promote=5, min_obs_to_promote=2)
        d0 = det(0, np.arange(10))
        d0.landmark = -2
        mgr.detections.append(d0)
        d1 = det(1, np.arange(20, 25) if disjoint else np.arange(10))
        mgr.associate(m, 1, [d1])
        outs.append((mgr, m, d0.landmark, d1.landmark))
    (jmgr, jm, j0, j1), (tmgr, tm, t0, t1) = outs
    assert (j0, j1) == (t0, t1)
    _same_manager(jmgr, tmgr)
    assert np.array_equal(jm.mp_best_obj, tm.mp_best_obj)
    if disjoint:
        assert t1 == -2 and not tmgr.store.valid.any()
    else:
        assert t1 >= 0 and t0 == t1 and tmgr.store.valid[t1]


def test_pose_close_fallback_and_small_detections():
    """A detection without any mapped point promotes by pose proximity; one
    owning too few keypoints is skipped."""
    (jm, jmgr), (tm, tmgr) = _both(min_owned_points=5, min_shared_promote=5)
    for pkg, m, mgr in ((jo, jm, jmgr), (to, tm, tmgr)):
        m.kf_kp_mp[:2] = -1  # no keypoint of the first two keyframes has a map point
        mgr.associate(m, 0, [_det(pkg, m, 0, BOX, (0.0, 0.0, 3.0))])
        mgr.associate(m, 1, [_det(pkg, m, 1, BOX, (0.2, 0.0, 3.1)), _det(pkg, m, 1, (0, 0, 5, 5), (0, 0, 1))])
    _same_manager(jmgr, tmgr)
    assert tmgr.store.valid.sum() == 1


def test_filter_recenter_ba_edges_and_cull_match_jax():
    """filter_and_recenter's ownership and recentred pose, then ba_edges'
    15 arrays (array-equal, pow2 capacities included), then cull (a
    starved landmark and a scale wreck)."""
    (jm, jmgr), (tm, tmgr) = _both(min_owned_points=5, min_shared_promote=5, min_shared_votes=8)
    _sequence(jo, jm, jmgr)
    _sequence(to, tm, tmgr)
    for m in (jm, tm):
        m.mp_best_obj[80:84] = 0  # background points that leaked into the box
    for m, mgr in ((jm, jmgr), (tm, tmgr)):
        mgr.store.pose[0][:3, 3] += [0.05, -0.02, 0.1]
        mgr.filter_and_recenter(m)
    assert np.array_equal(jm.mp_best_obj, tm.mp_best_obj)
    np.testing.assert_allclose(tmgr.store.pose, jmgr.store.pose, atol=1e-6)
    for kf_map in ({0: 0, 1: 1, 2: 2}, {2: 0, 1: 1}):
        a = jmgr.ba_edges(jm, kf_map, camera_object_weight=0.7)
        b = tmgr.ba_edges(tm, kf_map, camera_object_weight=0.7)
        assert len(a) == len(b) == 15
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    # a second landmark that never gets a second sighting, and a wreck
    for pkg, m, mgr in ((jo, jm, jmgr), (to, tm, tmgr)):
        o = mgr.store.alloc()
        mgr.store.valid[o], mgr.store.n_obs[o] = True, 1
        mgr._add_meas(o, _det(pkg, m, 2, (200.0, 90.0, 80.0, 60.0), (1.9, 0.0, 4.0)))
        m.mp_best_obj[60:64] = o
        for _ in range(3):
            mgr.associate(m, 2, [])
        mgr.cull(m)
        assert not mgr.store.valid[o]
        mgr.store.scale[0] = [0.01, 0.3, 0.3]
        mgr.cull(m)
    _same_manager(jmgr, tmgr)
    assert np.array_equal(jm.mp_best_obj, tm.mp_best_obj) and not tmgr.store.valid.any()


def test_offline_ingest_and_tracklet_association_match_jax():
    """KITTI mode: offline cuboid rows (ground frame) -> camera-frame
    detections, then ground-truth tracklet association with the fixed-scale
    car prior."""
    r = rng(4)
    init_to_ground = np.eye(4)
    init_to_ground[:3, :3] = [[1, 0, 0], [0, 0, 1], [0, -1, 0]]
    init_to_ground[2, 3] = 1.7
    rows = np.stack([[r.uniform(-3, 3), r.uniform(8, 30), 0.8, r.uniform(-1, 1), 1.9, 0.8, 0.76,
                      r.uniform(50, 250), r.uniform(50, 150), 60, 40, r.uniform(0.3, 1), tid] for tid in (3, 7)])
    (jm, jmgr), (tm, tmgr) = _both(fixed_scale_prior=(1.9420, 0.8143, 0.7631))
    for kf in range(3):
        rr = rows.copy()
        rr[:, 0] += 0.1 * kf
        a = jmgr.ingest_offline(jm, kf, rr, init_to_ground, use_truth_trackid=True, img_wh=(320, 240))
        b = tmgr.ingest_offline(tm, kf, rr, init_to_ground, use_truth_trackid=True, img_wh=(320, 240))
        for x, y in zip(a, b):
            for name, v in vars(x).items():
                w = getattr(y, name)
                assert (np.array_equal(v, w) if isinstance(v, np.ndarray) else v == w), name
        jmgr.associate_by_tracklet(jm, kf, a)
        tmgr.associate_by_tracklet(tm, kf, b)
    _same_manager(jmgr, tmgr)
    assert jmgr.trackletid_to_landmark == tmgr.trackletid_to_landmark and len(tmgr.trackletid_to_landmark) == 2
    assert np.array_equal(jm.mp_best_obj, tm.mp_best_obj) and tmgr.store.fix_scale[:2].all()
    assert tmgr.ingest_offline(tm, 0, None, init_to_ground) == []


def test_state_carry_and_reset():
    """ObjectManager.load_state takes a JAX manager's store, candidates and
    rings (ObjectStore.from_arrays); a detection held twice stays one
    object; reset empties it."""
    (jm, jmgr), (tm, tmgr) = _both(min_owned_points=5, min_shared_promote=5, min_shared_votes=8)
    _sequence(jo, jm, jmgr)
    carried = to.ObjectManager(detector=None)
    carried.load_state(vars(jmgr))
    _same_manager(jmgr, carried)
    assert carried.min_shared_votes == 8 and carried.meas[0].maxlen == jmgr.meas[0].maxlen
    shared = jmgr.meas[0][0]
    jmgr.detections.append(shared)
    again = to.ObjectManager(detector=None)
    again.load_state(vars(jmgr))
    assert again.detections[-1] is again.meas[0][0] and isinstance(again.detections[-1], to.Detection)
    st = to.ObjectStore.from_arrays(vars(jmgr.store))
    assert st.max_obj == 16 and np.array_equal(st.pose, jmgr.store.pose) and st.pose is not jmgr.store.pose
    with pytest.raises(ValueError):
        to.ObjectStore.from_arrays(dict(vars(jmgr.store), scale=np.ones((3, 3))))
    carried.reset()
    assert not carried.store.valid.any() and not carried.detections and not carried.meas


def test_detect_on_keyframe_with_the_port_detector():
    """A rendered 320x240 keyframe of the room box: the JAX detector and the
    port's on the CPU (roll/pitch sampling, as the tracker builds it) give
    detections with the same owned keypoints, border flag and box; the
    camera-frame cuboid within the detector's vanishing-point tolerance
    (ROADMAP queue 3: the top-1 cuboid agrees to ~4e-6 m; bound 1e-3 m)
    and the quality within 1e-3."""
    import jax.numpy as jnp

    from cube_slam_tpu.models.detector import CuboidDetector as JaxDetector
    from cube_slam_tpu.ops import lsd as jlsd
    from cube_slam_tpu_torch.models.detector import CuboidDetector
    from cube_slam_tpu_torch.utils import synth

    scene = room_scene()
    Twc = synth.camera_path(40, kind="orbit", target=[0.0, 3.2, 0.6])[12]
    gray = np.clip(scene.render(Twc, GATE_A_K, wh=(320, 240)), 0, 255).astype(np.uint8)
    ln, lv = jlsd.detect_lines(jnp.asarray(gray, dtype=jnp.float32), min_length=15.0, max_lines=128)
    lines = np.array(ln)[np.array(lv)]
    boxes = scene.box_bbox_2d(Twc, GATE_A_K, wh=(320, 240))[None, :]
    jm = _map()
    jm.kf_kp_xy[0, :100] = rng(1).uniform([0, 0], [320, 240], (100, 2))
    tm = map_state_from_arrays(vars(jm))
    jd = JaxDetector(whether_sample_cam_roll_pitch=True)
    jd.set_calibration(GATE_A_K)
    td = CuboidDetector(whether_sample_cam_roll_pitch=True, device="cpu")
    td.set_calibration(GATE_A_K)
    a = jo.ObjectManager(jd).detect_on_keyframe(jm, 0, gray, boxes, lines, Twc)
    b = to.ObjectManager(td).detect_on_keyframe(tm, 0, gray, boxes, lines, Twc)
    assert len(a) == len(b) == 1
    x, y = a[0], b[0]
    assert np.array_equal(x.owned_kps, y.owned_kps) and x.at_border == y.at_border and len(y.owned_kps)
    assert np.array_equal(x.bbox, y.bbox)
    np.testing.assert_allclose(y.local_pose, x.local_pose, atol=1e-3)
    np.testing.assert_allclose(y.scale, x.scale, atol=1e-3)
    assert abs(x.quality - y.quality) < 1e-3
    assert to.ObjectManager(td).detect_on_keyframe(tm, 0, gray, None, lines, Twc) == []
