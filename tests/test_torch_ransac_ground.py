"""cube_slam_tpu_torch's plane RANSAC (ops/ransac.py), ground-scale recovery
(slam/ground.py), ray-cuboid depth (slam/kitti.py) and the tracker's
relative-trajectory rescale against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import rng

from cube_slam_tpu.ops import ransac as jr
from cube_slam_tpu.slam import ground as jg
from cube_slam_tpu.slam import kitti as jk
from cube_slam_tpu.slam import system as jsys
from cube_slam_tpu.slam.state import MapState as JaxMapState
from cube_slam_tpu_torch.ops import ransac as tr
from cube_slam_tpu_torch.slam import ground as tg
from cube_slam_tpu_torch.slam import kitti as tk
from cube_slam_tpu_torch.slam import system as tsys
from cube_slam_tpu_torch.slam.state import map_state_from_arrays


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("n_valid", [0, 2, 3, 40, 256])
def test_triplet_indices_bit_identical(seed, n_valid):
    valid = np.zeros(256, bool)
    valid[rng(seed).choice(256, n_valid, replace=False)] = True
    a = jr.make_triplet_indices(valid, n_hyp=64, seed=seed)
    b = tr.make_triplet_indices(valid, n_hyp=64, seed=seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _scene_points(seed):
    """Camera-frame points: a floor 1.4 m below (normal -y), a larger wall
    3 m ahead, a box top 0.9 m below, and clutter; 256 rows, 230 valid."""
    r = rng(seed)
    floor = np.stack([r.uniform(-2, 2, 90), 1.4 + r.normal(0, 0.01, 90), r.uniform(1, 5, 90)], 1)
    wall = np.stack([r.uniform(-2, 2, 100), r.uniform(-1, 1.4, 100), 3.0 + r.normal(0, 0.01, 100)], 1)
    top = np.stack([r.uniform(-0.3, 0.3, 30), 0.9 + r.normal(0, 0.01, 30), r.uniform(2, 2.6, 30)], 1)
    clutter = r.uniform(-2, 3, (36, 3))
    pts = np.concatenate([floor, wall, top, clutter]).astype(np.float32)
    valid = np.ones(256, bool)
    valid[230:] = False
    return pts, valid


CASES = {
    "no gate": dict(),
    "normal gate": dict(expected_normal=(0.0, -1.0, 0.0), min_normal_cos=float(np.cos(np.deg2rad(10.0)))),
    "prefer farthest": dict(expected_normal=(0.0, -1.0, 0.0), min_normal_cos=float(np.cos(np.deg2rad(10.0))),
                            prefer_farthest=True),
}


def _fit_both(pts, valid, samples, thresh, kw):
    jkw = dict(kw)
    if "expected_normal" in jkw:
        jkw["expected_normal"] = jnp.asarray(jkw["expected_normal"], dtype=jnp.float32)
        jkw["min_normal_cos"] = jnp.float32(jkw["min_normal_cos"])
    j = jr.fit_plane_ransac(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(samples), jnp.float32(thresh), **jkw)
    tkw = dict(kw)
    if "expected_normal" in tkw:
        tkw["expected_normal"] = torch.tensor(tkw["expected_normal"], dtype=torch.float32)
        tkw["min_normal_cos"] = float(np.float32(tkw["min_normal_cos"]))
    t = tr.fit_plane_ransac(torch.as_tensor(pts), torch.as_tensor(valid), torch.as_tensor(samples), thresh, **tkw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [1, 2])
def test_fit_plane_ransac_matches_jax(case, seed):
    """Same inlier mask and count; the plane [n, d] within 1e-4 up to one
    common sign (the smallest eigenvector's sign is a convention: the SVD
    of JAX's LAPACK and the port's eigh may return either)."""
    pts, valid = _scene_points(seed)
    samples = tr.make_triplet_indices(valid, n_hyp=256, seed=seed)
    (jp, jin, jn), (tp, tin, tn) = _fit_both(pts, valid, samples, 0.05, CASES[case])
    assert int(jn) == int(tn) and np.array_equal(jin, tin)
    sign = 1.0 if np.dot(jp[:3], tp[:3]) >= 0 else -1.0
    np.testing.assert_allclose(tp, sign * jp, atol=1e-4)
    assert np.abs(tp[:3]).argmax() == np.abs(jp[:3]).argmax() and tp[np.abs(tp[:3]).argmax()] > 0
    if case != "no gate":  # the gate keeps the fit off the wall
        assert abs(tp[1]) > 0.98
    if case == "prefer farthest":  # the floor (1.4 m), not the box top (0.9 m)
        assert abs(tp[3]) > 1.2


def test_fit_plane_ransac_ties_go_to_the_first_hypothesis():
    """Two planes with equal inlier counts: both packages take the first
    hypothesis (argmax's first maximal index)."""
    r = rng(5)
    a = np.stack([r.uniform(-1, 1, 20), r.uniform(-1, 1, 20), np.zeros(20)], 1)
    b = np.stack([r.uniform(-1, 1, 20), r.uniform(-1, 1, 20), np.full(20, 5.0)], 1)
    pts = np.concatenate([a, b]).astype(np.float32)
    valid = np.ones(40, bool)
    for first, other in (((20, 21, 22), (0, 1, 2)), ((0, 1, 2), (20, 21, 22))):
        samples = np.array([first, other] * 4, dtype=np.int32)
        (jp, jin, jn), (tp, tin, tn) = _fit_both(pts, valid, samples, 0.05, {})
        assert int(jn) == int(tn) == 20 and np.array_equal(jin, tin)
        assert np.array_equal(tin, np.arange(40) >= 20) == (first[0] == 20)
        np.testing.assert_allclose(abs(tp[3]), abs(jp[3]), atol=1e-5)


def _ground_map(seed):
    """A JAX MapState with one keyframe 1.6 m above a textured floor, looking
    along +y with a 10 degree downward pitch, its lower-image keypoints on
    floor points; a second keyframe 0.5 m to the side."""
    r = rng(seed)
    K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]])
    m = JaxMapState(max_kf=4, max_mp=256, n_kp=200)
    pitch = np.deg2rad(10.0)
    Rwc = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], float) @ np.array(
        [[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)], [0, np.sin(pitch), np.cos(pitch)]])
    for k, x in enumerate((0.0, 0.5)):
        Twc = np.eye(4)
        Twc[:3, :3], Twc[:3, 3] = Rwc, [x, 0.0, 1.6]
        m.kf_tcw[k] = np.linalg.inv(Twc).astype(np.float32)
        m.kf_valid[k] = True
        m.kf_frame_id[k] = 10 * k
    n = 150
    pw = np.stack([r.uniform(-1.5, 1.5, n), r.uniform(2.0, 6.0, n), r.normal(0, 0.005, n)], 1)
    pw[120:, 2] += r.uniform(0.3, 1.0, 30)  # object-like clutter
    m.mp_pos[:n] = pw
    m.mp_valid[:n] = True
    m.mp_min_dist[:n], m.mp_max_dist[:n] = 0.5, 9.0
    pc = pw @ m.kf_tcw[0][:3, :3].T + m.kf_tcw[0][:3, 3]
    uv = (pc @ K.T)[:, :2] / pc[:, 2:3]
    m.kf_kp_xy[0, :n] = uv
    m.kf_kp_valid[0, :n] = True
    m.kf_kp_mp[0, :n] = np.arange(n)
    m.mp_best_obj[125:130] = 0  # object-owned points never vote
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_measure_height_and_try_recover_match_jax(seed):
    """measure_height within 1e-4 m (and near the true 1.6 m); try_recover's
    cadence, low-pass and returned scales within 1e-4 relative, with and
    without the world-z gate; the same candidate points."""
    jm = _ground_map(seed)
    tm = map_state_from_arrays(vars(jm))
    cfg = dict(nominal_height=1.7, every_kfs=2, min_points=12, inlier_thresh=0.05)
    je = jg.GroundScaleEstimator(jg.GroundConfig(**cfg))
    te = tg.GroundScaleEstimator(tg.GroundConfig(**cfg), device="cpu")
    n_cam = tuple(jm.kf_tcw[0, :3, :3].astype(np.float64) @ np.array([0.0, 0.0, 1.0]))
    assert np.array_equal(je.candidate_points(jm, 0, (320, 240)), te.candidate_points(tm, 0, (320, 240)))
    for kw in (dict(), dict(min_inlier_frac=0.5), dict(max_world_z=0.2)):
        hj = je.measure_height(jm, 0, (320, 240), cam_ground_normal=n_cam, seed=seed, **kw)
        ht = te.measure_height(tm, 0, (320, 240), cam_ground_normal=n_cam, seed=seed, **kw)
        assert hj is not None and ht is not None
        assert abs(ht - hj) < 1e-4 and abs(ht - 1.6) < 0.05
    for step in range(4):
        sj = je.try_recover(jm, 0, (320, 240), cam_ground_normal=n_cam, seed=step)
        st = te.try_recover(tm, 0, (320, 240), cam_ground_normal=n_cam, seed=step)
        assert (sj is None) == (st is None) == (step % 2 == 0)
        if sj is not None:
            assert abs(st - sj) < 1e-4 * sj
    assert abs(te.filtered_height - je.filtered_height) < 1e-4
    # too few candidates: both give up
    assert te.measure_height(tm, 1, (320, 240), cam_ground_normal=n_cam) is None
    assert je.measure_height(jm, 1, (320, 240), cam_ground_normal=n_cam) is None


@pytest.mark.parametrize("about", [None, (0.2, 1.0, 0.0)])
def test_apply_scale_matches_jax(about):
    jm = _ground_map(2)
    tm = map_state_from_arrays(vars(jm))
    jg.GroundScaleEstimator.apply_scale(jm, 1, 1.37, about=about)
    tg.GroundScaleEstimator.apply_scale(tm, 1, 1.37, about=about)
    for name in ("mp_pos", "kf_tcw", "mp_min_dist", "mp_max_dist"):
        assert np.array_equal(getattr(tm, name), getattr(jm, name)), name


def test_ray_cuboid_depth_matches_jax():
    """Hits, misses and rays starting inside the cuboid: the same numpy in
    both packages, so the depths are equal."""
    r = rng(7)
    K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]])
    xy = np.concatenate([r.uniform(0, 320, (60, 1)), r.uniform(0, 240, (60, 1))], 1)
    for pose_t, yaw in (((0.1, -0.2, 3.0), 0.4), ((0.0, 0.0, 0.3), 0.0), ((5.0, 0.0, 2.0), 1.0)):
        P = np.eye(4)
        P[:3, :3] = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        P[:3, 3] = pose_t
        a = jk._ray_cuboid_depth(K, xy, P.astype(np.float32), np.array([0.6, 0.4, 0.45]))
        b = tk._ray_cuboid_depth(K, xy, P.astype(np.float32), np.array([0.6, 0.4, 0.45]))
        assert np.array_equal(a, b)
    assert tk._ray_cuboid_depth(K, np.zeros((0, 2)), np.eye(4), np.ones(3)).shape == (0,)
    hit = tk._ray_cuboid_depth(K, np.array([[160.0, 120.0]]), np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 3.0], [0, 0, 0, 1]]), np.array([0.5, 0.5, 0.5]))
    assert abs(float(hit[0]) - 2.5) < 1e-6


def test_rescale_traj_rel_matches_jax():
    """MonocularTracker._rescale_traj_rel: relative poses with a reference
    keyframe scale their translation; absolute entries (ref -1) stay."""
    r = rng(9)
    traj = []
    for fid in range(8):
        T = np.eye(4)
        T[:3, 3] = r.normal(size=3)
        traj.append((fid, -1 if fid < 2 else fid // 3, -1 if fid < 2 else 10 * (fid // 3), T))

    class Holder:
        pass

    j, t = Holder(), Holder()
    j._traj_rel = [(f, a, b, T.copy()) for f, a, b, T in traj]
    t._traj_rel = [(f, a, b, T.copy()) for f, a, b, T in traj]
    jsys.MonocularTracker._rescale_traj_rel(j, 0.731)
    tsys.MonocularTracker._rescale_traj_rel(t, 0.731)
    for (fa, ra, rfa, Ta), (fb, rb, rfb, Tb), (_, r0, _, T0) in zip(j._traj_rel, t._traj_rel, traj):
        assert (fa, ra, rfa) == (fb, rb, rfb) and np.array_equal(Ta, Tb)
        assert np.array_equal(Tb[:3, :3], T0[:3, :3])
        assert np.array_equal(Tb[:3, 3], T0[:3, 3] * (0.731 if r0 >= 0 else 1.0))
