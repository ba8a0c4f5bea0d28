"""cube_slam_tpu_torch slam/tracking.py against the JAX package, on a map
carried across from a JAX run of the tracker gate's sequence (Gate A,
tests/torch_parity_utils.py): the JAX tracker runs frames 0-9, its map and
tracker state go into the port (state.map_state_from_arrays), and each step
of frame 10 runs through both packages on identical inputs."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import (GATE_A_CONFIG, GATE_A_K, assert_close, carry_tracker,
                                gate_a_sequence, sync_fold_jax_tracker, to_np)

from cube_slam_tpu.ops import orb as jorb
from cube_slam_tpu.slam import tracking as jt
from cube_slam_tpu_torch.slam import tracking as tt

WH = np.array([320, 240], np.float32)
MAP_FIELDS = ("mp_pos", "mp_desc", "mp_level", "mp_valid", "mp_normal", "mp_min_dist", "mp_max_dist")
POSE_TOL = 1e-4


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.fixture(scope="module")
def gate():
    """The JAX tracker after frames 0-9 (initialized at frame 6, keyframes
    at 6, 8, 9), a numpy snapshot of its state, and the port tracker
    carried from it."""
    frames, poses = gate_a_sequence()
    J = sync_fold_jax_tracker(GATE_A_CONFIG)
    for f in frames[:10]:
        J.track(f)
    assert J.state == "OK" and int(J.map.kf_valid.sum()) == 4
    snap = {k: np.array(getattr(J.map, k)) for k in vars(J.map) if isinstance(getattr(J.map, k), np.ndarray)}
    snap.update(last_Tcw=J.last_Tcw.copy(), velocity=J.velocity.copy(), last_mp=J.last_frame.mp.copy(),
                vis=np.array(J._mirror.vis_acc), found=np.array(J._mirror.found_acc),
                ref_kf=J.ref_kf)
    feats = {k: np.array(v) for k, v in jorb.extract_orb_fused(
        jnp.asarray(frames[10], dtype=jnp.float32), jorb.OrbPyramidConfig(600, n_levels=3)).items()}
    return dict(J=J, P=carry_tracker(J), J9=copy.deepcopy(J), snap=snap, frames=frames, feats=feats)


def _fresh_pair(gate):
    """A JAX tracker in the frame-9 state and the port tracker carried
    from it, for tests that mutate both."""
    J = copy.deepcopy(gate["J9"])
    return J, carry_tracker(J)


def _frame10_features(gate):
    """Frame 10's features (the JAX extraction) as a host FrameFeatures of
    each package."""
    from cube_slam_tpu.slam.state import FrameFeatures as JF
    from cube_slam_tpu_torch.slam.state import FrameFeatures as TF

    f = gate["feats"]
    kw = lambda: {k: f[k].copy() for k in ("xy", "level", "angle", "desc", "valid")}  # noqa: E731
    return JF(**kw()), TF(**kw())


def test_step_frame_on_carried_map(gate):
    """The whole per-frame step of frame 10 (the port extracts its own ORB):
    the same candidate ids (all tied at score 1: the stable top-k), raw and
    final association tables, counters and acceptance; pose within 1e-4
    (measured 3.4e-7)."""
    s = gate["snap"]
    g = gate["frames"][10]
    common = [s["last_Tcw"], s["velocity"], s["last_mp"]] + [s[k] for k in MAP_FIELDS] \
        + [s["vis"], s["found"], GATE_A_K, WH]
    j = jt.step_frame(jnp.asarray(g), *[jnp.asarray(a) for a in common], jnp.zeros((1, 1)),
                      orb_cfg=jorb.OrbPyramidConfig(600, n_levels=3))
    from cube_slam_tpu_torch.ops import orb as torb
    p = tt.step_frame(_t(g), *[_t(a) for a in common], orb_cfg=torb.OrbPyramidConfig(600, n_levels=3))
    sj, sp = np.asarray(j[0]), to_np(p[0])
    assert_close(sp[:16], sj[:16], atol=POSE_TOL, what="Tcw")
    np.testing.assert_array_equal(sp[16:], sj[16:])
    assert sp[18] == 1.0 and sp[17] > 200
    for a, b in zip(j[1][1:], p[1][1:]):
        if a.dtype == jnp.float32:
            assert_close(to_np(b), np.asarray(a), atol=POSE_TOL)
        else:
            np.testing.assert_array_equal(to_np(b), np.asarray(a))
    for a, b in list(zip(j[3], p[3])) + list(zip(j[4], p[4])):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))


def _frame_inputs(gate):
    s, f = gate["snap"], gate["feats"]
    kp = (f["xy"], f["desc"], f["level"], f["valid"])
    Tcw_pred = (s["velocity"] @ s["last_Tcw"]).astype(np.float32)
    return s, kp, Tcw_pred


@pytest.mark.parametrize("two_seeds", [True, False])
def test_track_pose(gate, two_seeds):
    """track_pose on frame 10's features (the same for both) against the
    last frame's candidates: identical raw and inlier tables, pose within
    1e-4 (measured 5.9e-5 from two seeds, 2.8e-7 from one: 40 LM steps
    with accept/reject carry the last-bit differences of the sums)."""
    s, kp, Tcw_pred = _frame_inputs(gate)
    ids = np.unique(s["last_mp"][s["last_mp"] >= 0])
    cand = (s["mp_pos"][ids], s["mp_desc"][ids], s["mp_level"][ids], s["mp_valid"][ids])
    args = (Tcw_pred, GATE_A_K) + cand + kp
    alt = s["last_Tcw"] if two_seeds else None
    j = jt.track_pose(*[jnp.asarray(a) for a in args], jnp.float32(15.0), jnp.asarray(WH),
                      mp_max_dist=jnp.asarray(s["mp_max_dist"][ids]), n_levels=3,
                      Tcw_alt=None if alt is None else jnp.asarray(alt))
    p = tt.track_pose(*[_t(a) for a in args], 15.0, _t(WH), mp_max_dist=_t(s["mp_max_dist"][ids]),
                      n_levels=3, Tcw_alt=None if alt is None else _t(alt))
    assert_close(to_np(p[0]), np.asarray(j[0]), atol=POSE_TOL)
    for a, b in zip(j[1:], p[1:]):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))
    assert int(p[3]) > 100


def test_search_local_points(gate):
    s, kp, Tcw_pred = _frame_inputs(gate)
    taken = np.zeros(len(kp[0]), bool)
    taken[::5] = True
    args = (Tcw_pred, GATE_A_K) + tuple(s[k] for k in MAP_FIELDS) + kp + (taken, WH)
    j = jt.search_local_points(*[jnp.asarray(a) for a in args], jnp.float32(6.0), n_levels=3)
    p = tt.search_local_points(*[_t(a) for a in args], 6.0, n_levels=3)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))
    assert (to_np(p[0]) >= 0).sum() > 20


def _neighbors(s):
    """The newest keyframe's covisible neighbours, as the tracker picks
    them for triangulation and fusion."""
    from cube_slam_tpu_torch.slam.state import map_state_from_arrays

    m = map_state_from_arrays({k: s[k] for k in s if k.startswith(("kf_", "mp_"))})
    k = s["ref_kf"]
    counts = m.covisibility_counts(k)
    nbs = [int(i) for i in np.argsort(-counts) if counts[i] >= 10]
    assert len(nbs) >= 2
    return m, k, np.asarray(nbs[:3])


def test_triangulate_multi(gate):
    """Epipolar matching + triangulation of the newest keyframe against its
    neighbours (a leading batch): the same matches and acceptance, points
    within 1e-5 + 1e-4 relative (measured 6.7e-5 on coordinates of 1-6)."""
    m, k, nb = _neighbors(gate["snap"])
    free_k = m.kf_kp_valid[k]
    free_nb = m.kf_kp_valid[nb]
    args = (m.kf_tcw[k], m.kf_tcw[nb], GATE_A_K, m.kf_kp_xy[k], m.kf_kp_desc[k], m.kf_kp_level[k],
            free_k, m.kf_kp_xy[nb], m.kf_kp_desc[nb], m.kf_kp_level[nb], free_nb)
    ang = (m.kf_kp_angle[k], m.kf_kp_angle[nb])
    j = jt.triangulate_multi(*[jnp.asarray(a) for a in args], kp1_angle=jnp.asarray(ang[0]),
                             kp2_angle_s=jnp.asarray(ang[1]))
    p = tt.triangulate_multi(*[_t(a) for a in args], kp1_angle=_t(ang[0]), kp2_angle_s=_t(ang[1]))
    np.testing.assert_array_equal(to_np(p[1]), np.asarray(j[1]))
    np.testing.assert_array_equal(to_np(p[2]), np.asarray(j[2]))
    ok = np.asarray(j[2])
    assert ok.sum() > 50
    assert_close(to_np(p[0])[ok], np.asarray(j[0])[ok], atol=1e-5, rtol=1e-4)
    # one neighbour alone is triangulate_pair
    p1 = tt.triangulate_pair(*[_t(a)[0] if i in (1, 7, 8, 9, 10) else _t(a) for i, a in enumerate(args)],
                             kp1_angle=_t(ang[0]), kp2_angle=_t(ang[1])[0])
    np.testing.assert_array_equal(to_np(p1[1]), to_np(p[1])[0])


def test_search_local_points_multi(gate):
    """Fusion's projection of the newest keyframe's points into its
    neighbours (SearchInNeighbors): identical tables."""
    m, k, nb = _neighbors(gate["snap"])
    ids = np.unique(m.kf_kp_mp[k][m.kf_kp_mp[k] >= 0])[:1024]
    args = (m.kf_tcw[nb], GATE_A_K, m.mp_pos[ids], m.mp_desc[ids], m.mp_level[ids],
            np.ones(len(ids), bool), m.mp_normal[ids], m.mp_min_dist[ids], m.mp_max_dist[ids],
            m.kf_kp_xy[nb], m.kf_kp_desc[nb], m.kf_kp_level[nb], m.kf_kp_valid[nb],
            np.zeros((len(nb), m.n_kp), bool), WH)
    j = jt.search_local_points_multi(*[jnp.asarray(a) for a in args], jnp.float32(2.5), n_levels=3)
    p = tt.search_local_points_multi(*[_t(a) for a in args], 2.5, n_levels=3)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))
    assert (to_np(p[0]) >= 0).sum() > 50


def test_duplicate_scatter_targets():
    """`kp_mp.at[tgt].set(v)` with repeated targets keeps the LAST source in
    the JAX CPU run; the port's explicit rule (highest source index)
    matches it, including the dummy slot for unmatched sources."""
    r = np.random.default_rng(0)
    N, C = 40, 300
    tgt = r.integers(-1, N, C).astype(np.int32)
    vals = r.integers(0, 5000, C).astype(np.int32)
    ok = tgt >= 0
    j = jnp.full((N + 1,), -1, jnp.int32).at[jnp.where(ok, tgt, N)].set(jnp.where(ok, vals, -1))
    j = np.asarray(j.at[N].set(-1))[:N]
    p = tt._scatter_last(N, _t(tgt), _t(vals), _t(ok)).numpy()
    np.testing.assert_array_equal(p, j)
    last = {int(tg): int(v) for tg, v in zip(tgt, vals) if tg >= 0}
    assert all(p[k] == v for k, v in last.items())


def test_track_frame_fused_with_duplicate_candidates(gate):
    """Every candidate appears twice (ids i and i + C), so the motion
    stage's non-mutual matching sends two candidates to each matched
    keypoint: the kp->map table keeps the later one in both packages."""
    s, kp, Tcw_pred = _frame_inputs(gate)
    ids = np.unique(s["last_mp"][s["last_mp"] >= 0])
    M = len(s["mp_valid"])
    dup = {k: s[k].copy() for k in MAP_FIELDS}
    free = np.where(~s["mp_valid"])[0][: len(ids)]
    for k in MAP_FIELDS:
        dup[k][free] = s[k][ids]
    cand = np.concatenate([ids, free]).astype(np.int32)
    cand_pad = np.zeros(1024, np.int32)
    cand_pad[: len(cand)] = cand
    cvalid = np.zeros(1024, bool)
    cvalid[: len(cand)] = True
    args = (Tcw_pred, GATE_A_K, cand_pad, cvalid) + tuple(dup[k] for k in MAP_FIELDS) + kp
    j = jt.track_frame_fused(*[jnp.asarray(a) for a in args], jnp.float32(15.0), jnp.float32(6.0),
                             jnp.asarray(WH), n_levels=3, Tcw_alt=jnp.asarray(s["last_Tcw"]))
    p = tt.track_frame_fused(*[_t(a) for a in args], 15.0, 6.0, _t(WH), n_levels=3,
                             Tcw_alt=_t(s["last_Tcw"]))
    raw = np.asarray(j[5])
    hit = raw[raw >= 0]
    assert len(hit) - len(np.unique(hit)) > 20, "the case must hold duplicate targets"
    assert_close(to_np(p[0]), np.asarray(j[0]), atol=POSE_TOL)
    for a, b in zip(j[1:], p[1:]):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))
    assert M not in to_np(p[1])


def test_levels_and_ate():
    r = np.random.default_rng(1)
    lvl = r.integers(0, 8, 500).astype(np.int32)
    assert_close(to_np(tt.level_sigma2(_t(lvl))), np.asarray(jt.level_sigma2(jnp.asarray(lvl))), atol=0,
                 rtol=1e-6)
    dist = r.uniform(0.5, 8, 500).astype(np.float32)
    maxd = (r.uniform(0.5, 8, 500) * 1.2 ** r.integers(0, 8, 500)).astype(np.float32)
    maxd[::7] = 1e9
    j = np.asarray(jt.predicted_level(jnp.asarray(dist), jnp.asarray(maxd), 8, jnp.asarray(lvl)))
    p = to_np(tt.predicted_level(_t(dist), _t(maxd), 8, _t(lvl)))
    np.testing.assert_array_equal(p, j)
    est = np.tile(np.eye(4), (20, 1, 1))
    est[:, :3, 3] = r.normal(size=(20, 3))
    tru = est.copy()
    tru[:, :3, 3] = 2.0 * est[:, :3, 3] + 0.01 * r.normal(size=(20, 3))
    assert tt.evaluate_ate_scaled(est, tru) == jt.evaluate_ate_scaled(est, tru)


def test_keyframe_step_on_carried_state(gate):
    """Both trackers continue from the carried state through frames 10-13:
    three tracked frames, then a keyframe at 13 (triangulation, fusion,
    culling, local BA). Poses, decisions, association tables, map-point
    slots, descriptors and counters agree exactly up to the BA; the BA's
    six LM iterations move poses by 7.7e-4 and points by 1.8e-3 apart
    (measured; bounds 3e-3 and 1e-2 on a map of 3-6 m depth)."""
    J, P = gate["J"], gate["P"]
    for i in range(10, 14):
        a, b = J.track(gate["frames"][i]), P.track(gate["frames"][i])
        assert (a is None) == (b is None)
        assert J.last_kf_frame_id == P.last_kf_frame_id
        if i < 13:
            assert_close(b, a, atol=1e-5)
    assert J.last_kf_frame_id == 13 and int(P.map.kf_valid.sum()) == 5
    Jm, Pm = J.map, P.map
    for name in ("kf_valid", "kf_kp_mp", "mp_valid", "mp_desc", "mp_level", "mp_nobs",
                 "mp_visible", "mp_found", "mp_birth"):
        np.testing.assert_array_equal(getattr(Pm, name), getattr(Jm, name), err_msg=name)
    assert_close(Pm.kf_tcw, Jm.kf_tcw, atol=3e-3)
    live = Jm.mp_valid
    assert_close(Pm.mp_pos[live], Jm.mp_pos[live], atol=1e-2)
    assert sorted(P.loop_detector.signatures) == sorted(J.loop_detector.signatures)


def test_rescue_chain_on_carried_state(gate):
    """The host rescue chain of the tracker on identical state and
    features: TrackReferenceKeyFrame, PnP on raw window matches, the local
    search after a rescue, and relocalization through the keyframe
    database. The same decisions and tables; poses within 1e-4."""
    J, P = _fresh_pair(gate)
    fj, fp = _frame10_features(gate)
    Tcw_pred = (J.velocity @ J.last_Tcw).astype(np.float32)

    rj = J._track_reference_kf(fj, Tcw_pred)
    rp = P._track_reference_kf(fp, Tcw_pred)
    assert rj[0] and rp[0]
    assert_close(rp[1], np.asarray(rj[1]), atol=POSE_TOL)
    # JAX pads the candidates to 1024 with invalid rows; the port does not
    n = len(rp[3])
    np.testing.assert_array_equal(rp[2], np.asarray(rj[2])[:n])
    assert (np.asarray(rj[2])[n:] == -1).all()
    np.testing.assert_array_equal(rp[3], rj[3][:n])
    assert rp[4] == rj[4]

    # raw motion-window matches of the last frame's points, as step_frame
    # hands them to the PnP rescue
    s, kp, _ = _frame_inputs(gate)
    cand = np.unique(s["last_mp"][s["last_mp"] >= 0]).astype(np.int64)
    raw = np.asarray(jt.track_pose(
        jnp.asarray(Tcw_pred), jnp.asarray(GATE_A_K), *[jnp.asarray(s[k][cand]) for k in MAP_FIELDS[:4]],
        *[jnp.asarray(a) for a in kp], jnp.float32(30.0), jnp.asarray(WH), n_levels=3)[4])
    pj = J._pnp_on_matches(fj, cand, raw)
    pp = P._pnp_on_matches(fp, cand, raw)
    assert pj[0] and pp[0] and pp[3] == pj[3]
    assert_close(pp[1], np.asarray(pj[1]), atol=POSE_TOL)
    np.testing.assert_array_equal(pp[2], np.asarray(pj[2]))

    # the local-map search + final pose LM after the rescue, from JAX's pose
    okj = J._track_local_after_rescue(fj, np.asarray(pj[1]), np.asarray(pj[2]), cand)
    okp = P._track_local_after_rescue(fp, np.asarray(pj[1]), np.asarray(pj[2]), cand)
    assert okj and okp
    np.testing.assert_array_equal(fp.mp, fj.mp)
    assert_close(P.last_Tcw, J.last_Tcw, atol=POSE_TOL)
    assert P.tracked_inliers == J.tracked_inliers
    np.testing.assert_array_equal(P.map.mp_visible, J.map.mp_visible)
    np.testing.assert_array_equal(P.map.mp_found, J.map.mp_found)

    # relocalization: keyframe-database candidates, then PnP-RANSAC
    fj, fp = _frame10_features(gate)
    assert J._relocalize(fj) and P._relocalize(fp)
    np.testing.assert_array_equal(fp.mp, fj.mp)
    assert_close(P.last_Tcw, J.last_Tcw, atol=POSE_TOL)
    assert P.tracked_inliers == J.tracked_inliers


def test_eviction_culling_and_reset_on_carried_state(gate):
    """Keyframe eviction (capacity fallback), keyframe culling and reset
    change both maps the same way."""
    J, P = _fresh_pair(gate)
    assert J._evict_one_kf() and P._evict_one_kf()
    for name in ("kf_valid", "kf_kp_mp", "mp_valid", "mp_nobs"):
        np.testing.assert_array_equal(getattr(P.map, name), getattr(J.map, name), err_msg=name)
    assert sorted(P.loop_detector.signatures) == sorted(J.loop_detector.signatures)
    assert P._cull_keyframes(redundancy=0.3) == J._cull_keyframes(redundancy=0.3)
    np.testing.assert_array_equal(P.map.kf_valid, J.map.kf_valid)
    P.reset()
    J.reset()
    assert P.state == J.state == "NOT_INITIALIZED"
    assert not P.map.kf_valid.any() and not P.map.mp_valid.any() and P._vis_acc is None


def test_global_ba_after_keyframe_step(gate):
    """global_ba over the frame-13 map of both trackers (every keyframe,
    the oldest fixed, the scale gauge free). With one fixed camera the
    map's scale is a free direction that each LM walks along its own way,
    so the two solutions are compared after a similarity alignment of the
    keyframe centres: residual within 3e-3 (measured 8.4e-6; unaligned,
    the poses differ by 6.7e-2)."""
    from cube_slam_tpu_torch.slam.tracking import evaluate_ate_scaled

    J, P = gate["J"], gate["P"]
    assert J.last_kf_frame_id == 13, "runs after test_keyframe_step_on_carried_state"
    J.global_ba()
    P.global_ba()
    kfs = np.where(J.map.kf_valid)[0]
    np.testing.assert_array_equal(P.map.kf_valid, J.map.kf_valid)
    Twc = lambda m: np.stack([np.linalg.inv(m.kf_tcw[k].astype(np.float64)) for k in kfs])  # noqa: E731
    gap = evaluate_ate_scaled(Twc(P.map), Twc(J.map))
    assert gap <= 3e-3, gap
    np.testing.assert_array_equal(P.map.kf_kp_mp, J.map.kf_kp_mp)


def test_map_state_and_keyframe_database_match_jax(gate):
    """MapState's bookkeeping (covisibility, observations, slot allocation,
    replace / erase) and the keyframe database (signatures, loop and
    relocalization candidates) on the carried frame-9 map: identical."""
    from cube_slam_tpu.slam import loop_closing as jlc
    from cube_slam_tpu_torch.slam import loop_closing as tlc

    J, P = _fresh_pair(gate)
    jm, pm = J.map, P.map
    for k in np.where(jm.kf_valid)[0]:
        np.testing.assert_array_equal(pm.covisibility_counts(k), jm.covisibility_counts(k))
    np.testing.assert_array_equal(pm.covisibility_matrix(), jm.covisibility_matrix())
    ids = np.where(jm.mp_valid)[0][::3]
    for a, b in zip(pm.observations_of(ids), jm.observations_of(ids)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pm.alloc_mps(7), jm.alloc_mps(7))
    assert pm.alloc_kf() == jm.alloc_kf()
    live = np.where(jm.mp_valid)[0]
    pm.replace_mp(int(live[3]), int(live[5]))
    jm.replace_mp(int(live[3]), int(live[5]))
    pm.erase_mp(live[10:20])
    jm.erase_mp(live[10:20])
    for name in ("kf_kp_mp", "mp_valid", "mp_nobs", "mp_found", "mp_visible", "mp_birth"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(jm, name), err_msg=name)

    kf = int(J.ref_kf)
    sig_j = jlc.keyframe_signature(jm.kf_kp_desc[kf], jm.kf_kp_valid[kf])
    sig_p = tlc.keyframe_signature(pm.kf_kp_desc[kf], pm.kf_kp_valid[kf])
    np.testing.assert_array_equal(sig_p, sig_j)
    db = np.stack(list(J.loop_detector.signatures.values()))
    np.testing.assert_array_equal(tlc.signature_similarity(sig_p, db), jlc.signature_similarity(sig_j, db))
    f = gate["feats"]
    q = tlc.keyframe_signature(f["desc"], f["valid"])
    covis = lambda k: np.where(jm.covisibility_counts(k) >= 15)[0]  # noqa: E731
    for kw in ({}, dict(covis_groups=covis)):
        assert P.loop_detector.detect_relocalization(q, **kw) == J.loop_detector.detect_relocalization(q, **kw)
    for k in J.loop_detector.signatures:
        cov = [int(i) for i in np.where(jm.covisibility_counts(k) >= 15)[0]]
        assert P.loop_detector.detect(k, cov) == J.loop_detector.detect(k, cov)
