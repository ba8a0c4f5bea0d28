"""Tracking-side steps: projection search, pose tracking, epipolar
triangulation.

PyTorch counterpart of cube_slam_tpu/slam/tracking.py — the device-side
pieces of Tracking.cc's per-frame pipeline over padded tensors:

* `track_pose` — SearchByProjection (ORBmatcher.cc:1373) + PoseOptimization
  (Optimizer.cc:253): project candidate map points, window-match
  descriptors, robust pose LM (both seeds as one batch), inlier
  classification.
* `search_local_points` — frustum/distance/angle culling of the whole map
  (Tracking::SearchLocalPoints, Tracking.cc:2673) fused with the window
  match; with a leading batch dim on the pose and keypoints it is
  `search_local_points_multi`.
* `triangulate_pair` — SearchForTriangulation's epipolar-constrained
  matching (ORBmatcher.cc:679) + triangulation + the acceptance tests of
  LocalMapping::CreateNewMapPoints (LocalMapping.cc:319-653); batched over
  neighbour keyframes it is `triangulate_multi`.
* `step_frame` — the whole per-frame happy path.

The `step.*` profiler spans inside step_frame time the host's queueing of
each stage (no device sync): on the card that is what a frame waits for.

Where the JAX package scatters with duplicate targets (`x.at[idx].set(v)`,
whose CPU run keeps the LAST duplicate), `_scatter_last` keeps the highest
source index explicitly, so the CPU and CUDA runs agree with it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import ba
from ..ops import matching
from ..ops import orb as orb_ops
from ..utils import geometry as geo
from ..utils import profiler
from .initializer import triangulate

SCALE_FACTOR = 1.2
BIG = 10_000


def level_sigma2(level):
    return SCALE_FACTOR ** (2.0 * level.to(torch.float32))


def _project_batch(Tcw, K, pts):
    """pts (..., M, 3) under Tcw (..., 4, 4) -> (uv (..., M, 2), z (..., M))."""
    pc = pts @ Tcw[..., :3, :3].transpose(-1, -2) + Tcw[..., None, :3, 3]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    uv = (pc @ K.T)[..., :2] / zs[..., None]
    return uv, z


def _camera_center(Tcw):
    return -(Tcw[..., :3, :3].transpose(-1, -2) @ Tcw[..., :3, 3:4])[..., 0]


def predicted_level(dist, mp_max_dist, n_levels, mp_level=None):
    """Scale level predicted from the current viewing distance
    (MapPoint::PredictScale, MapPoint.cc:350-365). Points whose scale
    bounds were never set (mp_max_dist at the 1e9 default) fall back to
    their stored octave when `mp_level` is given."""
    ratio = torch.clamp(mp_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / np.log(np.float32(SCALE_FACTOR)))
    lvl = torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)
    if mp_level is not None:
        lvl = torch.where(mp_max_dist < 1e8, lvl, mp_level.to(torch.int32))
    return lvl


def _scatter_last(size, tgt, vals, ok):
    """out[tgt[i]] = vals[i] for ok[i]; where several i share a target the
    highest i wins (the JAX package's CPU scatter order). Others -1."""
    n = tgt.shape[0]
    src = torch.where(ok, torch.arange(n, device=tgt.device), -1)
    tgt = torch.where(ok, tgt.to(torch.int64), size)
    win = torch.full((size + 1,), -1, dtype=torch.int64, device=tgt.device)
    win = win.scatter_reduce(0, tgt, src, reduce="amax", include_self=True)[:size]
    return torch.where(win >= 0, vals[torch.clamp(win, min=0)], -1).to(torch.int32)


def _robust_cost(T, K, pts, uv_meas, sqrt_info, matched):
    uv, _ = _project_batch(T, K, pts)
    r = (uv - uv_meas) * sqrt_info[..., None]
    return torch.sum(ba.robust_rho(torch.sum(r * r, dim=-1)) * matched, dim=-1)


def track_pose(Tcw_pred, K, mp_pos, mp_desc, mp_level, mp_valid,
               kp_xy, kp_desc, kp_level, kp_valid, radius, img_wh,
               mp_max_dist=None, n_levels: int = 8, Tcw_alt=None):
    """Project candidates with the predicted pose, window-match, optimize.

    With `Tcw_alt` (the last pose: the zero-velocity hypothesis) the pose
    LM runs from both seeds as one batch and keeps the higher-inlier /
    lower-cost solution (tracking.py explains the planar two-fold
    ambiguity this guards against).

    Returns (Tcw, mp_to_kp (M,) int32 inliers, inlier (M,), n_inlier,
    raw mp_to_kp)."""
    uv, z = _project_batch(Tcw_pred, K, mp_pos)
    in_img = ((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
              & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1]))
    cand = mp_valid & in_img
    if mp_max_dist is not None:
        dist = torch.linalg.norm(mp_pos - _camera_center(Tcw_pred), dim=1)
        lvl = predicted_level(dist, mp_max_dist, n_levels, mp_level)
    else:
        lvl = mp_level
    r = radius * SCALE_FACTOR ** lvl.to(torch.float32)
    d = matching.hamming_matrix(mp_desc, kp_desc, cand, kp_valid)
    wm = matching.window_mask(uv, kp_xy, r, lvl, kp_level, level_slack=1)
    d = torch.where(wm, d, matching.BIG)
    mp_to_kp, _ = matching.match_mutual_ratio(d, max_dist=matching.TH_HIGH, ratio=0.9, mutual=False)
    matched = mp_to_kp >= 0

    kp_sel = torch.clamp(mp_to_kp, min=0).to(torch.int64)
    uv_meas = kp_xy[kp_sel]
    sqrt_info = 1.0 / torch.sqrt(level_sigma2(kp_level[kp_sel]))
    if Tcw_alt is None:
        Tcw, inlier, n_in = ba.pose_optimization(Tcw_pred, K, mp_pos, uv_meas, sqrt_info, matched)
    else:
        seeds = torch.stack([Tcw_pred, Tcw_alt])
        Tcws, inls, nins = ba.pose_optimization(seeds, K, mp_pos, uv_meas, sqrt_info, matched)
        costs = _robust_cost(Tcws, K, mp_pos, uv_meas, sqrt_info, matched)
        # inlier count dominates; robust cost breaks ties
        pick = torch.argmax(nins.to(torch.float32) - costs / (torch.amax(costs) + 1.0))
        Tcw, inlier, n_in = Tcws[pick], inls[pick], nins[pick]
    return Tcw, torch.where(inlier, mp_to_kp, -1), inlier, n_in, mp_to_kp


def search_local_points(Tcw, K, mp_pos, mp_desc, mp_level, mp_valid, mp_normal,
                        mp_min_dist, mp_max_dist, kp_xy, kp_desc, kp_level, kp_valid,
                        kp_taken, img_wh, radius, n_levels: int = 8):
    """Frustum-culled whole-map projection search (SearchLocalPoints +
    SearchByProjection frame variant). kp_taken marks keypoints already
    matched. Returns (mp_to_kp (M,), visible (M,)). A leading batch dim on
    Tcw and the kp_* tensors searches several keyframes at once."""
    uv, z = _project_batch(Tcw, K, mp_pos)
    view = mp_pos - _camera_center(Tcw)[..., None, :]
    dist = torch.linalg.norm(view, dim=-1)
    viewcos = torch.sum(view * mp_normal, dim=-1) / torch.where(dist > 1e-9, dist, 1.0)
    visible = (mp_valid & (z > 0)
               & (uv[..., 0] >= 0) & (uv[..., 0] < img_wh[0])
               & (uv[..., 1] >= 0) & (uv[..., 1] < img_wh[1])
               & (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist)
               & (viewcos > 0.5))  # 60 deg (Frame::isInFrustum)
    d = matching.hamming_matrix(mp_desc, kp_desc, visible, kp_valid & (~kp_taken))
    lvl = predicted_level(dist, mp_max_dist, n_levels, mp_level)
    r = radius * SCALE_FACTOR ** lvl.to(torch.float32)
    wm = matching.window_mask(uv, kp_xy, r, lvl, kp_level, level_slack=1)
    d = torch.where(wm, d, matching.BIG)
    mp_to_kp, _ = matching.match_mutual_ratio(d, max_dist=matching.TH_HIGH, ratio=0.8, mutual=True)
    return mp_to_kp, visible


def search_local_points_multi(Tcw_stack, K, mp_pos, mp_desc, mp_level, mp_valid,
                              mp_normal, mp_min_dist, mp_max_dist,
                              kp_xy_s, kp_desc_s, kp_level_s, kp_valid_s,
                              kp_taken_s, img_wh, radius, n_levels=8):
    """search_local_points over a stack of target keyframes (the
    SearchInNeighbors fusion projects one candidate set into several)."""
    return search_local_points(Tcw_stack, K, mp_pos, mp_desc, mp_level, mp_valid, mp_normal,
                               mp_min_dist, mp_max_dist, kp_xy_s, kp_desc_s, kp_level_s,
                               kp_valid_s, kp_taken_s, img_wh, radius, n_levels=n_levels)


def track_frame_fused(Tcw_pred, K, cand_ids, cand_valid,
                      mp_pos, mp_desc, mp_level, mp_valid, mp_normal, mp_min_dist, mp_max_dist,
                      kp_xy, kp_desc, kp_level, kp_valid,
                      radius_motion, radius_local, img_wh, n_levels: int = 8, Tcw_alt=None):
    """The happy path of Tracking::Track's per-frame pipeline: motion-model
    candidate tracking (both window passes), local-map projection search
    and the final pose optimization, with the keypoint->map-point table
    built on the device.

    Returns (Tcw, kp_mp (N,) int32 global map ids or -1, n_inlier_motion,
    n_inlier_final, visible (M,) bool, raw_match (C,))."""
    N = kp_xy.shape[0]
    M = mp_pos.shape[0]
    cand_ids = cand_ids.to(torch.int64)
    cand = (mp_pos[cand_ids], mp_desc[cand_ids], mp_level[cand_ids])
    cand_max_dist = mp_max_dist[cand_ids]

    with profiler.span("step.motion"):
        Tcw1, mp_to_kp, _, n_in, raw = track_pose(
            Tcw_pred, K, *cand, cand_valid, kp_xy, kp_desc, kp_level, kp_valid, radius_motion,
            img_wh, mp_max_dist=cand_max_dist, n_levels=n_levels, Tcw_alt=Tcw_alt)
        # wide-window retry (TrackWithMotionModel, Tracking.cc:1300-1310); both
        # passes run on every frame, as in the JAX package, and the better wins
        Tcw1w, mp_to_kp_w, _, n_in_w, raw_w = track_pose(
            Tcw_pred, K, *cand, cand_valid, kp_xy, kp_desc, kp_level, kp_valid, 2.0 * radius_motion,
            img_wh, mp_max_dist=cand_max_dist, n_levels=n_levels, Tcw_alt=Tcw_alt)
    use_wide = (n_in < 20) & (n_in_w > n_in)
    Tcw1 = torch.where(use_wide, Tcw1w, Tcw1)
    mp_to_kp = torch.where(use_wide, mp_to_kp_w, mp_to_kp)
    n_in = torch.where(use_wide, n_in_w, n_in)
    raw = torch.where(use_wide, raw_w, raw)

    # kp -> global map id from the motion stage (duplicate targets: last wins)
    m1 = mp_to_kp >= 0
    kp_mp = _scatter_last(N, mp_to_kp, cand_ids.to(torch.int32), m1)

    with profiler.span("step.local_search"):
        mp_to_kp2, visible = search_local_points(
            Tcw1, K, mp_pos, mp_desc, mp_level, mp_valid, mp_normal, mp_min_dist, mp_max_dist,
            kp_xy, kp_desc, kp_level, kp_valid, kp_mp >= 0, img_wh, radius_local, n_levels=n_levels)
    m2 = mp_to_kp2 >= 0
    kp_mp2 = _scatter_last(N, mp_to_kp2, torch.arange(M, dtype=torch.int32, device=kp_mp.device), m2)
    # the local search skips taken keypoints, so the two tables are disjoint
    kp_mp = torch.where(kp_mp2 >= 0, kp_mp2, kp_mp)

    # final pose optimization over every associated keypoint
    assoc = (kp_mp >= 0) & kp_valid
    pts = mp_pos[torch.clamp(kp_mp, min=0).to(torch.int64)]
    si = 1.0 / (SCALE_FACTOR ** kp_level.to(torch.float32))
    with profiler.span("step.final_pose"):
        Tcw_f, inl_f, n_in2 = ba.pose_optimization(Tcw1, K, pts, kp_xy, si, assoc)
    kp_mp = torch.where(assoc & ~inl_f, -1, kp_mp)
    return Tcw_f, kp_mp, n_in, n_in2, visible, raw


def step_frame(gray, last_Tcw, velocity, last_kp_mp,
               mp_pos, mp_desc, mp_level, mp_valid, mp_normal, mp_min_dist, mp_max_dist,
               vis_acc, found_acc, K, img_wh, suppress=None, orb_cfg=None,
               radius_motion: float = 15.0, radius_local: float = 6.0,
               min_track: int = 10, min_local: int = 20, n_cand: int = 1024):
    """The entire per-frame happy path: ORB pyramid extraction ->
    motion-model candidate selection from the previous frame's associations
    (ranked by found/visible, top-n_cand) -> track_frame_fused -> velocity
    update -> visibility/found counter accumulation (Tracking::Track,
    Tracking.cc:480-780, restructured).

    `suppress`: an optional (H, W) mask; keypoints where it is >= 0.5 are
    dropped (dynamic-object masks).

    Returns (small, new_state, feats, counters, rescue):
      small     (20,) float32: [Tcw_f(16), n_in, n_in2, ok, n_valid_kps]
      new_state (last_Tcw, velocity, kp_mp) — feed back next frame
      feats     dict with xy/level/angle/desc/valid/packed
      counters  (vis_acc, found_acc) — feed back next frame
      rescue    (cand_ids, raw_match) for the host PnP rescue path
    """
    gray = gray.to(torch.float32)
    with profiler.span("step.orb"):
        feats = orb_ops.extract_orb(gray, orb_cfg)
    kp_xy, kp_desc = feats["xy"], feats["desc"]
    kp_level, kp_valid = feats["level"], feats["valid"]
    if suppress is not None:
        H, W = gray.shape
        xi = torch.clamp(kp_xy[:, 0].to(torch.int64), 0, W - 1)
        yi = torch.clamp(kp_xy[:, 1].to(torch.int64), 0, H - 1)
        kp_valid = kp_valid & (suppress[yi, xi] < 0.5)
        feats = dict(feats, valid=kp_valid)
    feats["packed"] = orb_ops.pack_features(feats["xy"], feats["level"], feats["angle"], kp_valid,
                                            kp_desc)

    M = mp_pos.shape[0]
    dev = mp_pos.device
    Tcw_pred = velocity @ last_Tcw

    # candidate set: map points associated in the last frame, ranked by
    # found/visible, top-n_cand; the whole map when the last frame gave
    # fewer than max(min_track, 50) (the candidate-starvation guard)
    seen = torch.zeros((M + 1,), dtype=torch.bool, device=dev)
    seen[torch.where(last_kp_mp >= 0, last_kp_mp, M).to(torch.int64)] = True
    cand_mask = seen[:M] & mp_valid
    enough = torch.sum(cand_mask) >= max(min_track, 50)
    cand_mask = torch.where(enough, cand_mask, mp_valid)
    score = found_acc.to(torch.float32) / torch.clamp(vis_acc.to(torch.float32), min=1.0)
    score = torch.where(cand_mask, score + 1.0, -1.0)
    _, cand_ids = orb_ops.top_k_stable(score, n_cand)
    cand_valid = cand_mask[cand_ids]

    Tcw_f, kp_mp, n_in, n_in2, visible, raw = track_frame_fused(
        Tcw_pred, K, cand_ids, cand_valid, mp_pos, mp_desc, mp_level, mp_valid, mp_normal,
        mp_min_dist, mp_max_dist, kp_xy, kp_desc, kp_level, kp_valid,
        radius_motion, radius_local, img_wh, n_levels=orb_cfg.n_levels, Tcw_alt=last_Tcw)

    # acceptance (Tracking::Track, :560-640): the final count decides; a
    # weak motion stage passes only when the final stage is decisively
    # healthy (>= 3x min_local)
    ok = (n_in2 >= min_local) & ((n_in >= min_track) | (n_in2 >= 3 * min_local))

    # counters advance only on a successful track
    vis_acc = vis_acc + (visible & ok).to(torch.int32)
    ftgt = torch.where((kp_mp >= 0) & ok, kp_mp, M).to(torch.int64)
    fnd = torch.zeros((M + 1,), dtype=torch.int32, device=dev)
    fnd.index_add_(0, ftgt, torch.ones_like(ftgt, dtype=torch.int32))
    found_acc = found_acc + fnd[:M]

    kp_mp_out = torch.where(ok, kp_mp, -1)
    new_last_Tcw = torch.where(ok, Tcw_f, last_Tcw)
    # motion-model update with a scale-free translation growth clamp (3x
    # the previous speed, only when the previous velocity is real)
    vel_raw = Tcw_f @ geo.inv_T(last_Tcw)
    prev_n = torch.linalg.norm(velocity[:3, 3])
    new_n = torch.linalg.norm(vel_raw[:3, 3])
    cap = 3.0 * prev_n
    clamp = (prev_n > 1e-6) & (new_n > cap)
    tscale = torch.where(clamp, cap / torch.clamp(new_n, min=1e-12), 1.0)
    scale_col = torch.ones((4, 4), dtype=vel_raw.dtype, device=dev)
    scale_col[:3, 3] = 0.0
    vel_raw = vel_raw * (scale_col + (1.0 - scale_col) * tscale)
    new_velocity = torch.where(ok, vel_raw, velocity)

    small = torch.cat([
        Tcw_f.reshape(-1),
        torch.stack([n_in.to(torch.float32), n_in2.to(torch.float32), ok.to(torch.float32),
                     torch.sum(kp_valid).to(torch.float32)]),
    ])
    return (small, (new_last_Tcw, new_velocity, kp_mp_out), feats,
            (vis_acc, found_acc), (cand_ids, raw))


def triangulate_pair(Tcw1, Tcw2, K, kp1_xy, kp1_desc, kp1_level, kp1_free,
                     kp2_xy, kp2_desc, kp2_level, kp2_free, kp1_angle=None, kp2_angle=None):
    """Epipolar-constrained matching + triangulation between keyframe 1 and
    keyframe 2 — or a leading batch of keyframes 2 (Tcw2 (B, 4, 4), kp2_*
    (B, N2, ...)).

    Returns (pts3d (..., N1, 3) in world, kp2_idx (..., N1), ok (..., N1))."""
    # fundamental matrix from relative pose (LocalMapping::ComputeF12)
    T12 = Tcw1 @ geo.inv_T(Tcw2)
    R12 = T12[..., :3, :3]
    t12 = T12[..., :3, 3]
    E = geo.hat(t12) @ R12
    Kinv = torch.linalg.inv(K)
    F12 = Kinv.T @ E @ Kinv  # x1^T F12 x2 = 0

    d = matching.hamming_matrix(kp1_desc, kp2_desc, kp1_free, kp2_free)
    ph1 = torch.cat([kp1_xy, torch.ones_like(kp1_xy[:, :1])], dim=1)
    ph2 = torch.cat([kp2_xy, torch.ones_like(kp2_xy[..., :1])], dim=-1)
    lines2 = ph1 @ F12                                  # (..., N1, 3) lines in image 2
    num = torch.abs(lines2 @ ph2.transpose(-1, -2))     # (..., N1, N2)
    den = torch.sqrt(lines2[..., 0:1] ** 2 + lines2[..., 1:2] ** 2)
    ep_dist2 = (num / torch.where(den > 1e-9, den, 1e-9)) ** 2
    sig2 = level_sigma2(kp2_level)[..., None, :]
    ok_ep = ep_dist2 < 3.84 * sig2
    # near-epipole exclusion (SearchForTriangulation, ORBmatcher.cc:716-725)
    o1 = _camera_center(Tcw1)
    e2c = (Tcw2[..., :3, :3] @ o1[:, None])[..., 0] + Tcw2[..., :3, 3]
    e2z = torch.where(torch.abs(e2c[..., 2]) < 1e-9, 1e-9, e2c[..., 2])
    e2 = (e2c @ K.T)[..., :2] / e2z[..., None]
    d_ep2 = torch.sum((kp2_xy - e2[..., None, :]) ** 2, dim=-1)
    far_from_epipole = ((d_ep2 >= 100.0 * SCALE_FACTOR ** kp2_level.to(torch.float32))
                        | (e2c[..., 2:3] <= 0))
    ok_ep = ok_ep & far_from_epipole[..., None, :]
    d = torch.where(ok_ep, d, matching.BIG)
    # ratio 0.8: the dense-matching stand-in for the BoW-node gate
    m12, _ = matching.match_mutual_ratio(d, max_dist=matching.TH_LOW, ratio=0.8, mutual=True)
    if kp1_angle is not None and kp2_angle is not None:
        m12 = matching.rotation_consistency(kp1_angle, kp2_angle, m12)
    matched = m12 >= 0

    kp2_sel = torch.clamp(m12, min=0).to(torch.int64)
    p2 = torch.gather(kp2_xy, -2, kp2_sel[..., None].expand(kp2_sel.shape + (2,)))
    lvl2 = torch.gather(kp2_level, -1, kp2_sel)
    P1 = K @ Tcw1[:3, :]
    P2 = K @ Tcw2[..., :3, :]
    X = triangulate(P1, P2, kp1_xy, p2)  # (..., N1, 3) world

    # acceptance checks (CreateNewMapPoints, LocalMapping.cc:430-640)
    def depth_of(Tcw, X):
        return (X @ Tcw[..., :3, :3].transpose(-1, -2) + Tcw[..., None, :3, 3])[..., 2]

    z1 = depth_of(Tcw1, X)
    z2 = depth_of(Tcw2, X)
    v1 = X - o1
    v2 = X - _camera_center(Tcw2)[..., None, :]
    n1 = torch.linalg.norm(v1, dim=-1)
    n2 = torch.linalg.norm(v2, dim=-1)
    cos_par = torch.sum(v1 * v2, dim=-1) / torch.where(n1 * n2 > 1e-12, n1 * n2, 1e-12)

    uv1, _ = _project_batch(Tcw1, K, X)
    uv2, _ = _project_batch(Tcw2, K, X)
    e1 = torch.sum((uv1 - kp1_xy) ** 2, dim=-1)
    e2 = torch.sum((uv2 - p2) ** 2, dim=-1)
    s1 = level_sigma2(kp1_level)
    s2 = level_sigma2(lvl2)

    # scale consistency (LocalMapping.cc:601-614)
    ratio_dist = n2 / torch.where(n1 > 1e-12, n1, 1e-12)
    ratio_octave = (SCALE_FACTOR ** kp1_level.to(torch.float32)
                    / SCALE_FACTOR ** lvl2.to(torch.float32))
    ratio_factor = 1.5 * SCALE_FACTOR
    ok_scale = (ratio_dist * ratio_factor >= ratio_octave) & (ratio_dist <= ratio_octave * ratio_factor)

    ok = (matched & (z1 > 0) & (z2 > 0) & (cos_par < 0.9998)
          & (e1 < 5.991 * s1) & (e2 < 5.991 * s2) & ok_scale
          & torch.isfinite(X).all(dim=-1))
    return X, m12, ok


def triangulate_multi(Tcw1, Tcw2_stack, K, kp1_xy, kp1_desc, kp1_level, kp1_free,
                      kp2_xy_s, kp2_desc_s, kp2_level_s, kp2_free_s,
                      kp1_angle=None, kp2_angle_s=None):
    """triangulate_pair over a stack of neighbour keyframes — every
    triangulation baseline of a new keyframe at once. Pad unused neighbour
    slots with all-False kp2_free masks."""
    return triangulate_pair(Tcw1, Tcw2_stack, K, kp1_xy, kp1_desc, kp1_level, kp1_free,
                            kp2_xy_s, kp2_desc_s, kp2_level_s, kp2_free_s,
                            kp1_angle=kp1_angle, kp2_angle=kp2_angle_s)


def evaluate_ate_scaled(est_Twc, truth_Twc):
    """Mono ATE with Sim3 (Umeyama) alignment — scale is unobservable in
    pure monocular SLAM."""
    x = est_Twc[:, :3, 3]
    y = truth_Twc[:, :3, 3]
    mx = x.mean(axis=0)
    my = y.mean(axis=0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc * xc).sum() / len(x)
    s = np.trace(np.diag(D) @ S) / var_x if var_x > 0 else 1.0
    t = my - s * R @ mx
    aligned = (s * (R @ x.T)).T + t
    d = aligned - y
    return float(np.sqrt((d * d).sum(axis=1).mean()))
