"""Dynamic (moving) object tracking — the KITTI-car pipeline.

PyTorch counterpart of cube_slam_tpu/slam/dynamic.py, the re-design of the
reference's dynamic-object machinery (SURVEY 2.4 "Dynamic-object
tracking"): instance masks flag object pixels (Frame.cc:221-264), Harris
corners inside the mask are tracked by pyramidal KLT
(SearchByTrackingHarris, ORBmatcher.cc:1524-1580), dynamic points are
triangulated with OBJECT-MOTION-COMPENSATED camera poses
(Tracking.cc:2144-2244), and everything is jointly optimized by
graph/dynamic_ba.py (per-keyframe object poses, object-frame points with
in-box priors, planar-bicycle velocity — Optimizer::
LocalBACameraPointObjectsDynamic).

The chain bookkeeping is host numpy, as in the JAX package; KLT, Harris,
the triangulation and the dynamic BA run on the manager's device, and each
frame's forward and backward KLT of a chain come back to the host in one
transfer. Every entry point runs on the card unless given device="cpu".
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..graph.dynamic_ba import dynamic_object_ba
from ..ops import klt
from ..utils import np_geometry as np_geo
from ..utils import profiler
from .initializer import triangulate

logger = logging.getLogger("cube_slam_tpu_torch")


@dataclass
class DynamicTrackResult:
    obj_pose_per_frame: np.ndarray  # (N, 4, 4) optimized object->world
    velocity: np.ndarray            # (2,) [v, steer]
    local_pts: np.ndarray           # (Q, 3) object-frame points
    n_tracked_pts: int
    chi2: float


def _f32(x, device):
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)


def _lk(prev, cur, xy, alive, guess, max_err, device):
    """Forward KLT of one chain's points from `prev` to `cur` (device
    images) seeded with `guess`, on the device. Returns (pts1, status) as
    tensors."""
    init = torch.as_tensor(guess, dtype=torch.float32, device=device).expand(len(xy), 2)
    return klt.pyr_lk(prev, cur, _f32(xy, device), torch.as_tensor(alive, device=device), init_flow=init,
                      max_err=max_err)


def _triangulate(P1, P2, xy1, xy2, device):
    """Two-view DLT (slam/initializer.triangulate) of host projection
    matrices (float64, cast to float32 as the JAX package does) and pixels;
    returns host (N, 3)."""
    return triangulate(_f32(P1, device), _f32(P2, device), _f32(xy1, device), _f32(xy2, device)).cpu().numpy()


def track_dynamic_object(
    frames,          # list of (H, W) grayscale images
    masks,           # list of (H, W) bool instance masks
    cam_tcw,         # (N, 4, 4) camera poses (world->camera)
    stamps,          # (N,) timestamps
    obj_pose_init,   # (N, 4, 4) initial per-frame object poses (detector)
    obj_scale,       # (3,) fixed half-scale (e.g. the KITTI car prior)
    K,
    bboxes=None,     # optional per-frame [x y w h] detections (bbox edges)
    max_pts=64,
    ba_iters=20,
    klt_max_err=45.0,
    motion_weight=1.5,
    device=None,
):
    """Track one moving object through a sequence and jointly optimize its
    per-frame poses, velocity, and surface points (on `device`, the card
    by default)."""
    dev = resolve(device)
    N = len(frames)
    K = np.asarray(K, dtype=np.float32)
    imgs = [_f32(f, dev) for f in frames]

    # --- Harris corners on the object in frame 0 (Tracking.cc:2258-2338);
    # erode the mask so corners sit on the object interior (edge corners
    # mix background and die immediately under KLT)
    xy0, valid0 = klt.harris_corners(imgs[0], max_corners=max_pts, mask=torch.as_tensor(_erode(masks[0]), device=dev))
    xy0 = xy0.cpu().numpy()
    valid0 = valid0.cpu().numpy()

    # --- KLT chains through the sequence (SearchByTrackingHarris)
    tracks = np.zeros((N, max_pts, 2), dtype=np.float32)
    alive = np.zeros((N, max_pts), dtype=bool)
    tracks[0] = xy0
    alive[0] = valid0

    def center_uv(i):
        c = obj_pose_init[i][:3, 3]
        pc = cam_tcw[i][:3, :3] @ c + cam_tcw[i][:3, 3]
        uv = K @ pc
        return uv[:2] / max(uv[2], 1e-6)

    for i in range(1, N):
        # seed KLT with the projected object-center motion
        # (SearchByTracking's motion prediction, ORBmatcher.cc:1582-1620)
        guess = (center_uv(i) - center_uv(i - 1)).astype(np.float32)
        pts1, status = _lk(imgs[i - 1], imgs[i], tracks[i - 1], alive[i - 1], guess, klt_max_err, dev)
        pts1 = pts1.cpu().numpy()
        status = status.cpu().numpy()
        # keep only points still on the object mask
        xi = np.clip(pts1[:, 0].astype(int), 0, masks[i].shape[1] - 1)
        yi = np.clip(pts1[:, 1].astype(int), 0, masks[i].shape[0] - 1)
        status &= masks[i][yi, xi]
        tracks[i] = pts1
        alive[i] = status & alive[i - 1]

    # --- initialize object-frame points by motion-compensated triangulation
    # (Tracking.cc:2144-2244): move camera 1 into the object's frame-0
    # position, then classic two-view triangulation
    j = min(2, N - 1)  # a couple of frames of baseline
    P0_obj = obj_pose_init[0].astype(np.float64)
    Pj_obj = obj_pose_init[j].astype(np.float64)
    # camera j expressed as if the object had not moved:
    comp = P0_obj @ np_geo.inv_T(Pj_obj)  # moves frame-j object back to frame-0
    Tcw_j_comp = cam_tcw[j].astype(np.float64) @ np_geo.inv_T(comp)
    P1 = K.astype(np.float64) @ cam_tcw[0][:3, :].astype(np.float64)
    P2 = K.astype(np.float64) @ Tcw_j_comp[:3, :]
    good = alive[j]
    Xw = _triangulate(P1, P2, tracks[0], tracks[j], dev)
    # world (frame-0 object position) -> object frame
    local = (np_geo.inv_T(P0_obj)[:3, :3] @ Xw.T).T + np_geo.inv_T(P0_obj)[:3, 3]
    # sanity: inside a margin of the box
    inside = (np.abs(local) < 2.0 * np.asarray(obj_scale)).all(axis=1)
    pt_valid = good & inside & np.isfinite(local).all(axis=1)

    # --- dynamic point reprojection edges
    dp_kf, dp_obj, dp_pt, dp_uv = [], [], [], []
    for i in range(N):
        for q in range(max_pts):
            if alive[i][q] and pt_valid[q]:
                dp_kf.append(i)
                dp_obj.append(0)
                dp_pt.append(q)
                dp_uv.append(tracks[i][q])
    if len(dp_kf) < 10:
        raise RuntimeError("too few dynamic point observations")
    E = len(dp_kf)

    t = lambda a, dtype=None: torch.as_tensor(np.asarray(a, dtype=dtype), device=dev)  # noqa: E731
    bo_args = {}
    if bboxes is not None:
        bo_kf, bo_meas = [], []
        for i, bb in enumerate(bboxes):
            if bb is not None:
                bo_kf.append(i)
                bo_meas.append([bb[0] + bb[2] / 2.0, bb[1] + bb[3] / 2.0, bb[2], bb[3]])
        if bo_kf:
            B = len(bo_kf)
            bo_args = dict(bo_kf=t(bo_kf, np.int64), bo_obj=t(np.zeros(B), np.int64),
                           bo_meas=t(bo_meas, np.float32), bo_si=t(np.full(B, 0.2), np.float32),
                           bo_valid=t(np.ones(B, bool)))

    out = dynamic_object_ba(
        t(cam_tcw, np.float32), t(stamps, np.float32),
        t(obj_pose_init[None], np.float32), t(np.asarray(obj_scale)[None], np.float32),
        t(np.zeros((1, 2)), np.float32), t(local, np.float32), t(K),
        t(dp_kf, np.int64), t(dp_obj, np.int64), t(dp_pt, np.int64), t(np.stack(dp_uv), np.float32),
        t(np.ones(E), np.float32), t(np.ones(E, bool)),
        t(np.zeros(N - 1), np.int64), t(np.arange(N - 1), np.int64), t(np.arange(1, N), np.int64),
        t(np.ones(N - 1, bool)),
        t(np.ones(N, bool)),                       # cameras fixed (from SLAM)
        t(np.ones((1, N), bool)), t(np.ones(1, bool)), t(pt_valid),
        num_iters=ba_iters, motion_weight=motion_weight, **bo_args,
    )
    _, obj_out, vel_out, pts_out, chi2 = out
    return DynamicTrackResult(
        obj_pose_per_frame=obj_out.cpu().numpy()[0],
        velocity=vel_out.cpu().numpy()[0],
        local_pts=pts_out.cpu().numpy(),
        n_tracked_pts=int(pt_valid.sum()),
        chi2=float(chi2),
    )


# ---------------------------------------------------------------------------
# Dynamic objects INSIDE the SLAM runtime (Tracking.cc:2144-2425 +
# Optimizer.cc:1537-2573 write-back): per-frame instance masks, KLT chains
# with Harris re-seeding, motion-compensated triangulation, per-(object,
# keyframe) pose slots + velocity history, and a dynamic BA invoked from the
# keyframe step with the CAMERAS jointly optimized.
# ---------------------------------------------------------------------------


@dataclass
class DynamicDetection:
    """One per-frame dynamic-object measurement (offline cuboid txt row or
    live detector output, Tracking.cc:1553-1580). mask is optional: the
    reference's SHIPPED dynamic config runs without KLT features
    (use_dynamic_klt_features=false, mono_dynamic.launch:32) — bbox +
    cuboid measurement alone drive the pipeline then."""

    tracklet_id: int
    local_pose: np.ndarray   # (4, 4) object in CAMERA frame
    scale: np.ndarray        # (3,) half-scale (e.g. KITTI car prior)
    bbox: np.ndarray         # (4,) [x y w h]
    mask: np.ndarray = None  # (H, W) bool instance mask (None = no KLT)


class _DynChain:
    """KLT point chains + per-KF pose slots for one tracked object."""

    def __init__(self, tracklet_id, scale, max_pts=64):
        self.tid = tracklet_id
        self.scale = np.asarray(scale, dtype=np.float32)
        self.max_pts = max_pts
        self.xy = np.zeros((max_pts, 2), dtype=np.float32)
        self.alive = np.zeros(max_pts, dtype=bool)
        self.local = np.zeros((max_pts, 3), dtype=np.float32)
        self.has_local = np.zeros(max_pts, dtype=bool)
        self.spawn_kf = np.full(max_pts, -1, dtype=np.int32)  # KF at spawn
        self.kf_obs = {}        # kf_id -> (xy snapshot, alive snapshot)
        self.kf_pose = {}       # kf_id -> (4, 4) object->world (SLAM frame)
        self.kf_stamp = {}      # kf_id -> float
        self.kf_frame = {}      # kf_id -> frame id (detects KF-slot reuse)
        self.kf_bbox = {}       # kf_id -> (4,) [cx cy w h] detection bbox
        self.velocity = np.zeros(2, dtype=np.float32)
        self.velocity_history = []   # (kf_id, [v, steer])
        self.last_center_uv = None


def _shift2d(mask, dy, dx):
    """Shift a bool image with ZERO padding (np.roll would wrap borders:
    pixels near one edge would erode based on the opposite edge)."""
    out = np.zeros_like(mask)
    H, W = mask.shape
    ys = slice(max(dy, 0), H + min(dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    yd = slice(max(-dy, 0), H + min(-dy, 0))
    xd = slice(max(-dx, 0), W + min(-dx, 0))
    out[ys, xs] = mask[yd, xd]
    return out


def _erode(mask, r=3):
    er = mask.copy()
    for dy in (-r, 0, r):
        for dx in (-r, 0, r):
            if dy == 0 and dx == 0:
                continue
            er &= _shift2d(mask, dy, dx)
    return er


def _copy(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, tuple):
        return tuple(_copy(x) for x in v)
    return v


class DynamicObjectManager:
    """Host-side lifecycle of moving objects inside the tracker.

    Per frame: advance each object's KLT chains (mask-gated), re-seed
    Harris corners when a chain population dies (Tracking.cc:2258-2338).
    Per keyframe: snapshot chain observations, initialize the per-KF object
    pose from the measurement (velocity-propagated when missing),
    triangulate new points with motion-compensated poses
    (Tracking.cc:2144-2244), and assemble + solve the dynamic BA with the
    window cameras FREE (LocalBACameraPointObjectsDynamic)."""

    def __init__(self, max_pts=64, min_alive=12, window_kfs=6,
                 klt_max_err=45.0, motion_weight=1.5, ba_iters=15,
                 max_dp_edges=1024, min_triangulation_baseline=0.25,
                 fb_max_err=1.0, fix_rotation=True,
                 ba_pt_obj_cam=False, ba_obj_velo=True, ba_obj_cam=True,
                 world_T_slam=None, device=None):
        # edge-family gates + DOF policy, defaulted to the reference's
        # SHIPPED dynamic configuration (launch/mono_dynamic.launch:37-39 +
        # Optimizer.cc:1778): per-KF cuboid vertices optimize translation
        # only (whether_fixrotation), dynamic-point reprojection edges are
        # OFF (ba_dyna_pt_obj_cam=false — KLT chains still triangulate and
        # associate, but do not shape the poses), velocity/motion edges and
        # camera-object bbox edges are ON
        self.device = resolve(device)
        self.fix_rotation = fix_rotation
        self.ba_pt_obj_cam = ba_pt_obj_cam
        self.ba_obj_velo = ba_obj_velo
        self.ba_obj_cam = ba_obj_cam
        # rigid alignment SLAM-world -> z-up GROUND frame (p_g = G p_w).
        # The planar motion model needs a gravity-aligned frame; in mono
        # KITTI the SLAM world is the first CAMERA frame and G is the
        # InitToGround transform (Tracking.cc:110-143). Object poses are
        # kept in the ground frame; cameras are re-aligned on the fly.
        self.G = (np.eye(4) if world_T_slam is None
                  else np.asarray(world_T_slam, dtype=np.float64))
        self.G_inv = np_geo.inv_T(self.G)
        self.chains: dict[int, _DynChain] = {}
        self.max_pts = max_pts
        self.min_alive = min_alive
        self.window_kfs = window_kfs
        self.klt_max_err = klt_max_err
        self.motion_weight = motion_weight
        self.ba_iters = ba_iters
        self.max_dp_edges = max_dp_edges
        self.min_triangulation_baseline = min_triangulation_baseline
        self.fb_max_err = fb_max_err
        self._prev_gray = None  # the previous frame on the device
        self._prev_dets = {}

    def load_state(self, fields):
        """Take over another manager's state from a dict of its fields (the
        JAX package's DynamicObjectManager as `vars(jax_manager)`): the
        chains with their points, snapshots, per-keyframe poses, stamps,
        boxes, velocity and history, the previous frame and detections, and
        the settings. Arrays are copied; the previous frame goes to this
        manager's device."""
        for name, value in fields.items():
            if name == "chains":
                chains = {}
                for tid, ch in value.items():
                    c = _DynChain(ch.tid, ch.scale, ch.max_pts)
                    for k, v in vars(ch).items():
                        if isinstance(v, dict):
                            v = {kk: _copy(vv) for kk, vv in v.items()}
                        elif isinstance(v, list):
                            v = [_copy(x) for x in v]
                        setattr(c, k, _copy(v))
                    chains[tid] = c
                value = chains
            elif name == "_prev_gray":
                value = None if value is None else _f32(np.asarray(value), self.device)
            elif name == "_prev_dets":
                value = {tid: DynamicDetection(**{k: _copy(v) for k, v in vars(d).items()})
                         for tid, d in value.items()}
            setattr(self, name, _copy(value))

    def _cam_tcw(self, m, k):
        """Camera pose re-expressed over the GROUND world: Tcw_g =
        Tcw_slam @ G^-1."""
        return m.kf_tcw[k].astype(np.float64) @ self.G_inv

    def pose_tracks(self):
        """Per-object pose history for the viewer: list of (poses, scale)
        where poses is the chain's object->world poses in keyframe order —
        the allDynamicPoses view of MapDrawer.cc:250."""
        out = []
        for ch in self.chains.values():
            if not ch.kf_pose:
                continue
            poses = [ch.kf_pose[k] for k in sorted(ch.kf_pose)]
            out.append((np.stack(poses), ch.scale))
        return out

    # -- per frame -----------------------------------------------------
    def advance(self, gray, dets):
        """KLT-advance all chains from the previous frame; spawn/re-seed
        corners on the (eroded) masks. dets: list[DynamicDetection]."""
        det_of = {d.tracklet_id: d for d in (dets or [])}
        dev = self.device
        gray_t = _f32(gray, dev)

        for tid, det in det_of.items():
            if tid not in self.chains:
                self.chains[tid] = _DynChain(tid, det.scale, self.max_pts)

        if self._prev_gray is not None:
            for tid, ch in self.chains.items():
                if not ch.alive.any():
                    continue
                det = det_of.get(tid)
                # seed flow with the projected center motion when both
                # frames have measurements (SearchByTracking's prediction)
                guess = np.zeros(2, dtype=np.float32)
                prev_det = self._prev_dets.get(tid)
                if det is not None and prev_det is not None:
                    c1 = det.bbox[:2] + det.bbox[2:] / 2.0
                    c0 = prev_det.bbox[:2] + prev_det.bbox[2:] / 2.0
                    guess = (c1 - c0).astype(np.float32)
                pts1, status = _lk(self._prev_gray, gray_t, ch.xy, ch.alive, guess, self.klt_max_err, dev)
                # forward-backward consistency: drifted tracks fail the
                # round trip (keeps the chains pixel-accurate; drift was
                # measured at up to 35 px over 10 frames without this)
                back, bstat = klt.pyr_lk(gray_t, self._prev_gray, pts1, status,
                                         init_flow=torch.as_tensor(-guess, device=dev).expand(ch.max_pts, 2),
                                         max_err=self.klt_max_err)
                both = torch.cat([pts1, back, status[:, None].to(torch.float32), bstat[:, None].to(torch.float32)],
                                 dim=1).cpu().numpy()
                pts1, back = both[:, 0:2].copy(), both[:, 2:4]
                status, bstat = both[:, 4] > 0.5, both[:, 5] > 0.5
                fb = np.linalg.norm(back - ch.xy, axis=1)
                status &= bstat & (fb < self.fb_max_err)
                if det is not None and det.mask is not None:
                    xi = np.clip(pts1[:, 0].astype(int), 0, det.mask.shape[1] - 1)
                    yi = np.clip(pts1[:, 1].astype(int), 0, det.mask.shape[0] - 1)
                    status &= det.mask[yi, xi]
                ch.xy = pts1
                ch.alive = ch.alive & status

        # re-seed dead chain populations from the current mask; recycle
        # slots WITHOUT object coordinates first (slots with coordinates
        # still contribute BA edges through their past KF snapshots)
        for tid, det in det_of.items():
            ch = self.chains[tid]
            if det.mask is None:  # no-KLT mode (use_dynamic_klt_features=false)
                continue
            if ch.alive.sum() >= self.min_alive:
                continue
            # only recycle slots WITHOUT object coordinates: localized slots
            # are landmarks whose past-KF snapshots keep feeding BA edges
            free = np.where(~ch.alive & ~ch.has_local)[0]
            if len(free) == 0:
                continue
            xy_new, valid_new = klt.harris_corners(gray_t, max_corners=len(free),
                                                   mask=torch.as_tensor(_erode(det.mask), device=dev))
            both = torch.cat([xy_new, valid_new[:, None].to(torch.float32)], dim=1).cpu().numpy()
            xy_new, valid_new = both[:, :2], both[:, 2] > 0.5
            n = min(len(free), len(xy_new))
            sel = free[:n]
            # the recycled slots now hold DIFFERENT physical points: their
            # past snapshots must not feed the BA anymore
            for _, alive_s in ch.kf_obs.values():
                alive_s[sel] = False
            ch.xy[sel] = xy_new[:n]
            ch.alive[sel] = valid_new[:n]
            ch.has_local[sel] = False
            ch.spawn_kf[sel] = -1  # set at the next keyframe snapshot

        self._prev_gray = gray_t
        self._prev_dets = det_of

    # -- per keyframe ----------------------------------------------------
    def on_keyframe(self, map_state, kf_id, dets, stamp, K, img_wh=None):
        """Snapshot observations, set per-KF object poses, triangulate new
        points (motion-compensated). dets: list[DynamicDetection]."""
        m = map_state
        det_of = {d.tracklet_id: d for d in (dets or [])}
        # spawn chains for unseen tracklets here too: in the no-KLT
        # configuration (mask-less detections) advance() never runs
        for tid, det in det_of.items():
            if tid not in self.chains:
                self.chains[tid] = _DynChain(tid, det.scale, self.max_pts)
        self._purge_stale(m)
        Twc = np_geo.inv_T(self._cam_tcw(m, kf_id))
        for tid, ch in self.chains.items():
            det = det_of.get(tid)
            if det is not None:
                pose_w = (Twc @ det.local_pose.astype(np.float64)).astype(np.float32)
            elif ch.kf_pose and ch.alive.any():
                # velocity propagation is only an INITIALIZATION — a per-KF
                # pose vertex with neither a detection nor live tracked
                # points would be constrained solely by the motion edge,
                # feeding the current velocity estimate back into itself
                # (the reference creates vertices only for observed KFs,
                # Optimizer.cc:1726-1786); the planar model of
                # EdgeObjectMotion: heading = world-frame yaw
                last_kf = max(ch.kf_pose)
                dtau = float(stamp - ch.kf_stamp[last_kf])
                pose_w = ch.kf_pose[last_kf].copy()
                yaw = float(np.arctan2(pose_w[1, 0], pose_w[0, 0]))
                v = float(ch.velocity[0])
                pose_w[0, 3] += v * dtau * np.cos(yaw)
                pose_w[1, 3] += v * dtau * np.sin(yaw)
            else:
                continue
            ch.kf_pose[kf_id] = pose_w
            ch.kf_stamp[kf_id] = float(stamp)
            ch.kf_frame[kf_id] = int(m.kf_frame_id[kf_id])
            if det is not None:
                x, y, w, h = det.bbox[:4]
                # boundary filter (Tracking.cc:1581-1626): a box touching
                # the image border is truncated — its measured extent
                # disagrees with the full cuboid projection
                interior = img_wh is None or (
                    x > 5 and y > 5
                    and x + w < img_wh[0] - 5 and y + h < img_wh[1] - 5)
                if interior:
                    ch.kf_bbox[kf_id] = np.array([x + w / 2.0, y + h / 2.0, w, h], dtype=np.float32)
            if ch.alive.any():
                ch.kf_obs[kf_id] = (ch.xy.copy(), ch.alive.copy())
                fresh = ch.alive & (ch.spawn_kf < 0)
                ch.spawn_kf[fresh] = kf_id
                self._triangulate_new(m, ch, kf_id, K)
                self._init_local_from_cuboid_depth(m, ch, kf_id, K)

    def _init_local_from_cuboid_depth(self, m, ch, kf_id, K):
        """Depth-init from the cuboid measurement (Tracking.cc:2339-2425):
        points still lacking object coordinates get the cuboid center's
        camera depth along their pixel ray — bounded by the box size
        instead of amplified triangulation noise. The BA refines them."""
        pending = ch.alive & ~ch.has_local & (ch.spawn_kf == kf_id)
        if not pending.any() or kf_id not in ch.kf_pose:
            return
        Tcw = self._cam_tcw(m, kf_id)
        P_obj = ch.kf_pose[kf_id].astype(np.float64)
        center_cam = Tcw[:3, :3] @ P_obj[:3, 3] + Tcw[:3, 3]
        z = float(center_cam[2])
        if z <= 0.1:
            return
        Kinv = np.linalg.inv(np.asarray(K, dtype=np.float64))
        uv1 = np.concatenate([ch.xy[pending], np.ones((pending.sum(), 1))], axis=1)
        pc = (uv1 @ Kinv.T) * z
        Twc = np_geo.inv_T(Tcw)
        pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
        inv_P = np_geo.inv_T(P_obj)
        local = pw @ inv_P[:3, :3].T + inv_P[:3, 3]
        ok = (np.abs(local) < 2.0 * ch.scale).all(axis=1)
        # visible points lie ON the box surface; the center-depth init puts
        # them up to half a box too deep — clamp into the box so the in-box
        # prior starts unbiased and the BA refines from the surface
        local = np.clip(local, -ch.scale, ch.scale)
        idx = np.where(pending)[0][ok]
        ch.local[idx] = local[ok]
        ch.has_local[idx] = True

    def _purge_stale(self, m):
        """Drop per-KF entries whose map slot was culled or recycled —
        chain state is keyed by KF slot, and KeyFrameCulling recycles
        slots."""
        for ch in self.chains.values():
            for k in list(ch.kf_pose):
                if not m.kf_valid[k] or int(m.kf_frame_id[k]) != ch.kf_frame.get(k, -2):
                    ch.kf_pose.pop(k, None)
                    ch.kf_obs.pop(k, None)
                    ch.kf_stamp.pop(k, None)
                    ch.kf_frame.pop(k, None)
                    ch.kf_bbox.pop(k, None)
                    # points spawned at a vanished KF can no longer be
                    # triangulated against it
                    lost = ch.spawn_kf == k
                    ch.spawn_kf[lost & ~ch.has_local] = -1

    def _triangulate_new(self, m, ch, kf_id, K):
        """Motion-compensated two-view triangulation of chain points that
        do not have object-frame coordinates yet (Tracking.cc:2144-2244)."""
        need = ch.alive & ~ch.has_local & (ch.spawn_kf >= 0) & (ch.spawn_kf != kf_id)
        if not need.any():
            return
        K64 = np.asarray(K, dtype=np.float64)
        for a in np.unique(ch.spawn_kf[need]):
            sel = need & (ch.spawn_kf == a)
            if a not in ch.kf_obs or a not in ch.kf_pose:
                continue
            xy_a, alive_a = ch.kf_obs[a]
            sel &= alive_a
            if not sel.any():
                continue
            Pa = ch.kf_pose[a].astype(np.float64)
            Pb = ch.kf_pose[kf_id].astype(np.float64)
            comp = Pa @ np_geo.inv_T(Pb)  # undo the object's motion
            Tcw_a = self._cam_tcw(m, a)
            Tcw_b_comp = self._cam_tcw(m, kf_id) @ np_geo.inv_T(comp)
            # short compensated baselines give depth errors amplified by
            # (depth/baseline) x pose-measurement noise — wait for a wider
            # pair instead of committing garbage coordinates
            c_a = np_geo.inv_T(Tcw_a)[:3, 3]
            c_b = np_geo.inv_T(Tcw_b_comp)[:3, 3]
            if np.linalg.norm(c_a - c_b) < self.min_triangulation_baseline:
                continue
            Xw = _triangulate(K64 @ Tcw_a[:3, :], K64 @ Tcw_b_comp[:3, :], xy_a, ch.xy, self.device)
            inv_Pa = np_geo.inv_T(Pa)
            local = Xw @ inv_Pa[:3, :3].T + inv_Pa[:3, 3]
            ok = (sel & np.isfinite(local).all(axis=1)
                  & (np.abs(local) < 2.0 * ch.scale).all(axis=1))
            ch.local[ok] = local[ok]
            ch.has_local[ok] = True

    # -- dynamic BA ------------------------------------------------------
    def run_dynamic_ba(self, map_state, K, static_edges_fn=None):
        """Joint cameras + per-KF object poses + velocity + local points
        over the recent keyframe window. static_edges_fn(window) -> static
        anchor-edge arrays (or None). Returns the window kf ids (whose map
        poses are updated in place) or None.

        The JAX package pads the edge families to fixed capacities; here
        they keep their own sizes, clipped to the same capacities in the
        same order (point edges to max_dp_edges, motion edges to 64, bbox
        edges to window_kfs * 16; the static edges come capped)."""
        m = map_state
        self._purge_stale(m)
        all_kf = sorted(
            set(k for ch in self.chains.values() for k in ch.kf_pose),
            key=lambda k: int(m.kf_frame_id[k]),  # time order, not slot order
        )
        window = [k for k in all_kf if m.kf_valid[k]][-self.window_kfs:]
        if len(window) < 2:
            return None
        kf_local = {k: i for i, k in enumerate(window)}
        Kf = len(window)

        tids = [tid for tid, ch in self.chains.items()
                if sum(1 for k in ch.kf_pose if k in kf_local) >= 2
                and (not self.ba_pt_obj_cam or ch.has_local.sum() >= 6)]
        if not tids:
            return None
        O = len(tids)
        Qp = self.max_pts  # per-object point block

        kf_tcw = np.stack([self._cam_tcw(m, k) for k in window]).astype(np.float32)
        # one stamp per window KF: any chain's recorded stamp, else the
        # frame id (NEVER the window index — that would corrupt motion dt)
        merged_stamps = {}
        for ch in self.chains.values():
            merged_stamps.update(ch.kf_stamp)
        stamps = np.array([merged_stamps.get(k, float(m.kf_frame_id[k])) for k in window], dtype=np.float32)
        obj_pose_kf = np.tile(np.eye(4, dtype=np.float32), (O, Kf, 1, 1))
        obj_kf_valid = np.zeros((O, Kf), dtype=bool)
        obj_scale = np.stack([self.chains[t].scale for t in tids])
        velocity = np.stack([self.chains[t].velocity for t in tids])
        local_pts = np.zeros((O * Qp, 3), dtype=np.float32)
        pt_valid = np.zeros(O * Qp, dtype=bool)

        dp_kf, dp_obj, dp_pt, dp_uv = [], [], [], []
        mo_obj, mo_k0, mo_k1 = [], [], []
        bo_kf, bo_obj, bo_meas = [], [], []
        for oi, tid in enumerate(tids):
            ch = self.chains[tid]
            local_pts[oi * Qp:(oi + 1) * Qp] = ch.local
            pt_valid[oi * Qp:(oi + 1) * Qp] = ch.has_local
            obs_kfs = []
            for k, i in kf_local.items():
                if k in ch.kf_pose:
                    obj_pose_kf[oi, i] = ch.kf_pose[k]
                    obj_kf_valid[oi, i] = True
                    obs_kfs.append(i)
                if k in ch.kf_obs:
                    xy, alive = ch.kf_obs[k]
                    for q in np.where(alive & ch.has_local)[0]:
                        dp_kf.append(i)
                        dp_obj.append(oi)
                        dp_pt.append(oi * Qp + q)
                        dp_uv.append(xy[q])
                if k in ch.kf_bbox:
                    # camera-object bbox edge per detection — pins the
                    # objPose/localPoint gauge (ba_dyna_obj_cam,
                    # Optimizer.cc:2232)
                    bo_kf.append(i)
                    bo_obj.append(oi)
                    bo_meas.append(ch.kf_bbox[k])
            obs_kfs.sort()
            if self.ba_obj_velo:
                for a, b in zip(obs_kfs[:-1], obs_kfs[1:]):
                    mo_obj.append(oi)
                    mo_k0.append(a)
                    mo_k1.append(b)
        if not self.ba_pt_obj_cam:
            # reference shipped config (mono_dynamic.launch:37): KLT point
            # reprojections do not shape the poses — freeze the points and
            # drop their edges; poses come from bbox + motion edges
            dp_kf, dp_obj, dp_pt, dp_uv = [], [], [], []
            pt_valid[:] = False
            if not (bo_kf or mo_obj):
                return None
        elif len(dp_kf) < 10:
            return None

        E_CAP = self.max_dp_edges
        if len(dp_kf) > E_CAP:
            logger.warning("dynamic BA: clipping %d -> %d point edges", len(dp_kf), E_CAP)
        nE = min(len(dp_kf), E_CAP)
        dp_kf_a = np.asarray(dp_kf[:nE], dtype=np.int64)
        dp_obj_a = np.asarray(dp_obj[:nE], dtype=np.int64)
        dp_pt_a = np.asarray(dp_pt[:nE], dtype=np.int64)
        dp_uv_a = np.asarray(dp_uv[:nE], dtype=np.float32).reshape(nE, 2)
        dp_valid = np.ones(nE, dtype=bool)
        M_CAP = 64
        mo = [np.asarray(a[:M_CAP], dtype=np.int64) for a in (mo_obj, mo_k0, mo_k1)]

        kf_fixed = np.zeros(Kf, dtype=bool)
        kf_fixed[0] = True  # gauge: oldest window camera

        dev = self.device
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
        extra = {}
        if not self.ba_obj_cam:
            bo_kf = []
        if bo_kf:
            nB = min(len(bo_kf), self.window_kfs * 16)
            extra.update(bo_kf=t(np.asarray(bo_kf[:nB], np.int64)), bo_obj=t(np.asarray(bo_obj[:nB], np.int64)),
                         bo_meas=t(np.asarray(bo_meas[:nB], np.float32)),
                         bo_si=torch.full((nB,), 0.5, dtype=torch.float32, device=dev),
                         bo_valid=torch.ones(nB, dtype=torch.bool, device=dev))
        static_edges = static_edges_fn(window) if static_edges_fn else None
        if static_edges is not None:
            sp_kf, sp_pts, sp_uv, sp_si, sp_valid = static_edges
            n = int(sp_valid.sum())  # the valid edges lead the capped arrays
            # static anchor points live in the SLAM world; the BA runs over
            # the ground world
            sp_pts = (sp_pts[:n].astype(np.float64) @ self.G[:3, :3].T + self.G[:3, 3]).astype(np.float32)
            extra.update(sp_kf=t(sp_kf[:n].astype(np.int64)), sp_pts=t(sp_pts), sp_uv=t(sp_uv[:n]),
                         sp_si=t(sp_si[:n]), sp_valid=t(sp_valid[:n]))

        K32 = np.asarray(K, np.float32)
        fixed = dict(kf_stamps=t(stamps), obj_scale=t(obj_scale), K=t(K32), dp_kf=t(dp_kf_a), dp_obj=t(dp_obj_a),
                     dp_pt=t(dp_pt_a), dp_uv=t(dp_uv_a), dp_si=torch.ones(nE, dtype=torch.float32, device=dev),
                     mo_obj=t(mo[0]), mo_k0=t(mo[1]), mo_k1=t(mo[2]),
                     mo_valid=torch.ones(len(mo[0]), dtype=torch.bool, device=dev), kf_fixed=t(kf_fixed),
                     obj_kf_valid=t(obj_kf_valid), obj_valid=torch.ones(O, dtype=torch.bool, device=dev),
                     pt_valid=t(pt_valid))

        def solve(kf0, obj0, vel0, pts0, dp_ok, iters):
            out = dynamic_object_ba(t(kf0), obj_pose_kf=t(obj0), velocity=t(vel0), local_pts=t(pts0),
                                    dp_valid=t(dp_ok), num_iters=iters, motion_weight=self.motion_weight,
                                    fix_rotation=self.fix_rotation, **fixed, **extra)
            return [x.cpu().numpy() for x in out[:4]]

        def dp_chi2(kf0, obj0, pts0):
            """Host-side per-edge reprojection chi2 for outlier pruning."""
            T_e = kf0[dp_kf_a]
            P_e = obj0[dp_obj_a, dp_kf_a]
            lp = pts0[dp_pt_a]
            world = np.einsum("eij,ej->ei", P_e[:, :3, :3], lp) + P_e[:, :3, 3]
            pc = np.einsum("eij,ej->ei", T_e[:, :3, :3], world) + T_e[:, :3, 3]
            uv = pc @ K32.T
            uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-6)
            return np.sum((uv - dp_uv_a) ** 2, axis=1)

        # two-stage schedule with chi2 pruning between stages: KLT chains
        # carry systematic outliers (drift, occlusion-boundary locks) that
        # would otherwise drag the per-KF poses (the reference's dynamic BA
        # prunes edges the same way its static one does). With point edges
        # gated off there is nothing to prune — single solve.
        if not self.ba_pt_obj_cam:
            kf_out, obj_out, vel_out, pts_out = solve(kf_tcw, obj_pose_kf, velocity, local_pts, dp_valid,
                                                      self.ba_iters)
        else:
            kf1, obj1, vel1, pts1 = solve(kf_tcw, obj_pose_kf, velocity, local_pts, dp_valid, 5)
            keep = dp_valid & (dp_chi2(kf1, obj1, pts1) <= 5.991)
            if keep.sum() < 10:
                return None
            kf_out, obj_out, vel_out, pts_out = solve(kf1, obj1, vel1, pts1, keep, self.ba_iters)

        # write back: cameras, per-KF object poses, velocity (+history),
        # refined local points (allDynamicPoses/velocityhistory write-back,
        # Optimizer.cc:2440-2573)
        for k, i in kf_local.items():
            if not kf_fixed[i]:
                m.kf_tcw[k] = (kf_out[i].astype(np.float64) @ self.G).astype(np.float32)
        for oi, tid in enumerate(tids):
            ch = self.chains[tid]
            for k, i in kf_local.items():
                if obj_kf_valid[oi, i]:
                    ch.kf_pose[k] = obj_out[oi, i]
            ch.velocity = vel_out[oi]
            # latest by TIME (kf_frame_id), not slot id — KF slot recycling
            # breaks slot-order == time-order (window is time-sorted too)
            last_k = max((kk for kk in ch.kf_pose if kk in kf_local), key=lambda kk: int(m.kf_frame_id[kk]))
            ch.velocity_history.append((last_k, vel_out[oi].copy()))
            ch.local = pts_out[oi * Qp:(oi + 1) * Qp]
        return window


class DynamicRgbdTracker:
    """RGBD tracker with moving-object tracking integrated — the reference's
    dynamic configuration (mono_dynamic.launch) with metric scale supplied
    by depth instead of KITTI ground-plane recovery. Drive it with
    track(gray, depth, dyn_dets) per frame.

    Per frame (Tracking.cc dynamic additions):
    * dynamic-region keypoints are removed from the static pipeline
      (Frame.cc:221-264 KeysStatic): the tracking step drops keypoints
      under the union of the instance masks on the device, and the
      initialization path masks the extracted features in every copy,
    * object KLT chains advance with mask gating + Harris re-seeding,
    Per keyframe: per-(object, KF) pose slots, motion-compensated
    triangulation, and the joint dynamic BA with window cameras FREE
    (LocalBACameraPointObjectsDynamic write-back)."""

    def __init__(self, K, img_wh, config=None, depth_max=8.0,
                 manager: DynamicObjectManager | None = None,
                 static_anchor_cap=1024, ground_Twc0=None, device=None):
        from .system import RgbdTracker

        dev = resolve(device)
        self.dynamic = manager or DynamicObjectManager(device=dev)
        self._pending_dyn = []
        self.static_anchor_cap = static_anchor_cap

        outer = self

        class _Impl(RgbdTracker):
            def _extract(self, gray):
                feats = super()._extract(gray)
                if outer._pending_dyn:
                    xy, valid = feats.xy, feats.valid.copy()
                    for d in outer._pending_dyn:
                        xi = np.clip(xy[:, 0].astype(int), 0, d.mask.shape[1] - 1)
                        yi = np.clip(xy[:, 1].astype(int), 0, d.mask.shape[0] - 1)
                        valid &= ~d.mask[yi, xi]
                    feats.restrict_valid(valid)
                return feats

            def _suppress_dev(self, gray):
                # fast-path analog of the _extract masking: ship the union
                # instance mask so the tracking step drops dynamic-region
                # keypoints on device (KeysStatic, Frame.cc:221-264)
                if not outer._pending_dyn:
                    return super()._suppress_dev(gray)
                mask = np.zeros(np.asarray(gray).shape, dtype=np.float32)
                for d in outer._pending_dyn:
                    mask[d.mask] = 1.0
                return self._t(mask)

            def _create_keyframe(self, feats, fid=None):
                super()._create_keyframe(feats, fid=fid)
                # dynamic BA jointly optimizes window cameras — fold the
                # in-flight static BA first so the two don't interleave
                self._apply_pending_map()
                k = self.ref_kf
                with profiler.span("dyn.keyframe"):
                    outer.dynamic.on_keyframe(self.map, k, outer._pending_dyn, stamp=float(self.frame_id), K=self.K,
                                              img_wh=self.img_wh)
                with profiler.span("dyn.ba"):
                    outer.dynamic.run_dynamic_ba(
                        self.map, self.K, static_edges_fn=lambda w: outer._static_anchor_edges(self, w))

        self._impl = _Impl(K, img_wh, config, depth_max=depth_max, init_Twc=ground_Twc0, device=dev)

    def __getattr__(self, name):
        if name == "_impl":  # not built yet (copying, unpickling)
            raise AttributeError(name)
        return getattr(self._impl, name)

    def track(self, gray, depth=None, dyn_dets=None):
        """One frame, its depth image and its DynamicDetections (with
        instance masks); returns Tcw or None."""
        with profiler.frame(self.frame_id + 1):
            self._pending_dyn = dyn_dets or []
            # chains advance prev->current BEFORE the keyframe snapshot
            with profiler.span("dyn.advance"):
                self.dynamic.advance(gray, self._pending_dyn)
            return self._impl.track(gray, depth)

    def _static_anchor_edges(self, impl, window):
        return static_anchor_edges(impl.map, window, self.static_anchor_cap)


def static_anchor_edges(m, window, cap=1024):
    """Up to `cap` reprojection edges against FIXED static map points over
    the window keyframes, at most cap // len(window) per keyframe — anchors
    the cameras freed by the dynamic BA (the reference includes the full
    static point family, Optimizer.cc:1537-; constants here, see
    graph/dynamic_ba). Host numpy: (sp_kf, sp_pts, sp_uv, sp_si, sp_valid)
    of length `cap`, the valid edges first, or None below 10 edges."""
    from .tracking import SCALE_FACTOR

    S = cap
    sp_kf = np.zeros(S, dtype=np.int32)
    sp_pts = np.zeros((S, 3), dtype=np.float32)
    sp_uv = np.zeros((S, 2), dtype=np.float32)
    sp_si = np.ones(S, dtype=np.float32)
    sp_valid = np.zeros(S, dtype=bool)
    n = 0
    per_kf = max(1, S // max(len(window), 1))
    for i, k in enumerate(window):
        mp = m.kf_kp_mp[k]
        kps = np.where((mp >= 0) & m.kf_kp_valid[k])[0][:per_kf]
        for kp in kps:
            if n >= S:
                break
            pid = mp[kp]
            if not m.mp_valid[pid]:
                continue
            sp_kf[n] = i
            sp_pts[n] = m.mp_pos[pid]
            sp_uv[n] = m.kf_kp_xy[k, kp]
            sp_si[n] = 1.0 / (SCALE_FACTOR ** m.kf_kp_level[k, kp])
            sp_valid[n] = True
            n += 1
    if n < 10:
        return None
    return sp_kf, sp_pts, sp_uv, sp_si, sp_valid
