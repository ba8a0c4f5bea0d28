"""Monocular ground-plane scale recovery.

PyTorch counterpart of cube_slam_tpu/slam/ground.py, the re-design of the
ground-height rescaling in Tracking.cc:2433-2663: fit a plane (batched
RANSAC, ops/ransac.py, on the estimator's device) to map points seen in the
lower middle of the image, accept it if its normal is close to the expected
camera-frame ground normal and the camera height is plausible, low-pass the
height estimate, and rescale the map about an anchor (Tracking.cc:2588-2651).
Everything but the plane fit is host numpy, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..ops import ransac
from ..utils import np_geometry as np_geo


@dataclass
class GroundConfig:
    nominal_height: float = 1.7          # KITTI camera height (m)
    every_kfs: int = 10                  # ground_everyKFs
    min_points: int = 20
    inlier_thresh: float = 0.05          # plane distance (scaled units)
    max_normal_angle_deg: float = 10.0
    height_filter_alpha: float = 0.6     # new-weight in the low-pass
    region_lower_frac: float = 1.0 / 3.0 # lower third of the image
    region_mid_frac: float = 0.5         # middle half of columns
    n_hypotheses: int = 256


class GroundScaleEstimator:
    """`device` is where the plane RANSAC runs (default: the card)."""

    def __init__(self, cfg: GroundConfig | None = None, device=None):
        self.cfg = cfg or GroundConfig()
        self.device = resolve(device)
        self.filtered_height = None
        self.kf_counter = 0

    def candidate_points(self, map_state, kf_id, img_wh, max_world_z=None):
        """Map points observed by kf_id whose keypoints lie in the lower
        middle of the image and that aren't object-owned
        (Tracking.cc:2439-2449). `max_world_z` (metric ground-anchored
        worlds only): additionally require |world z| below the bound."""
        cfg = self.cfg
        m = map_state
        kp_xy = m.kf_kp_xy[kf_id]
        mp = m.kf_kp_mp[kf_id]
        w, h = img_wh
        sel = (
            (mp >= 0)
            & (kp_xy[:, 1] > h * (1.0 - cfg.region_lower_frac))
            & (kp_xy[:, 0] > w * (0.5 - cfg.region_mid_frac / 2))
            & (kp_xy[:, 0] < w * (0.5 + cfg.region_mid_frac / 2))
        )
        ids = mp[sel]
        ids = ids[m.mp_valid[ids]]
        if hasattr(m, "mp_best_obj"):
            ids = ids[m.mp_best_obj[ids] < 0]
        if max_world_z is not None and len(ids):
            ids = ids[np.abs(m.mp_pos[ids][:, 2]) < max_world_z]
        return ids

    def try_recover(self, map_state, kf_id, img_wh, cam_ground_normal=(0.0, -1.0, 0.0),
                    seed=0, max_world_z=None):
        """Attempt a scale estimate at this keyframe. Returns scale factor
        (to MULTIPLY map translations by) or None."""
        cfg = self.cfg
        self.kf_counter += 1
        if self.kf_counter % cfg.every_kfs != 0:
            return None
        height = self.measure_height(map_state, kf_id, img_wh,
                                     cam_ground_normal, seed,
                                     max_world_z=max_world_z)
        if height is None:
            return None

        # low-pass the height (Tracking.cc:2608-2612)
        if self.filtered_height is None:
            self.filtered_height = height
        else:
            a = cfg.height_filter_alpha
            self.filtered_height = a * height + (1 - a) * self.filtered_height
        return cfg.nominal_height / self.filtered_height

    def measure_height(self, map_state, kf_id, img_wh,
                       cam_ground_normal=(0.0, -1.0, 0.0), seed=0,
                       max_world_z=None, min_inlier_frac=0.0):
        """Raw single-keyframe camera height above the fitted ground plane
        (no cadence gate, no low-pass); also the exact metric-scale anchor
        right after initialization (scale = nominal/height)."""
        cfg = self.cfg
        ids = self.candidate_points(map_state, kf_id, img_wh,
                                    max_world_z=max_world_z)
        if len(ids) < cfg.min_points:
            return None
        m = map_state
        Tcw = m.kf_tcw[kf_id]
        pts_cam = m.mp_pos[ids] @ Tcw[:3, :3].T + Tcw[:3, 3]

        N = 256
        pts = np.zeros((N, 3), dtype=np.float32)
        valid = np.zeros(N, dtype=bool)
        take = min(len(ids), N)
        pts[:take] = pts_cam[:take]
        valid[:take] = True
        samples = ransac.make_triplet_indices(valid, n_hyp=cfg.n_hypotheses, seed=seed)
        dev = self.device
        plane, _, n_in = ransac.fit_plane_ransac(
            torch.tensor(pts, device=dev), torch.tensor(valid, device=dev),
            torch.tensor(samples, device=dev), cfg.inlier_thresh,
            expected_normal=torch.tensor(cam_ground_normal, dtype=torch.float32, device=dev),
            min_normal_cos=float(np.float32(np.cos(np.deg2rad(cfg.max_normal_angle_deg)))),
            prefer_farthest=True,
        )
        out = torch.cat([plane, n_in.to(plane.dtype)[None]]).cpu().numpy()  # one read
        plane = out[:4]
        n_in = int(out[4])
        # quality gates: absolute inlier floor, plus an optional inlier
        # FRACTION floor (a plane explaining only a sliver of the candidate
        # region is a pseudo-plane through object structure)
        if n_in < max(cfg.min_points // 2,
                      int(np.ceil(min_inlier_frac * len(ids)))):
            return None
        normal = plane[:3]
        expected = np.asarray(cam_ground_normal, dtype=np.float64)
        cosang = abs(float(normal @ expected)) / (np.linalg.norm(normal) * np.linalg.norm(expected))
        if cosang < np.cos(np.deg2rad(cfg.max_normal_angle_deg)):
            return None
        height = abs(float(plane[3]))  # camera distance to plane
        if height < 1e-6:
            return None
        return height

    @staticmethod
    def apply_scale(map_state, anchor_kf, scale, about=None):
        """Rescale the map about the anchor keyframe's camera center
        (Tracking.cc:2614-2651): map points and keyframe translations move;
        rotations unchanged. `about` overrides the pivot point (a ground-
        anchored world scales about a point on the z=0 plane)."""
        m = map_state
        anchor_center = (np.asarray(about, dtype=np.float64) if about is not None
                         else np_geo.inv_T(m.kf_tcw[anchor_kf])[:3, 3])
        ids = m.mp_ids()
        m.mp_pos[ids] = (m.mp_pos[ids] - anchor_center) * scale + anchor_center
        for k in m.kf_ids():
            Twc = np_geo.inv_T(m.kf_tcw[k])
            Twc[:3, 3] = (Twc[:3, 3] - anchor_center) * scale + anchor_center
            m.kf_tcw[k] = np_geo.inv_T(Twc).astype(np.float32)
        m.mp_min_dist[ids] *= scale
        m.mp_max_dist[ids] *= scale
