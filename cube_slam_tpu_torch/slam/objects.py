"""Cuboid object landmarks inside the SLAM map.

Copy of cube_slam_tpu/slam/objects.py (host numpy; the JAX package's module
is not imported, since that package imports jax), plus the state carry
`ObjectStore.from_arrays` / `ObjectManager.load_state`. It is the re-design
of the object machinery threaded through Tracking.cc:

* DetectCuboid (Tracking.cc:1545-1846): per new keyframe run the cuboid
  detector (the port's, with the EDT kernel on the card) on the frame's 2D
  boxes + line segments; keep the best proposal per box as a camera-frame
  measurement with a quality weight,
* keypoint->object ownership (Tracking.cc:1716-1845): keypoints inside a
  (non-overlapping) detection box vote for the object; a detection becomes
  a candidate landmark once it owns enough points,
* AssociateCuboids (Tracking.cc:1848-2028): candidate vs existing landmark
  association by shared-map-point voting; unmatched candidates found in
  enough keyframes become new landmarks; landmarks merge new measurements,
* object edges for the BA (graph/object_ba.py): camera-object bbox edges
  per detection, point-object hinge edges from owned map points.
"""

from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..utils import np_geometry as np_geo

logger = logging.getLogger("cube_slam_tpu_torch")


@dataclass
class Detection:
    """One per-keyframe cuboid measurement (MapObject's cube_meas analog)."""

    kf_id: int
    local_pose: np.ndarray   # (4, 4) cuboid in camera frame
    scale: np.ndarray        # (3,)
    bbox: np.ndarray         # (4,) [cx cy w h] detected 2D box
    quality: float
    owned_kps: np.ndarray    # keypoint indices inside the box
    landmark: int = -1       # associated object id
    tracklet_id: int = -1    # ground-truth tracklet id (KITTI offline mode)
    age: int = -1            # ObjectManager kf-step counter at creation
    at_border: bool = False  # 2D box clipped by the image border: the
    # unclipped corner-projection bbox model is then WRONG (out-of-frame
    # corners inflate it, biasing the object deep), so such measurements
    # contribute no bbox edge (Tracking.cc:1600-1605, :1970 drops
    # near-boundary boxes for the same reason)


@dataclass
class ObjectStore:
    max_obj: int = 16

    def __post_init__(self):
        O = self.max_obj
        self.pose = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
        self.scale = np.ones((O, 3), dtype=np.float32)
        self.valid = np.zeros(O, dtype=bool)
        self.n_obs = np.zeros(O, dtype=np.int32)
        self.quality = np.zeros(O, dtype=np.float32)
        self.fix_scale = np.zeros(O, dtype=bool)
        # slot generation, bumped at alloc: an ASYNC object-BA fold must
        # not write a dead landmark's optimized pose into a recycled slot
        self.gen = np.zeros(O, dtype=np.int64)

    def alloc(self):
        free = np.where(~self.valid)[0]
        if len(free) == 0:
            return -1
        self.gen[free[0]] += 1
        return int(free[0])

    def clear(self):
        """Wipe all landmarks (system Reset)."""
        self.__post_init__()

    @classmethod
    def from_arrays(cls, arrays):
        """A store filled from a dict of its arrays (the attributes of the
        JAX package's ObjectStore as numpy: `vars(jax_store)`), so landmarks
        built by one package can be carried into the other. The capacity
        comes from the arrays' shapes."""
        arrays = dict(arrays)
        st = cls(max_obj=int(np.asarray(arrays["valid"]).shape[0]))
        for name, value in arrays.items():
            if name == "max_obj":
                continue
            ref = getattr(st, name)
            value = np.asarray(value)
            if value.shape != ref.shape:
                raise ValueError(f"{name}: shape {value.shape}, expected {ref.shape}")
            setattr(st, name, value.astype(ref.dtype, copy=True))
        return st


class ObjectManager:
    """Host-side object lifecycle; device work stays in the detector and
    the object BA."""

    def __init__(self, detector, store: ObjectStore | None = None,
                 min_owned_points=20, min_shared_votes=8, bbox_overlap_max=0.15,
                 min_obs_to_promote=2, min_shared_promote=5,
                 fixed_scale_prior=None, meas_cap=32, pending_max_age=8):
        self.detector = detector
        self.store = store or ObjectStore()
        # PENDING candidate detections (landmark == -2), bounded by age:
        # the association currency of Tracking.cc:1848-1923. Associated
        # measurements move into the per-landmark ring `meas` — the
        # MergeIntoLandmark history (MapObject.cc:108) with a cap, so
        # association cost is independent of run length.
        self.detections: list[Detection] = []
        self.meas: dict[int, object] = {}     # landmark -> deque[Detection]
        self.first_seen: dict[int, int] = {}  # landmark -> kf-step counter
        self._kf_counter = 0
        self.meas_cap = meas_cap
        self.pending_max_age = pending_max_age
        self.min_owned_points = min_owned_points
        self.min_shared_votes = min_shared_votes
        self.bbox_overlap_max = bbox_overlap_max
        self.min_obs_to_promote = min_obs_to_promote
        # candidate-candidate promotion threshold (Tracking.cc:1879-1923
        # uses 10/20/5 common points depending on mode)
        self.min_shared_promote = min_shared_promote
        # KITTI car prior (Tracking.cc:1949-1957, Optimizer.cc:994):
        # landmarks get this FIXED half-scale when set
        self.fixed_scale_prior = (
            np.asarray(fixed_scale_prior, dtype=np.float32)
            if fixed_scale_prior is not None else None)
        self.trackletid_to_landmark: dict[int, int] = {}

    def reset(self):
        """Clear landmarks and measurement history, keep configuration
        (called from the tracker's System::Reset analog)."""
        self.store.clear()
        self.detections = []
        self.meas = {}
        self.first_seen = {}
        self._kf_counter = 0
        self.trackletid_to_landmark = {}

    def load_state(self, fields):
        """Take over another manager's state from a dict of its fields (the
        JAX package's ObjectManager as `vars(jax_manager)`): the store
        (ObjectStore.from_arrays), the pending candidates, the per-landmark
        measurement rings, the counters and the thresholds. Detections are
        copied once each, so a detection held in two places stays one
        object. The detector is not carried."""
        copies = {}

        def det(d):
            if id(d) not in copies:
                kw = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in vars(d).items()}
                copies[id(d)] = Detection(**kw)
            return copies[id(d)]

        for name, value in fields.items():
            if name == "detector":
                continue
            if name == "store":
                value = ObjectStore.from_arrays(vars(value))
            elif name == "detections":
                value = [det(d) for d in value]
            elif name == "meas":
                value = {int(o): deque((det(d) for d in dq), maxlen=dq.maxlen)
                         for o, dq in value.items()}
            elif name == "fixed_scale_prior":
                value = None if value is None else np.asarray(value, dtype=np.float32).copy()
            elif isinstance(value, dict):
                value = dict(value)
            setattr(self, name, value)

    def _add_meas(self, o, det):
        """Attach a measurement to a landmark's bounded history
        (MergeIntoLandmark, MapObject.cc:108 — ring-buffered)."""
        dq = self.meas.get(o)
        if dq is None:
            dq = self.meas[o] = deque(maxlen=self.meas_cap)
            self.first_seen.setdefault(o, self._kf_counter)
        dq.append(det)

    def _prune_pending(self):
        """Bound the pending-candidate list: associated or stale entries
        leave (the reference culls unpromoted candidates the same way,
        Tracking.cc:1986-2027)."""
        self.detections = [
            d for d in self.detections
            if d.landmark == -2
            and self._kf_counter - d.age <= self.pending_max_age]

    # ------------------------------------------------------------------
    @staticmethod
    def _iou(a, b):
        ax1, ay1, ax2, ay2 = a[0], a[1], a[0] + a[2], a[1] + a[3]
        bx1, by1, bx2, by2 = b[0], b[1], b[0] + b[2], b[1] + b[3]
        ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
        iy = max(0.0, min(ay2, by2) - max(ay1, by1))
        inter = ix * iy
        union = a[2] * a[3] + b[2] * b[3] - inter
        return inter / union if union > 0 else 0.0

    def detect_on_keyframe(self, map_state, kf_id, gray, bboxes_2d, lines, Twc):
        """Run the cuboid detector for a keyframe and record camera-frame
        measurements + keypoint ownership. bboxes_2d: (B, >=4) [x y w h]."""
        if bboxes_2d is None or len(bboxes_2d) == 0:
            return []
        # drop heavily-overlapping boxes (Tracking.cc:1716-1781 keeps
        # ownership unambiguous)
        keep = []
        for i in range(len(bboxes_2d)):
            if all(self._iou(bboxes_2d[i], bboxes_2d[j]) <= self.bbox_overlap_max
                   for j in keep):
                keep.append(i)
        boxes = np.asarray(bboxes_2d)[keep]

        props = self.detector.detect_cuboid(gray, Twc, boxes[:, :4], lines)
        Tcw = np_geo.inv_T(np.asarray(Twc, dtype=np.float64))
        out = []
        kp_xy = map_state.kf_kp_xy[kf_id]
        kp_ok = map_state.kf_kp_valid[kf_id]
        for b, plist in enumerate(props):
            if not plist:
                continue
            p = plist[0]
            pose_w, scale = np_geo.minimal9_to_pose_scale(
                [p.pos[0], p.pos[1], p.pos[2], 0.0, 0.0, p.rotY,
                 p.scale[0], p.scale[1], p.scale[2]]
            )
            local_pose = (Tcw @ pose_w).astype(np.float32)
            x, y, w, h = boxes[b, :4]
            inside = (
                kp_ok
                & (kp_xy[:, 0] >= x) & (kp_xy[:, 0] <= x + w)
                & (kp_xy[:, 1] >= y) & (kp_xy[:, 1] <= y + h)
            )
            quality = max(0.1, min(1.0, (1.0 - p.normalized_error + 0.5) / 2.0))
            H, W = np.asarray(gray).shape[:2]
            th = 20
            at_border = bool(x < th or y < th or x + w > W - th
                             or y + h > H - th)
            det = Detection(
                kf_id=kf_id, local_pose=local_pose,
                scale=scale.astype(np.float32),
                bbox=np.array([x + w / 2.0, y + h / 2.0, w, h], dtype=np.float32),
                quality=float(quality), owned_kps=np.where(inside)[0],
                at_border=at_border,
            )
            out.append(det)
        return out

    # ------------------------------------------------------------------
    def ingest_offline(self, map_state, kf_id, rows, init_to_ground,
                       use_truth_trackid=False, img_wh=None,
                       border_threshold=20):
        """Offline per-frame cuboid txt rows -> camera-frame Detections
        (Tracking.cc:1553-1580 + measurement wrapping :1626-1694).

        rows: (N, 12|13) [center(3) yaw scale(3) x1 y1 w h prob (tid)] in
        the LOCAL GROUND frame; init_to_ground: the (approximately
        constant) camera-to-ground transform — cube_local_meas =
        inv(init_to_ground) o pose_localground. Quality = confidence x
        (60 - clamp(z, 10, 30)) / 40 (Tracking.cc:1683-1689)."""
        if rows is None or len(rows) == 0:
            return []
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
        Tgc = np_geo.inv_T(np.asarray(init_to_ground, dtype=np.float64))
        m = map_state
        kp_xy = m.kf_kp_xy[kf_id]
        kp_ok = m.kf_kp_valid[kf_id]
        out = []
        for r in rows:
            pose_g, scale = np_geo.minimal9_to_pose_scale(
                [r[0], r[1], r[2], 0.0, 0.0, r[3], r[4], r[5], r[6]])
            local_pose = (Tgc @ pose_g).astype(np.float32)
            x, y, w, h = r[7:11]
            prob = float(r[11]) if len(r) > 11 else 1.0
            tid = int(r[12]) if (use_truth_trackid and len(r) > 12) else -1
            z = float(np.clip(local_pose[2, 3], 10.0, 30.0))
            quality = (60.0 - z) / 40.0
            if prob > 0:
                quality *= prob
            inside = (
                kp_ok
                & (kp_xy[:, 0] >= x) & (kp_xy[:, 0] <= x + w)
                & (kp_xy[:, 1] >= y) & (kp_xy[:, 1] <= y + h)
            )
            at_border = False
            if img_wh is not None:
                at_border = bool(
                    x < border_threshold or y < border_threshold
                    or x + w > img_wh[0] - border_threshold
                    or y + h > img_wh[1] - border_threshold)
            det = Detection(
                kf_id=kf_id, local_pose=local_pose,
                scale=scale.astype(np.float32),
                bbox=np.array([x + w / 2.0, y + h / 2.0, w, h], dtype=np.float32),
                quality=float(max(quality, 0.1)),
                owned_kps=np.where(inside)[0],
                tracklet_id=tid,
                at_border=at_border,
            )
            out.append(det)
        return out

    def _new_landmark(self, map_state, det):
        """Create a landmark from a detection (SetAsLandmark + the KITTI
        fixed-scale reset, Tracking.cc:1943-1961)."""
        st = self.store
        o = st.alloc()
        if o < 0:
            logger.warning("object store full; dropping landmark")
            return -1
        Twc = np_geo.inv_T(map_state.kf_tcw[det.kf_id].astype(np.float64))
        st.pose[o] = (Twc @ det.local_pose).astype(np.float32)
        if self.fixed_scale_prior is not None:
            st.scale[o] = self.fixed_scale_prior
            st.fix_scale[o] = True
        else:
            st.scale[o] = det.scale
        st.valid[o] = True
        st.n_obs[o] = 1
        st.quality[o] = det.quality
        return o

    def associate_by_tracklet(self, map_state, kf_id, dets):
        """Ground-truth tracklet-id association (Tracking.cc:1925-1982):
        each tracklet id maps to one landmark; new ids create landmarks
        (with the fixed-scale prior in KITTI mode); repeat sightings update
        the landmark pose to the latest measurement (SetWorldPos)."""
        m = map_state
        st = self.store
        self._kf_counter += 1
        for det in dets:
            if det.tracklet_id < 0:
                continue
            o = self.trackletid_to_landmark.get(det.tracklet_id, -1)
            if o < 0 or not st.valid[o]:
                o = self._new_landmark(m, det)
                if o < 0:
                    continue
                self.trackletid_to_landmark[det.tracklet_id] = o
            else:
                Twc = np_geo.inv_T(m.kf_tcw[det.kf_id].astype(np.float64))
                pose_w = (Twc @ det.local_pose).astype(np.float32)
                if self.fixed_scale_prior is None:
                    st.scale[o] = det.scale
                st.pose[o] = pose_w
                st.n_obs[o] += 1
                st.quality[o] = max(st.quality[o], det.quality)
            det.landmark = int(o)
            self._add_meas(int(o), det)
            owned_mps = m.kf_kp_mp[det.kf_id, det.owned_kps]
            owned_mps = owned_mps[owned_mps >= 0]
            if len(owned_mps):
                m.mp_best_obj[owned_mps] = det.landmark

    # ------------------------------------------------------------------
    def associate(self, map_state, kf_id, dets):
        """Shared-map-point voting association (Tracking.cc:1848-2028)."""
        m = map_state
        st = self.store
        self._kf_counter += 1
        for det in dets:
            det.age = self._kf_counter
            owned_mps = m.kf_kp_mp[det.kf_id, det.owned_kps]
            owned_mps = owned_mps[owned_mps >= 0]
            if len(det.owned_kps) < self.min_owned_points:
                continue
            # votes: landmark owning the most of this detection's points
            votes = np.zeros(st.max_obj, dtype=np.int32)
            if len(owned_mps):
                objs = m.mp_best_obj[owned_mps]
                for o in objs[objs >= 0]:
                    votes[o] += 1
            best = int(np.argmax(votes)) if votes.max() > 0 else -1
            if best >= 0 and votes[best] >= self.min_shared_votes and st.valid[best]:
                det.landmark = best
                st.n_obs[best] += 1
                st.quality[best] = max(st.quality[best], det.quality)
                self._add_meas(best, det)
            else:
                # unmatched: look for an unassociated previous detection of
                # the same object by SHARED-MAP-POINT voting — two candidate
                # detections are the same object when they own enough common
                # points (Tracking.cc:1879-1923; the reference's thresholds
                # 10/20/5 by mode map to min_shared_promote). Pose proximity
                # is only the degenerate fallback when neither detection
                # owns any mapped point yet.
                prev = [d for d in self.detections
                        if d.landmark == -2 and d.kf_id != det.kf_id]
                det.landmark = -2  # provisional
                matched_prev = [
                    d for d in prev
                    if self._shared_points(m, d, det) >= self.min_shared_promote
                    or (len(owned_mps) == 0 and self._pose_close(d, det, m))
                ]
                n_seen = 1 + len(matched_prev)
                if n_seen >= self.min_obs_to_promote:
                    o = st.alloc()
                    if o < 0:
                        continue
                    Twc = np_geo.inv_T(m.kf_tcw[det.kf_id].astype(np.float64))
                    st.pose[o] = (Twc @ det.local_pose).astype(np.float32)
                    st.scale[o] = det.scale
                    st.valid[o] = True
                    st.n_obs[o] = n_seen
                    st.quality[o] = det.quality
                    det.landmark = o
                    self._add_meas(o, det)
                    for d in matched_prev:
                        d.landmark = o
                        self._add_meas(o, d)
                else:
                    self.detections.append(det)
            # point ownership votes
            if det.landmark >= 0 and len(owned_mps):
                m.mp_best_obj[owned_mps] = det.landmark
        self._prune_pending()

    def _shared_points(self, map_state, d1, d2):
        """Number of map points owned by BOTH detections (the association
        currency of Tracking.cc:1848-1923)."""
        m = map_state
        a = m.kf_kp_mp[d1.kf_id, d1.owned_kps]
        b = m.kf_kp_mp[d2.kf_id, d2.owned_kps]
        a = a[a >= 0]
        if len(a) == 0:
            return 0
        return int(np.isin(b[b >= 0], a).sum())

    def _pose_close(self, d1, d2, map_state, max_dist=1.5):
        m = map_state
        w1 = np_geo.inv_T(m.kf_tcw[d1.kf_id].astype(np.float64)) @ d1.local_pose
        w2 = np_geo.inv_T(m.kf_tcw[d2.kf_id].astype(np.float64)) @ d2.local_pose
        return np.linalg.norm(w1[:3, 3] - w2[:3, 3]) < max_dist

    # ------------------------------------------------------------------
    def filter_and_recenter(self, map_state, coarse_factor=1.8,
                            fine_factor=1.35, min_points_recenter=5,
                            vol_factor=1.45):
        """Owned-point outlier filter + object re-centering pre-pass
        (Optimizer.cc:1180-1224): per object, two-round distance-to-mean
        filtering of its owned points; outliers lose their ownership vote,
        and when enough points survive the object's position is reset to
        their mean before BA.

        The reference hardcodes 4 m / 3 m — car-sized absolutes (KITTI car
        half-diagonal ~2.2 m: factors 1.8 / 1.35 of it). Absolute metric
        thresholds are meaningless for a 0.4 m indoor object (every
        background point inside the 2D box passes, and the recenter mean
        drags the object into the wall behind it), so the thresholds scale
        with the object's own half-diagonal — equal to the reference's
        values at car scale, proportionally tight for small objects.

        Beyond the reference: an OBJECT-FRAME VOLUME gate. Ownership votes
        come from axis-aligned 2D boxes, which over-cover the silhouette,
        so BACKGROUND points (systematically deeper than the object) leak
        in; when they outnumber surface points, the distance-to-mean
        filter keeps the wrong cluster and the recenter mean drags the
        object into the wall behind it. A point can only keep its vote if
        it lies inside the cuboid inflated by `vol_factor` in the object's
        own frame — background leakage is cut by construction."""
        m = map_state
        st = self.store
        for o in np.where(st.valid)[0]:
            ids = np.where(m.mp_valid & (m.mp_best_obj == o))[0]
            if len(ids) == 0:
                continue
            half_diag = float(np.linalg.norm(st.scale[o]))
            coarse_threshold = coarse_factor * half_diag
            fine_threshold = fine_factor * half_diag
            p = m.mp_pos[ids].astype(np.float64)
            mean1 = p.mean(axis=0)
            coarse = np.linalg.norm(p - mean1, axis=1) < coarse_threshold
            if not coarse.any():
                continue
            mean2 = p[coarse].mean(axis=0)
            fine = np.linalg.norm(p - mean2, axis=1) < fine_threshold
            # object-frame volume gate (pose = latest measurement-anchored
            # estimate; a small absolute margin tolerates pose error)
            Tow = np_geo.inv_T(st.pose[o].astype(np.float64))
            p_obj = p @ Tow[:3, :3].T + Tow[:3, 3]
            bound = vol_factor * st.scale[o].astype(np.float64) \
                + 0.1 * half_diag
            in_vol = np.all(np.abs(p_obj) <= bound, axis=1)
            if (fine & in_vol).sum() > min_points_recenter:
                fine &= in_vol
            if fine.sum() <= min_points_recenter:
                # too few survivors to trust the filter: keep ownership as
                # is — stripping every vote would leave the object with
                # only depth-ambiguous bbox edges
                continue
            # outliers lose the ownership vote ("else remove observation")
            m.mp_best_obj[ids[~fine]] = -1
            st.pose[o][:3, 3] = p[fine].mean(axis=0).astype(np.float32)

    # ------------------------------------------------------------------
    def ba_edges(self, map_state, kf_map, max_box_edges=64, max_po_edges=512,
                 camera_object_weight=1.0):
        """Assemble bbox + point-object edge arrays for local_ba_objects.

        kf_map: dict global kf id -> local BA camera index. The max_*
        arguments are FLOORS: capacities grow in pow2 buckets to the real
        edge counts (the reference never drops edges from the joint solve;
        buckets bound recompiles to log2 of the range)."""
        m = map_state
        st = self.store

        def _pow2(n, lo):
            return max(lo, 1 << int(np.ceil(np.log2(max(int(n), 1)))))

        n_meas = sum(len(self.meas.get(int(o), ()))
                     for o in np.where(st.valid)[0])
        max_box_edges = _pow2(n_meas, max_box_edges)
        n_owned_all = int((m.mp_valid & (m.mp_best_obj >= 0)).sum())
        max_po_edges = _pow2(n_owned_all, max_po_edges)
        box_kf = np.zeros(max_box_edges, dtype=np.int32)
        box_obj = np.zeros(max_box_edges, dtype=np.int32)
        box_meas = np.zeros((max_box_edges, 4), dtype=np.float32)
        box_si = np.ones(max_box_edges, dtype=np.float32)
        box_valid = np.zeros(max_box_edges, dtype=bool)
        # 9-DoF camera-cuboid measurement edges (EdgeSE3Cuboid, the demo's
        # family, main_obj.cpp:531-544): the ONLY observation that pins the
        # cuboid's depth extent at frontal views (bbox edges are depth-
        # blind there, owned points cover only visible faces). Padding
        # poses are IDENTITY, not zeros — se3_log of a zero matrix is NaN,
        # and NaN*0 still poisons the masked residual.
        meas_kf = np.zeros(max_box_edges, dtype=np.int32)
        meas_obj = np.zeros(max_box_edges, dtype=np.int32)
        meas_pose = np.tile(np.eye(4, dtype=np.float32), (max_box_edges, 1, 1))
        meas_scale = np.ones((max_box_edges, 3), dtype=np.float32)
        meas_si = np.zeros(max_box_edges, dtype=np.float32)
        meas_valid = np.zeros(max_box_edges, dtype=bool)
        n = 0
        ring = [d for o in np.where(st.valid)[0]
                for d in self.meas.get(int(o), ())]
        n_eligible = sum(1 for d in ring
                         if d.landmark >= 0 and d.kf_id in kf_map)
        if n_eligible > max_box_edges:
            logger.warning("object BA: clipping %d -> %d bbox edges",
                           n_eligible, max_box_edges)
        for det in ring:
            if det.landmark < 0 or det.kf_id not in kf_map or n >= max_box_edges:
                continue
            if det.at_border:
                continue
            box_kf[n] = kf_map[det.kf_id]
            box_obj[n] = det.landmark
            box_meas[n] = det.bbox
            # info ~ weight * quality^2 -> sqrt-info ~ sqrt(w) * quality
            box_si[n] = np.sqrt(camera_object_weight) * det.quality
            box_valid[n] = True
            meas_kf[n] = box_kf[n]
            meas_obj[n] = det.landmark
            meas_pose[n] = det.local_pose
            meas_scale[n] = det.scale
            # info proportional to measurement quality (main_obj.cpp:538)
            meas_si[n] = det.quality
            meas_valid[n] = True
            n += 1

        po_obj = np.zeros(max_po_edges, dtype=np.int32)
        po_pt = np.zeros(max_po_edges, dtype=np.int32)
        po_si = np.ones(max_po_edges, dtype=np.float32)
        po_valid = np.zeros(max_po_edges, dtype=bool)
        q = 0
        owned = np.where(m.mp_valid & (m.mp_best_obj >= 0))[0]
        if len(owned) > max_po_edges:
            logger.warning("object BA: clipping %d -> %d point-object edges",
                           len(owned), max_po_edges)
        # per-object 1/sqrt(n) weights: the reference sums ONE edge per
        # object whose error is the MEAN over its points (g2o_Object.cpp:
        # 308-315) — per-point edges at unit weight would scale the point
        # family by n_points relative to the bbox/measurement families
        n_owned = np.bincount(m.mp_best_obj[owned], minlength=st.pose.shape[0])
        for mp in owned[:max_po_edges]:
            po_obj[q] = m.mp_best_obj[mp]
            po_pt[q] = mp
            po_si[q] = 1.0 / np.sqrt(max(int(n_owned[po_obj[q]]), 1))
            po_valid[q] = bool(st.valid[po_obj[q]])
            q += 1
        return (box_kf, box_obj, box_meas, box_si, box_valid,
                po_obj, po_pt, po_si, po_valid,
                meas_kf, meas_obj, meas_pose, meas_scale, meas_si, meas_valid)

    def cull(self, map_state):
        """Remove landmarks with too few observations after a while
        (Tracking.cc:1986-2027, simplified): a landmark first seen >= 3
        keyframe steps ago that never reached 2 sightings goes away.
        Landmarks whose BA scale collapsed to the exp_update floor are
        geometry wrecks (bad ownership under map-scale churn) — cull them
        too so a fresh candidate can re-form instead of the association
        step feeding the wreck forever."""
        st = self.store
        for o in np.where(st.valid)[0]:
            age = self._kf_counter - self.first_seen.get(int(o),
                                                         self._kf_counter)
            starved = age >= 3 and st.n_obs[o] < 2
            wrecked = (not st.fix_scale[o]
                       and float(st.scale[o].min()) <= 0.02)
            if starved or wrecked:
                st.valid[o] = False
                self.meas.pop(int(o), None)
                self.first_seen.pop(int(o), None)
                map_state.mp_best_obj[map_state.mp_best_obj == o] = -1
