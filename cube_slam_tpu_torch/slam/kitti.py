"""KITTI-mode monocular and stereo object SLAM — the reference's headline
configuration.

PyTorch counterpart of cube_slam_tpu/slam/kitti.py. The re-design of the
mono-KITTI pipeline
(Examples/Monocular/mono_kitti.cc:37-58 + Tracking_util.cc:25-206 +
Tracking.cc:1553-1580, :1925-1961, :2433-2663):

* file-driven frame sequence (utils/io.KittiSequence),
* OFFLINE per-frame cuboid txts with ground-truth tracklet ids feeding the
  object pipeline instead of the live detector (no detector is built, so
  no EDT kernel launches on these paths),
* fixed-scale car prior 1.9420 x 0.8143 x 0.7631 on object landmarks
  (Tracking.cc:1949-1957, Optimizer.cc:994),
* monocular scale initialization from object depth
  (MonoObjDepthInitialization, Tracking.cc:852-930),
* ground-plane scale recovery every few keyframes (Tracking.cc:2433-2663),
* camera + point + object local BA with fix-scale cuboid vertices,
* with dynamic=True, the mono_dynamic configuration: tracklets become
  MOVING objects (slam/dynamic.py) with per-keyframe poses, a
  planar-bicycle velocity and a joint dynamic BA with the window cameras
  free; no KLT features, no object-depth anchor, no ground recovery.

The scale anchor, the depth bootstraps and the ground recovery rewrite the
map, the pose and the motion model on the host in numpy, as in the JAX
package; the map version is bumped after each, so the device copies and the
device tracker state re-seed at the next frame.
"""

from __future__ import annotations

import logging

import numpy as np

from ..utils import np_geometry as np_geo
from ..utils import profiler
from .ground import GroundConfig, GroundScaleEstimator
from .objects import ObjectManager
from .system import MonocularTracker, ObjectSlamTracker, StereoTracker, TrackerConfig

logger = logging.getLogger("cube_slam_tpu_torch")

KITTI_CAR_PRIOR = (1.9420, 0.8143, 0.7631)


def _ray_cuboid_depth(K, xy, local_pose, scale):
    """Camera-frame z of the first hit of each pixel ray with the cuboid
    (slab test in the object frame). xy: (N, 2). Returns (N,) z (0 = miss)."""
    if len(xy) == 0:
        return np.zeros(0, dtype=np.float32)
    Kinv = np.linalg.inv(np.asarray(K, dtype=np.float64))
    rays = np.concatenate([xy, np.ones((len(xy), 1))], axis=1) @ Kinv.T
    inv_P = np_geo.inv_T(np.asarray(local_pose, dtype=np.float64))
    o = np.broadcast_to(inv_P[:3, 3], rays.shape)
    dvec = rays @ inv_P[:3, :3].T
    s = np.asarray(scale, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-s - o) / dvec
        t2 = (s - o) / dvec
    t_near = np.nanmax(np.minimum(t1, t2), axis=1)
    t_far = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (t_near <= t_far) & (t_near > 0.1)
    # camera-frame z of the hit: ray has unit z, so z = t (ray param)
    return np.where(hit, t_near, 0.0).astype(np.float32)


def _local_pose(init_to_ground, r):
    """An offline row's cuboid in the camera frame (float64) and its
    half-scale: cube_local_meas = inv(init_to_ground) o pose_localground."""
    pose_g, scale = np_geo.minimal9_to_pose_scale([r[0], r[1], r[2], 0.0, 0.0, r[3], r[4], r[5], r[6]])
    return np_geo.inv_T(init_to_ground) @ pose_g, scale


class KittiMonoTracker(ObjectSlamTracker):
    """Monocular tracker driven by offline per-frame cuboid txts with
    tracklet ids (the reference's `whether_read_offline_cuboidtxt` +
    `use_truth_trackid` KITTI mode). Drive it with track(gray) per frame,
    then final_trajectory() and objects.store."""

    def __init__(self, K, img_wh, offline_cuboids, init_to_ground,
                 config: TrackerConfig | None = None,
                 use_truth_trackid=True, car_prior=KITTI_CAR_PRIOR,
                 ground_cfg: GroundConfig | None = None,
                 camera_object_weight=1.0,
                 cam_ground_normal=(0.0, -1.0, 0.0),
                 firstframe_depth_init=False,
                 dynamic=False, dyn_manager=None, frame_stamps=None,
                 first_depth=None, device=None):
        """offline_cuboids: per frame an (N, 12|13) array of rows
        [centre(3) yaw half-scale(3) x y w h prob (tid)] in the local ground
        frame, or None. init_to_ground: the first camera's pose in that
        frame (constant camera-to-ground mount). firstframe_depth_init
        bootstraps the map from the first frame's object depth;
        first_depth (an (H, W) metric depth image of the first frame) from
        that image.

        dynamic=True runs the reference's mono_dynamic configuration:
        every tracklet becomes a MOVING object with per-keyframe poses, a
        planar-bicycle velocity, and motion + bbox edges in a joint dynamic
        BA with the window cameras free (Tracking.cc:2144-2425 +
        Optimizer.cc:1537-2573, launch/mono_dynamic.launch flag set:
        ba_dyna_pt_obj_cam=false, use_dynamic_klt_features=false). Keypoints
        inside the tracklets' boxes are kept out of the static map; the
        object-depth anchor and ground recovery do not run. dyn_manager
        replaces the default DynamicObjectManager; frame_stamps gives the
        motion model its times (frame ids otherwise)."""
        # MonocularTracker's constructor, not ObjectSlamTracker's: the KITTI
        # mode reads offline cuboids and builds no detector
        MonocularTracker.__init__(self, K, img_wh, config, device=device)
        self.objects = ObjectManager(detector=None, fixed_scale_prior=car_prior)
        self.offline = offline_cuboids  # list per frame of (N, 12|13) rows
        self.init_to_ground = np.asarray(init_to_ground, dtype=np.float64)
        self.use_truth_trackid = use_truth_trackid
        self.camera_object_weight = camera_object_weight
        self.car_prior = np.asarray(car_prior, dtype=np.float32)
        self.ground = GroundScaleEstimator(ground_cfg, device=self.device)
        self.cam_ground_normal = cam_ground_normal
        self.ground_align = None
        self.mono_scale_initialized = False
        self.n_scale_recoveries = 0
        self.firstframe_depth_init = firstframe_depth_init
        self._anchor_scales = []  # applied object-depth scale corrections
        self.frame_stamps = frame_stamps  # per-frame times (None = frame id)
        # mono_firstframe_truth_depth_init (mono_dynamic.launch:42): a
        # metric depth image for the FIRST frame bootstraps the map at
        # true scale
        self.first_depth = first_depth
        self.dynamic = None
        if dynamic:
            from .dynamic import DynamicObjectManager

            # SLAM world = first camera frame; the motion model runs over
            # the z-up ground frame via the InitToGround alignment
            self.dynamic = dyn_manager or DynamicObjectManager(world_T_slam=self.init_to_ground, device=self.device)

    # ------------------------------------------------------------------
    def track(self, gray):
        """Process one frame; returns Tcw (4, 4) or None."""
        with profiler.frame(self.frame_id + 1):
            was_uninit = self.state == "NOT_INITIALIZED"
            out = MonocularTracker.track(self, gray)
            if was_uninit and self.state == "OK":
                self._offline_depth_scale_init()
                self._bump_map()
        return out

    def reset(self):
        ObjectSlamTracker.reset(self)
        self.ground = GroundScaleEstimator(self.ground.cfg, device=self.device)
        self._anchor_scales = []
        if self.dynamic is not None:
            self.dynamic.chains = {}

    def _rows_for(self, frame_id):
        if self.offline is not None and 0 <= frame_id < len(self.offline):
            rows = self.offline[frame_id]
            if rows is not None and np.size(rows):
                return np.atleast_2d(rows)
        return None

    def _dyn_dets_for(self, frame_id):
        """Offline rows -> DynamicDetections (camera-frame cuboid pose +
        bbox, no instance mask — use_dynamic_klt_features=false)."""
        from .dynamic import DynamicDetection

        rows = self._rows_for(frame_id)
        if rows is None:
            return []
        dets = []
        for r in rows:
            tid = int(r[12]) if len(r) > 12 else -1
            if tid < 0:
                continue
            local_pose = _local_pose(self.init_to_ground, r)[0].astype(np.float32)
            if float(local_pose[2, 3]) <= 0.5:
                continue
            dets.append(DynamicDetection(tracklet_id=tid, local_pose=local_pose, scale=self.car_prior,
                                         bbox=np.asarray(r[7:11], dtype=np.float32), mask=None))
        return dets

    def _suppress_dev(self, gray):
        """Dynamic mode: drop keypoints inside moving-car boxes from the
        static pipeline (KeysStatic via bbox rectangles — no masks in the
        offline-txt configuration), as a device mask."""
        if self.dynamic is None:
            return MonocularTracker._suppress_dev(self, gray)
        rows = self._rows_for(self.frame_id)
        if rows is None:
            return MonocularTracker._suppress_dev(self, gray)
        g = np.asarray(gray)
        mask = np.zeros(g.shape, dtype=np.float32)
        H, W = g.shape
        for r in rows:
            x, y, w, h = int(max(r[7], 0)), int(max(r[8], 0)), int(r[9]), int(r[10])
            mask[y:min(y + h, H), x:min(x + w, W)] = 1.0
        return self._t(mask)

    # ------------------------------------------------------------------
    def _try_initialize(self, feats):
        """mono_firstframe_Obj_depth_init (MonoObjDepthInitialization,
        Tracking.cc:852-930): when the first frame carries an object
        measurement, bootstrap the map single-frame by unprojecting the
        object's keypoints at the cuboid's metric camera depth — the map is
        METRIC from frame zero. A first-frame depth image bootstraps it the
        same way. Falls back to two-view initialization.

        Off by default: with few in-box features the bootstrapped map is
        small and near-coplanar, which makes frame-to-frame tracking
        fragile (the reference gates it on N > 500 features); the two-view
        init + per-keyframe object-depth anchor is the robust path."""
        if self.dynamic is not None:
            # moving-object pixels must not seed STATIC map points — the
            # init path bypasses the tracking step's suppression mask
            rows_d = self._rows_for(self.frame_id)
            if rows_d is not None:
                xy, v = feats.xy, feats.valid.copy()
                for r in rows_d:
                    x, y, w, h = r[7:11]
                    v &= ~((xy[:, 0] >= x) & (xy[:, 0] <= x + w) & (xy[:, 1] >= y) & (xy[:, 1] <= y + h))
                feats.restrict_valid(v)
        if self.first_depth is not None:
            # truth-depth bootstrap (mono_firstframe_truth_depth_init,
            # Tracking.cc StereoInitialization-style): metric from frame 0
            d_img = np.asarray(self.first_depth, dtype=np.float32)
            H, W = d_img.shape
            xi = np.clip(np.round(feats.xy[:, 0]).astype(int), 0, W - 1)
            yi = np.clip(np.round(feats.xy[:, 1]).astype(int), 0, H - 1)
            d = d_img[yi, xi]
            d = np.where(feats.valid & (d > 0.1) & (d < 120.0), d, 0.0).astype(np.float32)
            if (d > 0).sum() >= 30 and self._depth_seed_initialize(feats, d):
                self.mono_scale_initialized = True
                self.first_depth = None
                logger.info("mono map bootstrapped from first-frame depth (%d points)", int((d > 0).sum()))
                return True
        rows = self._rows_for(self.frame_id)
        if self.firstframe_depth_init and rows is not None:
            d = np.zeros(len(feats.valid), dtype=np.float32)
            for r in rows:
                local_pose, scale = _local_pose(self.init_to_ground, r)
                if float(local_pose[2, 3]) <= 0.5:
                    continue
                x, y, w, h = r[7:11]
                inside = (feats.valid
                          & (feats.xy[:, 0] >= x) & (feats.xy[:, 0] <= x + w)
                          & (feats.xy[:, 1] >= y) & (feats.xy[:, 1] <= y + h))
                # per-keypoint depth from exact ray-cuboid intersection
                # (sharper than the reference's constant cuboid-center z)
                d_ray = _ray_cuboid_depth(self.K, feats.xy[inside], local_pose, scale)
                d[inside] = np.where(d_ray > 0, d_ray, float(local_pose[2, 3]))
            if (d > 0).sum() >= 30 and self._depth_seed_initialize(feats, d):
                self.mono_scale_initialized = True
                logger.info("mono map bootstrapped from object depth (%d points)", int((d > 0).sum()))
                return True
        return MonocularTracker._try_initialize(self, feats)

    def _depth_seed_initialize(self, feats, d):
        """Single-keyframe map bootstrap from per-keypoint depths (host
        numpy: float64 unprojection, float32 points)."""
        m = self.map
        good = d > 0
        kf0 = self._insert_keyframe_raw(feats, np.eye(4, dtype=np.float32), self.frame_id)
        Kinv = np.linalg.inv(self.K.astype(np.float64))
        uv1 = np.concatenate([feats.xy, np.ones((len(feats.xy), 1))], axis=1)
        pts = (uv1 @ Kinv.T) * d[:, None]
        sel = np.where(good)[0]
        ids = m.alloc_mps(len(sel))
        sel = sel[: len(ids)]
        m.mp_pos[ids] = pts[sel].astype(np.float32)
        m.mp_valid[ids] = True
        m.mp_desc[ids] = feats.desc[sel]
        m.mp_level[ids] = feats.level[sel]
        m.mp_first_kf[ids] = kf0
        m.mp_nobs[ids] = 1
        m.kf_kp_mp[kf0, sel] = ids
        self._refresh_mp_geometry(ids)
        self.last_Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = kf0
        self.last_kf_frame_id = self.frame_id
        # the host table replaces any device one
        feats.mp = m.kf_kp_mp[kf0].copy()
        self.last_frame = feats
        self._bump_map()
        return True

    # ------------------------------------------------------------------
    def _offline_depth_scale_init(self, min_points=5):
        """Object-depth scale anchor (MonoObjDepthInitialization's role,
        Tracking.cc:852-930): compare each in-box mapped point's estimated
        camera depth against its metric ray-cuboid depth and rescale the
        map by the median ratio. Re-applied per keyframe — once the scale
        is metric the ratio is ~1 and the correction is a no-op.

        It rewrites the map, the pose and the motion model on the host; its
        callers (track() after initialization, and the keyframe step, which
        MonocularTracker._resolve follows with a bump) bump the map
        version. Moving objects cannot anchor a static depth ratio
        (mono_allframe_Obj_depth_init=false, mono_dynamic.launch:44): with
        dynamic=True it does nothing."""
        if self.dynamic is not None:
            return
        rows = self._rows_for(self.frame_id)
        if rows is None:
            return
        m = self.map
        k = self.ref_kf
        ratios = []
        Tcw = m.kf_tcw[k]
        kp_xy = m.kf_kp_xy[k]
        mp = m.kf_kp_mp[k]
        for r in rows:
            local_pose, scale3 = _local_pose(self.init_to_ground, r)
            if float(local_pose[2, 3]) <= 0.5:
                continue
            x, y, w, h = r[7:11]
            inside = ((mp >= 0)
                      & (kp_xy[:, 0] >= x) & (kp_xy[:, 0] <= x + w)
                      & (kp_xy[:, 1] >= y) & (kp_xy[:, 1] <= y + h))
            sel = np.where(inside)[0]
            ids = mp[sel]
            keep = m.mp_valid[ids]
            sel, ids = sel[keep], ids[keep]
            if len(ids) == 0:
                continue
            d_metric = _ray_cuboid_depth(self.K, kp_xy[sel], local_pose, scale3)
            z_est = (m.mp_pos[ids] @ Tcw[:3, :3].T + Tcw[:3, 3])[:, 2]
            ok = (d_metric > 0) & (z_est > 1e-6)
            ratios.extend((d_metric[ok] / z_est[ok]).tolist())
        if len(ratios) < min_points:
            return
        # The axis-aligned 2D box over-covers the cuboid silhouette, so
        # BACKGROUND points leak into the sample; they sit behind the
        # cuboid, i.e. their depth ratio is systematically SMALLER. A plain
        # median flips to the background cluster whenever it outnumbers the
        # on-object points. Instead take the densest mutually-consistent
        # cluster of log-ratios, breaking near-ties toward the NEAREST
        # surface — nothing on the object can read deeper than the object.
        logs = np.log(np.asarray(ratios, dtype=np.float64))
        win = np.log(1.25)
        counts = (np.abs(logs[None, :] - logs[:, None]) <= win).sum(axis=1)
        center = float(logs[counts >= counts.max() - 1].max())
        cluster = logs[np.abs(logs - center) <= win]
        if len(cluster) < min_points:
            return
        scale = float(np.exp(np.median(cluster)))
        if not (0.02 < scale < 50.0):
            return
        GroundScaleEstimator.apply_scale(m, k, scale)
        self._rescale_traj_rel(scale)
        self.last_Tcw = m.kf_tcw[k].copy()
        # the motion model's translation lives in map units (Tracking.cc
        # rescales mVelocity the same way, :2640-2646)
        self.velocity[:3, 3] *= scale
        self._anchor_scales.append(scale)
        self.mono_scale_initialized = True
        if abs(scale - 1.0) > 0.02:
            logger.info("object-depth scale anchor: x%.3f", scale)

    # ------------------------------------------------------------------
    def _create_keyframe(self, feats, fid=None):
        # the plain keyframe step, not ObjectSlamTracker's (no detector)
        MonocularTracker._create_keyframe(self, feats, fid=fid)
        # the anchor/ground rescale below rewrites every pose; a stale
        # in-flight BA applied afterwards would restore pre-rescale units
        self._apply_pending_map()
        k = self.ref_kf
        # re-anchor scale at each keyframe with a visible object (no-op
        # once the map is metric)
        with profiler.span("kitti.anchor"):
            self._offline_depth_scale_init()
        if not self.mono_scale_initialized:
            # a METRIC fixed-scale object prior on a not-yet-metric map
            # would fight the reprojection edges and corrupt the in-box
            # points the anchor needs — defer the object pipeline
            return
        if self.dynamic is not None:
            # mono_dynamic configuration: tracklets are MOVING objects with
            # per-KF poses + velocity; no static-landmark association, and
            # no ground-height scale recovery (enable_ground_height_scale=
            # false, mono_dynamic.launch:47 — a mid-run rescale would
            # de-calibrate the metric per-KF object poses already committed
            # to the chains). The dynamic BA rewrites window cameras on the
            # host; MonocularTracker._resolve bumps the map after this step.
            self._dynamic_keyframe(k)
            return
        _offline_objects(self, k)
        # ground-scale recovery cadence (Tracking.cc:2433-2663)
        with profiler.span("kitti.ground"):
            s = self.ground.try_recover(self.map, k, self.img_wh, cam_ground_normal=self.cam_ground_normal,
                                        seed=self.frame_id)
            if s is not None and 0.5 < s < 2.0:
                GroundScaleEstimator.apply_scale(self.map, k, s)
                self._rescale_traj_rel(s)
                self.last_Tcw = self.map.kf_tcw[k].copy()
                self.velocity[:3, 3] *= s
                self.n_scale_recoveries += 1
                logger.info("ground scale recovery #%d: x%.3f", self.n_scale_recoveries, s)

    def _dynamic_keyframe(self, k):
        """The dynamic part of a keyframe step: this frame's tracklet rows
        become per-keyframe object poses, then the dynamic BA runs over the
        window with static anchor edges."""
        from .dynamic import static_anchor_edges

        dets = self._dyn_dets_for(self.frame_id)
        stamp = (float(self.frame_stamps[self.frame_id])
                 if self.frame_stamps is not None and self.frame_id < len(self.frame_stamps)
                 else float(self.frame_id))
        with profiler.span("dyn.keyframe"):
            self.dynamic.on_keyframe(self.map, k, dets, stamp=stamp, K=self.K, img_wh=self.img_wh)
        with profiler.span("dyn.ba"):
            self.dynamic.run_dynamic_ba(self.map, self.K, static_edges_fn=lambda w: static_anchor_edges(self.map, w))


def _offline_objects(trk, k):
    """The object part of a KITTI keyframe step: the offline rows of this
    frame become measurements on keyframe k, are associated (by tracklet id
    or by shared points) and culled, then the joint object BA runs if any
    landmark lives."""
    rows = trk._rows_for(trk.frame_id)
    with profiler.span("obj.ingest"):
        dets = trk.objects.ingest_offline(trk.map, k, rows, trk.init_to_ground,
                                          use_truth_trackid=trk.use_truth_trackid, img_wh=trk.img_wh)
    with profiler.span("obj.associate"):
        if trk.use_truth_trackid:
            trk.objects.associate_by_tracklet(trk.map, k, dets)
        else:
            trk.objects.associate(trk.map, k, dets)
        trk.objects.cull(trk.map)
    if trk.objects.store.valid.any():
        with profiler.span("obj.ba"):
            trk._object_ba(k)


class KittiStereoTracker(StereoTracker):
    """Stereo KITTI tracker with the offline-cuboid object pipeline — the
    Examples/Stereo/stereo_kitti.cc configuration: rectified left/right
    pairs (metric scale from the baseline, so no mono scale anchor or
    ground-scale recovery is needed) with per-frame offline cuboid txts
    feeding object landmarks into the joint camera+point+object BA."""

    def __init__(self, K, img_wh, baseline, offline_cuboids, init_to_ground,
                 config: TrackerConfig | None = None, use_truth_trackid=True,
                 car_prior=KITTI_CAR_PRIOR, camera_object_weight=1.0,
                 depth_max=40.0, device=None):
        StereoTracker.__init__(self, K, img_wh, baseline, config, depth_max=depth_max, device=device)
        self.objects = ObjectManager(detector=None, fixed_scale_prior=car_prior)
        self.offline = offline_cuboids
        self.init_to_ground = np.asarray(init_to_ground, dtype=np.float64)
        self.use_truth_trackid = use_truth_trackid
        self.camera_object_weight = camera_object_weight
        self.car_prior = np.asarray(car_prior, dtype=np.float32)

    _rows_for = KittiMonoTracker._rows_for
    _object_ba = ObjectSlamTracker._object_ba
    _object_ba_problem = ObjectSlamTracker._object_ba_problem
    _object_ba_apply = ObjectSlamTracker._object_ba_apply
    # object landmarks are world-frame state — they must ride loop
    # corrections exactly like in ObjectSlamTracker (same store/meas
    # layouts), or cuboids go stale after a closed loop
    _on_loop_corrected = ObjectSlamTracker._on_loop_corrected

    def reset(self):
        StereoTracker.reset(self)
        self.objects = ObjectManager(detector=None, fixed_scale_prior=self.car_prior)

    def _create_keyframe(self, feats, fid=None):
        StereoTracker._create_keyframe(self, feats, fid=fid)
        # the object pipeline reads AND writes camera/point state — fold
        # the in-flight static BA first
        self._apply_pending_map()
        _offline_objects(self, self.ref_kf)


def _write_outputs(tracker, seq, n, output_prefix):
    """The RECOMPOSED trajectory as TUM and KITTI files and the optimized
    cuboids (mono_kitti.cc's SaveTrajectory* + SaveOptimizedCuboidsToTxt):
    mid-run scale anchors, ground recoveries and loop corrections rescale
    past keyframes retroactively, so the as-tracked pose list mixes units
    across frames — the reference recomposes frames through the current
    keyframe poses (System.cc:301-364)."""
    from ..utils import serialization as ser

    stamps = seq.times[:n] if seq.times is not None else np.arange(n, dtype=np.float64)
    poses = [T for _, T in tracker.final_trajectory()]
    ser.save_trajectory_tum(output_prefix + "_tum.txt", stamps, poses)
    ser.save_trajectory_kitti(output_prefix + "_kitti.txt", poses)
    ser.save_cuboids_txt(output_prefix + "_cuboids.txt", tracker.objects.store,
                         dynamic_manager=getattr(tracker, "dynamic", None))


def run_kitti_stereo_sequence(seq, init_to_ground, baseline, config=None,
                              max_frames=None, use_truth_trackid=True,
                              output_prefix=None, device=None):
    """Drive a stereo KittiSequence (or any object with its `num_frames`,
    `K`, `times`, `gray`, `gray_right` and `offline_cuboids`) end to end —
    the stereo_kitti.cc main loop over image_0/image_1 pairs — and
    optionally write the trajectories and the optimized cuboids under
    `output_prefix`. Returns the tracker."""
    n = seq.num_frames if max_frames is None else min(seq.num_frames, max_frames)
    offline = seq.offline_cuboids(use_truth_trackid=use_truth_trackid)
    first = seq.gray(0)
    img_wh = (first.shape[1], first.shape[0])
    tracker = KittiStereoTracker(seq.K, img_wh, baseline, offline, init_to_ground, config=config,
                                 use_truth_trackid=use_truth_trackid, device=device)
    tracker.track(first, seq.gray_right(0))
    for i in range(1, n):
        tracker.track(seq.gray(i), seq.gray_right(i))
    tracker.flush()
    if output_prefix:
        _write_outputs(tracker, seq, n, output_prefix)
    return tracker


def run_kitti_sequence(seq, init_to_ground, config=None, max_frames=None,
                       use_truth_trackid=True, output_prefix=None,
                       ground_cfg=None, dynamic=False, device=None):
    """Drive a KittiSequence (or any object with its `num_frames`, `K`,
    `times`, `gray` and `offline_cuboids`) end to end — the mono_kitti.cc
    main loop — and optionally write the trajectories and the optimized
    cuboids under `output_prefix` (with dynamic=True, the mono_dynamic
    configuration, also the moving objects' per-keyframe poses and
    velocities: `_cuboids_dynamic.txt` and `_cuboids_velocity.txt`).
    Returns the tracker."""
    n = seq.num_frames if max_frames is None else min(seq.num_frames, max_frames)
    offline = seq.offline_cuboids(use_truth_trackid=use_truth_trackid)
    first = seq.gray(0)
    img_wh = (first.shape[1], first.shape[0])
    tracker = KittiMonoTracker(seq.K, img_wh, offline, init_to_ground, config=config,
                               use_truth_trackid=use_truth_trackid, ground_cfg=ground_cfg, dynamic=dynamic,
                               frame_stamps=seq.times, device=device)
    tracker.track(first)
    for i in range(1, n):
        tracker.track(seq.gray(i))
    tracker.flush()
    if output_prefix:
        _write_outputs(tracker, seq, n, output_prefix)
    return tracker
