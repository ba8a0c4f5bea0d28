#!/usr/bin/env python3
"""Run the JAX package's KittiMonoTracker and KittiStereoTracker over the
frames and offline rows that chip_smoke.py's phases 12A and 12B give the
port, on the CPU; print the same figures, one JSON line per tracker: the
reference for the port's numbers there.

    JAX_PLATFORMS=cpu python tools/kitti_reference.py [--frames 40]

Setup as phase 12 (chip_smoke.kitti_inputs over phase 11B's stereo orbit:
40 frames 1241x376 at KITTI 00-02's camera, the room box's offline rows
with tracklet 1, the car prior = the box's half extents, 3000 features x 8
levels, loop closing at its default). 12A: the monocular tracker with
ground recovery every 3 keyframes at the mount's height; 12B: the stereo
tracker with KITTI's baseline and depth_max 40 m. The local-BA fold is
forced synchronous, as in the port's tests. Times are host seconds on the
CPU and say nothing of any device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _run(trk, inputs, truth, scene):
    ms, kind, traj, wall = cs.drive(trk, inputs, sync=lambda: None)
    med = lambda k: statistics.median([t for t, c in zip(ms, kind) if c == k]) if k in kind else None  # noqa: E731
    ate, G = cs.first_frame_ate(traj, truth)
    box_T, _ = scene.box_pose_scale()
    st = trk.objects.store
    lms = [dict(slot=int(o), centre_to_box_m=float(np.linalg.norm(
        (G @ np.append(st.pose[o][:3, 3].astype(np.float64), 1.0))[:3] - box_T[:3, 3])),
        half_scale=[round(float(v), 4) for v in st.scale[o]]) for o in np.where(st.valid)[0]]
    return dict(frames=len(inputs), init=kind.index("init") if "init" in kind else None,
                tracked=sum(T is not None for _, T in traj), keyframes=int(trk.map.kf_valid.sum()),
                map_points=int(trk.map.mp_valid.sum()), metric_ate_m=ate, scaled_ate_m=cs._scaled_ate(traj, truth),
                loops_closed=int(trk.loops_closed), landmarks=lms, cpu_frames_per_s=len(inputs) / wall,
                cpu_tracked_ms_median=med("tracked"), cpu_keyframe_ms_median=med("kf"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=cs.STEREO_FRAMES)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from cube_slam_tpu.slam import ground as jg
    from cube_slam_tpu.slam import kitti as jk
    from cube_slam_tpu.slam import system as jsys

    _, stereo = cs.depth_sequences(rgbd_frames=1, stereo_frames=args.frames)
    frames, truth, K, scene, half, rows = cs.kitti_inputs(stereo)
    H, W = frames[0][0].shape
    cfg = jsys.TrackerConfig(n_features=3000, n_levels=8, max_kf=96, max_mp=12288)
    ground = jg.GroundConfig(nominal_height=float(abs(truth[0][2, 3])), every_kfs=3, min_points=12,
                             inlier_thresh=0.03)
    trk = cs._always_fold(jk.KittiMonoTracker)(K, (W, H), rows, truth[0], config=cfg, car_prior=half,
                                               ground_cfg=ground,
                                               firstframe_depth_init=cs.KITTI_MONO_OBJECT_BOOTSTRAP)
    out = _run(trk, [(left,) for left, _ in frames], truth, scene)
    print(json.dumps(dict(tracker="KittiMonoTracker (JAX, CPU)", wh=[W, H], **out,
                          mono_scale_initialized=bool(trk.mono_scale_initialized),
                          anchor_scales=[round(float(s), 6) for s in trk._anchor_scales],
                          ground_recoveries=int(trk.n_scale_recoveries))), flush=True)

    cfg = jsys.TrackerConfig(n_features=3000, n_levels=8, max_kf=96, max_mp=12288)
    trk = cs._always_fold(jk.KittiStereoTracker)(K, (W, H), cs.KITTI_BASELINE, rows, truth[0], config=cfg,
                                                 car_prior=half, depth_max=cs.STEREO_DEPTH_MAX)
    print(json.dumps(dict(tracker="KittiStereoTracker (JAX, CPU)", wh=[W, H], **_run(trk, frames, truth, scene))),
          flush=True)


if __name__ == "__main__":
    main()
