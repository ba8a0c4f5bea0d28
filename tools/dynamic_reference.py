#!/usr/bin/env python3
"""Run the JAX package's dynamic trackers over the frames that
chip_smoke.py's phases 13A and 13B give the port, on the CPU; print the
same figures, one JSON line per tracker: the reference for the port's
numbers there.

    JAX_PLATFORMS=cpu python tools/dynamic_reference.py

Setup as phase 13 (chip_smoke.dynamic_inputs): 13A, KittiMonoTracker(
dynamic=True) over phase 11B's 40-frame 1241x376 orbit at KITTI 00-02's
camera with the room box driving along world +x at
chip_smoke.DYNAMIC_KITTI_SPEED m per frame (offline rows with tracklet 7,
the car prior = the box's half extents, the map bootstrapped from frame
0's rendered depth, 3000 features x 8 levels, loop closing at its
default); 13B, DynamicRgbdTracker over phase 6's 58-frame 640x480 orbit at
the TUM preset with the box driving at DYNAMIC_RGBD_SPEED, rendered depth
and instance masks. The local-BA fold is forced synchronous, as in the
port's tests. Times are host seconds on the CPU and say nothing of any
device.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _run(trk, inputs, g, tid, W):
    ms, kind, traj, wall = cs.drive(trk, inputs, sync=lambda: None)
    med = lambda k: statistics.median([t for t, c in zip(ms, kind) if c == k]) if k in kind else None  # noqa: E731
    est = {f: W @ np.linalg.inv(np.asarray(T, dtype=np.float64)) for f, T in traj if T is not None}
    ate = float(np.sqrt(np.mean([np.sum((est[f][:3, 3] - g["poses"][f][:3, 3]) ** 2) for f in est])))
    obj = cs._object_outcome(trk, g, tid)
    return dict(frames=len(inputs), init=kind.index("init") if "init" in kind else None, tracked=len(est),
                keyframes=int(trk.map.kf_valid.sum()), map_points=int(trk.map.mp_valid.sum()), metric_ate_m=ate,
                loops_closed=int(trk.loops_closed),
                object=None if obj is None else dict(
                    velocity=[round(float(v), 5) for v in obj["velocity"]], keyframe_poses=obj["n_kf"],
                    velocity_updates=obj["history"], points_with_object_coordinates=obj["has_local"],
                    median_position_error_m=obj["median_err"], displacement_error_m=obj["disp_err"]),
                cpu_frames_per_s=len(inputs) / wall, cpu_tracked_ms_median=med("tracked"),
                cpu_keyframe_ms_median=med("kf"))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from cube_slam_tpu.slam import dynamic as jdyn
    from cube_slam_tpu.slam import kitti as jk
    from cube_slam_tpu.slam import system as jsys
    from cube_slam_tpu_torch.utils import synth

    seq = cs.synth_sequence(cs.SLICE_FRAMES, cs.SLICE_WH)
    stereo = (None, synth.SynthSequence(cs.STEREO_FRAMES, K=cs.KITTI_K, wh=cs.KITTI_WH).poses, cs.KITTI_K)
    (gk, K), (gr, Kr) = cs.dynamic_inputs(stereo, seq)

    H, W = gk["frames"][0].shape
    cfg = jsys.TrackerConfig(n_features=3000, n_levels=8, max_kf=96, max_mp=12288)
    trk = cs._always_fold(jk.KittiMonoTracker)(K, (W, H), cs.moving_box_rows(gk, cs.DYNAMIC_GATE_TID),
                                               gk["poses"][0], config=cfg, car_prior=gk["half"], dynamic=True,
                                               first_depth=gk["depths"][0])
    out = _run(trk, [(f,) for f in gk["frames"]], gk, cs.DYNAMIC_GATE_TID, gk["poses"][0])
    print(json.dumps(dict(tracker="KittiMonoTracker(dynamic=True) (JAX, CPU)", wh=[W, H],
                          speed_m_per_frame=cs.DYNAMIC_KITTI_SPEED, **out)), flush=True)

    H, W = gr["frames"][0].shape
    cfg = jsys.TrackerConfig(n_features=1500, n_levels=8, max_kf=96, max_mp=12288)
    trk = jdyn.DynamicRgbdTracker(Kr, (W, H), cfg, depth_max=cs.RGBD_DEPTH_MAX, ground_Twc0=gr["poses"][0])
    trk._impl.__class__ = cs._always_fold(type(trk._impl))
    dets = cs.moving_box_dets(gr, jdyn.DynamicDetection)
    out = _run(trk, list(zip(gr["frames"], gr["depths"], dets)), gr, 0, np.eye(4))
    print(json.dumps(dict(tracker="DynamicRgbdTracker (JAX, CPU)", wh=[W, H],
                          speed_m_per_frame=cs.DYNAMIC_RGBD_SPEED, **out)), flush=True)


if __name__ == "__main__":
    main()
