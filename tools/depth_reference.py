#!/usr/bin/env python3
"""Run the JAX package's RgbdTracker and StereoTracker over the frames that
chip_smoke.py's phases 11A and 11B give the port, on the CPU; print the
same figures, one JSON line per tracker: the reference for the port's
numbers there.

    JAX_PLATFORMS=cpu python tools/depth_reference.py [--rgbd-frames 58] [--stereo-frames 40]

Setup as phase 11: chip_smoke.depth_sequences (11A: phase 6's 58-frame
640x480 orbit with rendered depth, TUM intrinsics, 1500 features x 8
levels, depth_max 8 m; 11B: a 40-frame 1241x376 orbit with KITTI 00-02
intrinsics, its stereo baseline, 3000 features x 8 levels, depth_max 40 m),
loop closing at its default. The local-BA fold is forced synchronous, as in
the port's tests. Times are host seconds on the CPU and say nothing of any
device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _run(trk, inputs, truth):
    ms, kind, traj, wall = cs.drive(trk, inputs, sync=lambda: None)
    med = lambda k: statistics.median([t for t, c in zip(ms, kind) if c == k]) if k in kind else None  # noqa: E731
    return dict(frames=len(inputs), init=kind.index("init") if "init" in kind else None,
                tracked=sum(T is not None for _, T in traj), keyframes=int(trk.map.kf_valid.sum()),
                map_points=int(trk.map.mp_valid.sum()), ate_final_m=cs.metric_ate(traj, truth),
                ate_tracked_m=cs.metric_ate(trk.trajectory, truth), loops_closed=int(trk.loops_closed),
                cpu_frames_per_s=len(inputs) / wall, cpu_tracked_ms_median=med("tracked"),
                cpu_keyframe_ms_median=med("kf"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rgbd-frames", type=int, default=58)
    ap.add_argument("--stereo-frames", type=int, default=40)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from cube_slam_tpu.slam import system as jsys

    rgbd, stereo = cs.depth_sequences(rgbd_frames=args.rgbd_frames, stereo_frames=args.stereo_frames)

    frames, truth, K = rgbd
    H, W = frames[0][0].shape
    cfg = jsys.TrackerConfig(n_features=1500, n_levels=8, max_kf=96, max_mp=12288)
    trk = cs._always_fold(jsys.RgbdTracker)(K, (W, H), cfg, depth_max=cs.RGBD_DEPTH_MAX)
    print(json.dumps(dict(tracker="RgbdTracker (JAX, CPU)", wh=[W, H], **_run(trk, frames, truth))),
          flush=True)

    frames, truth, K = stereo
    H, W = frames[0][0].shape
    cfg = jsys.TrackerConfig(n_features=3000, n_levels=8, max_kf=96, max_mp=12288)
    trk = cs._always_fold(jsys.StereoTracker)(K, (W, H), cs.KITTI_BASELINE, cfg, depth_max=cs.STEREO_DEPTH_MAX)
    print(json.dumps(dict(tracker="StereoTracker (JAX, CPU)", wh=[W, H], **_run(trk, frames, truth))),
          flush=True)


if __name__ == "__main__":
    main()
