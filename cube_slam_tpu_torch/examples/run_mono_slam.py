"""Full monocular (object) SLAM over the reference's cabinet sequence —
the mono_tum / ros_mono equivalent entry point. The sequence is read from
utils/io.REFERENCE_DATA (set CUBE_SLAM_REFERENCE).

NOTE: the 58-frame cabinet set is keyframe-subsampled (~6 deg of orbit per
frame) with strongly repetitive texture — far beyond what any frame-rate
tracker (the reference's included, which ran on 30 fps rosbags) is
designed to absorb, so expect sparse tracking there. For a quantitative
end-to-end evaluation at video rate see run_synthetic_object_slam.py.

    python -m cube_slam_tpu_torch.examples.run_mono_slam [--objects] \
        [--out DIR] [--frames N] [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", action="store_true", help="enable cuboid landmarks")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "mono_slam"))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from cube_slam_tpu_torch.device import resolve
    from cube_slam_tpu_torch.ops import lsd as lsd_ops
    from cube_slam_tpu_torch.slam.system import MonocularTracker, ObjectSlamTracker, TrackerConfig
    from cube_slam_tpu_torch.slam.tracking import evaluate_ate_scaled
    from cube_slam_tpu_torch.utils import io, serialization
    from cube_slam_tpu_torch.viz import drawing

    dev = resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    seq = io.CabinetSequence(io.REFERENCE_DATA)
    n = args.frames or seq.num_frames

    cfg = TrackerConfig(
        n_features=1500, n_levels=8, max_kf=64, max_mp=8192,
        min_init_matches=80, init_ratio=1.0, init_max_dist=64,
        match_radius_motion=25.0, match_radius_local=8.0, min_inliers_local=15,
    )
    if args.objects:
        trk = ObjectSlamTracker(seq.K, (640, 480), cfg, ground_Twc0=seq.truth_Twc(0), device=dev)
    else:
        trk = MonocularTracker(seq.K, (640, 480), cfg, device=dev)

    t0 = time.time()
    for f in range(n):
        gray = seq.gray(f)
        if args.objects:
            lines, lvalid = lsd_ops.detect_lines(
                torch.as_tensor(gray, dtype=torch.float32, device=dev), min_length=15.0, max_lines=128
            )
            trk.track(gray, bboxes_2d=seq.yolo_boxes(f), lines=lines[lvalid].cpu().numpy())
        else:
            trk.track(gray)
    wall = time.time() - t0

    est, tru, stamps = [], [], []
    # recomposed through current KF poses (SaveTrajectoryTUM semantics):
    # loop corrections and rescales reach the output
    for fid, T in trk.final_trajectory():
        if T is not None:
            est.append(np.linalg.inv(T))
            tru.append(seq.truth_Twc(fid))
            stamps.append(seq.truth_poses[fid, 0])
    print(f"tracked {len(est)}/{n} frames in {wall:.1f}s "
          f"({n / wall:.1f} fps), KFs={int(trk.map.kf_valid.sum())}, "
          f"map points={int(trk.map.mp_valid.sum())}")
    if len(est) > 5:
        ate = evaluate_ate_scaled(np.stack(est), np.stack(tru))
        print(f"ATE (Sim3-aligned): {ate:.4f} m")

    serialization.save_trajectory_tum(
        os.path.join(args.out, "trajectory_tum.txt"), stamps,
        [np.linalg.inv(T) for T in est],
    )
    store = trk.objects.store if args.objects else None
    serialization.save_map(os.path.join(args.out, "map.npz"), trk.map, store)
    cuboids = None
    if store is not None and store.valid.any():
        cuboids = [(store.pose[o], store.scale[o]) for o in np.where(store.valid)[0]]
        serialization.save_cuboids_txt(os.path.join(args.out, "cuboids.txt"), store)
    img = drawing.draw_map_topdown(
        est_Twc=np.stack(est) if est else None,
        truth_Twc=np.stack(tru) if tru else None,
        points=trk.map.mp_pos[trk.map.mp_valid],
        cuboids=cuboids,
    )
    img.save(os.path.join(args.out, "map_topdown.png"))
    print("artifacts in", args.out)


if __name__ == "__main__":
    main()
