"""KITTI-mode monocular object SLAM — the reference's headline run
(Examples/Monocular/mono_kitti.cc + the object pipeline of
Tracking.cc:1553-1982, :2433-2663).

Drives a KITTI odometry-style folder (image_0/%06d.png + times.txt +
pred_3d_obj_matched[_tracked]_txt per-frame cuboid txts) through the
offline-cuboid tracker: tracklet-id association, fixed-scale car prior,
object-depth scale anchoring, ground-plane scale recovery. Writes TUM and
KITTI trajectories plus the optimized cuboid landmarks.

    python -m cube_slam_tpu_torch.examples.run_kitti_slam SEQ_DIR \
        --fx 707.09 --fy 707.09 --cx 601.89 --cy 183.11 --cam-height 1.7 \
        [--max-frames N] [--no-trackids] [--out PREFIX] [--device cpu]

Calibration defaults are KITTI odometry seq 04-12
(Examples/Monocular/KITTI04-12_me.yaml).
"""

import argparse
import os
import tempfile

import numpy as np


def init_to_ground(cam_height):
    """InitToGround (Tracking.cc:110-143): the camera at cam_height over the
    ground plane, KITTI camera convention (x right, y down, z forward) ->
    ground frame (z up)."""
    return np.array(
        [[1.0, 0.0, 0.0, 0.0],
         [0.0, 0.0, 1.0, 0.0],
         [0.0, -1.0, 0.0, cam_height],
         [0.0, 0.0, 0.0, 1.0]], dtype=np.float64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("seq_dir", help="KITTI sequence folder")
    ap.add_argument("--fx", type=float, default=707.0912)
    ap.add_argument("--fy", type=float, default=707.0912)
    ap.add_argument("--cx", type=float, default=601.8873)
    ap.add_argument("--cy", type=float, default=183.1104)
    ap.add_argument("--cam-height", type=float, default=1.7,
                    help="camera height above ground, meters (InitToGround)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-trackids", action="store_true",
                    help="associate by shared-point voting instead of "
                         "ground-truth tracklet ids")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "kitti_slam", "run"),
                    help="output prefix for trajectories + cuboids")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from cube_slam_tpu_torch.slam.ground import GroundConfig
    from cube_slam_tpu_torch.slam.kitti import run_kitti_sequence
    from cube_slam_tpu_torch.slam.system import TrackerConfig
    from cube_slam_tpu_torch.utils import io

    K = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]],
                 dtype=np.float32)
    seq = io.KittiSequence(args.seq_dir, K=K)
    if seq.num_frames == 0:
        raise SystemExit(f"no frames found under {args.seq_dir} "
                         "(need times.txt + image_0/%06d.png)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cfg = TrackerConfig(n_features=2048, n_levels=8)
    tracker = run_kitti_sequence(
        seq, init_to_ground(args.cam_height), config=cfg, max_frames=args.max_frames,
        use_truth_trackid=not args.no_trackids, output_prefix=args.out,
        ground_cfg=GroundConfig(nominal_height=args.cam_height), device=args.device,
    )
    n_tracked = sum(1 for _, T in tracker.trajectory if T is not None)
    n_obj = int(tracker.objects.store.valid.sum())
    print(f"tracked {n_tracked}/{len(tracker.trajectory)} frames, "
          f"{n_obj} object landmarks, "
          f"{tracker.n_scale_recoveries} ground-scale recoveries")
    print(f"outputs: {args.out}_tum.txt {args.out}_kitti.txt "
          f"{args.out}_cuboids.txt")


if __name__ == "__main__":
    main()
