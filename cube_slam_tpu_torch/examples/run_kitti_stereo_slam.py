"""Stereo KITTI object SLAM — the Examples/Stereo/stereo_kitti.cc run.

Drives a KITTI odometry-style folder (image_0/ + image_1/ rectified pairs +
times.txt + optional pred_3d_obj_matched[_tracked]_txt per-frame cuboid
txts) through the stereo tracker: per-keypoint depth from row-band stereo
matching fixes the metric scale, so no mono scale anchor or ground-scale
recovery runs; offline cuboids feed the fixed-scale object landmark
pipeline and the joint camera+point+object BA. Writes TUM and KITTI
trajectories plus the optimized cuboid landmarks.

    python -m cube_slam_tpu_torch.examples.run_kitti_stereo_slam SEQ_DIR \
        --fx 707.09 --fy 707.09 --cx 601.89 --cy 183.11 --baseline 0.537 \
        [--max-frames N] [--no-trackids] [--out PREFIX] [--device cpu]

Calibration defaults are KITTI odometry seq 04-12 (KITTI04-12.yaml;
bf = 379.815 -> baseline 0.537 m at fx 707.09).
"""

import argparse
import os
import tempfile

import numpy as np

from .run_kitti_slam import init_to_ground


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("seq_dir", help="KITTI sequence folder")
    ap.add_argument("--fx", type=float, default=707.0912)
    ap.add_argument("--fy", type=float, default=707.0912)
    ap.add_argument("--cx", type=float, default=601.8873)
    ap.add_argument("--cy", type=float, default=183.1104)
    ap.add_argument("--baseline", type=float, default=0.537150588,
                    help="stereo baseline, meters (bf / fx)")
    ap.add_argument("--cam-height", type=float, default=1.7,
                    help="camera height above ground, meters (InitToGround)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-trackids", action="store_true",
                    help="associate by shared-point voting instead of "
                         "ground-truth tracklet ids")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "kitti_slam", "stereo"),
                    help="output prefix for trajectories + cuboids")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from cube_slam_tpu_torch.slam.kitti import run_kitti_stereo_sequence
    from cube_slam_tpu_torch.utils import io

    K = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]],
                 dtype=np.float32)
    seq = io.KittiSequence(args.seq_dir, K=K)
    if seq.num_frames == 0:
        raise SystemExit(f"no frames found under {args.seq_dir} "
                         "(need times.txt + image_0/%06d.png)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    tracker = run_kitti_stereo_sequence(
        seq, init_to_ground(args.cam_height), baseline=args.baseline,
        max_frames=args.max_frames,
        use_truth_trackid=not args.no_trackids, output_prefix=args.out, device=args.device)
    n_ok = sum(1 for _, T in tracker.trajectory if T is not None)
    print(f"tracked {n_ok}/{len(tracker.trajectory)} frames, "
          f"{len(tracker.map.kf_ids())} keyframes, "
          f"{int(tracker.objects.store.valid.sum())} object landmarks")
    print(f"outputs: {args.out}_tum.txt, {args.out}_kitti.txt, "
          f"{args.out}_cuboids.txt")


if __name__ == "__main__":
    main()
