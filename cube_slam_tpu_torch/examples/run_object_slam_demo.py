"""Cube-only object SLAM demo — the object_slam_node equivalent.

Runs the incremental cuboid factor graph over the reference's 58-frame
TUM-cabinet sequence (object_slam/launch/object_slam_example.launch +
src/main_obj.cpp), in offline mode (matlab cuboid txts) or online mode
(live line detection + cuboid detection, the EDT CUDA kernel on the card),
reports ATE against the sequence's ground truth, and writes
trajectory/visualization artifacts. The sequence is read from
utils/io.REFERENCE_DATA (set CUBE_SLAM_REFERENCE).

    python -m cube_slam_tpu_torch.examples.run_object_slam_demo [--online] \
        [--out DIR] [--frames N] [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--online", action="store_true",
                    help="online_detect_mode=true: live LSD + cuboid detector")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "object_slam_demo"))
    ap.add_argument("--frames", type=int, default=None,
                    help="accepted as by the JAX script; the whole sequence runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from cube_slam_tpu_torch.slam.object_slam import ObjectSlamDemo, evaluate_ate
    from cube_slam_tpu_torch.utils import io, profiler, serialization
    from cube_slam_tpu_torch.viz import drawing

    os.makedirs(args.out, exist_ok=True)
    profiler.enable()

    seq = io.CabinetSequence(io.REFERENCE_DATA)
    demo = ObjectSlamDemo(max_frames=64, num_lm_iters=5, device=args.device)
    t0 = time.time()
    with profiler.span("incremental_build_graph"):
        res = demo.run_online(seq) if args.online else demo.run_offline(seq)
    wall = time.time() - t0

    truth = np.stack([seq.truth_Twc(i) for i in range(seq.num_frames)])
    ate = evaluate_ate(res.est_Twc, truth)
    fps = seq.num_frames / wall
    mode = "online" if args.online else "offline"
    print(f"[{mode}] {seq.num_frames} frames in {wall:.1f}s ({fps:.1f} fps)  ATE {ate:.4f} m")
    print(f"final cuboid: t={np.round(res.cube_pose_history[-1][:3, 3], 3)} "
          f"scale={np.round(res.cube_scale_history[-1], 3)}")

    # artifacts
    serialization.save_trajectory_tum(
        os.path.join(args.out, "trajectory_tum.txt"),
        seq.truth_poses[:, 0],
        [np.linalg.inv(T) for T in res.est_Twc],
    )
    img = drawing.draw_map_topdown(
        est_Twc=res.est_Twc, truth_Twc=truth,
        cuboids=[(res.cube_pose_history[-1], res.cube_scale_history[-1])],
    )
    img.save(os.path.join(args.out, "map_topdown.png"))
    profiler.print_aggregated()
    print("artifacts in", args.out)


if __name__ == "__main__":
    main()
