"""Full objects-in-SLAM pipeline on a synthetic scene with exact ground truth.

Renders a textured room with a cuboid target (utils/synth.py), runs the
complete stack — ORB tracking, cuboid detection per keyframe (the EDT CUDA
kernel on the card), shared-point object association, joint
camera-point-object BA, monocular scale initialization from the object's
metric depth — and reports trajectory ATE (metric, unaligned) and cuboid
pose/scale error against ground truth.

    python -m cube_slam_tpu_torch.examples.run_synthetic_object_slam \
        [--frames N] [--out DIR] [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "synthetic_object_slam"))
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from cube_slam_tpu_torch.device import resolve
    from cube_slam_tpu_torch.models import cuboid as cbm
    from cube_slam_tpu_torch.ops import lsd as lsd_ops
    from cube_slam_tpu_torch.slam.system import ObjectSlamTracker, TrackerConfig
    from cube_slam_tpu_torch.slam.tracking import evaluate_ate_scaled
    from cube_slam_tpu_torch.utils import synth
    from cube_slam_tpu_torch.viz import drawing

    dev = resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], dtype=np.float32)
    scene = synth.RoomScene(seed=2, box_center=[0.0, 3.2, 0.45],
                            box_half=[0.6, 0.4, 0.45], box_yaw=0.4)
    N = args.frames
    poses = synth.camera_path(N, kind="orbit", target=[0.0, 3.2, 0.6])
    print(f"rendering {N} frames...")
    frames = [scene.render(poses[i], K) for i in range(N)]
    bboxes = [scene.box_bbox_2d(poses[i], K) for i in range(N)]

    cfg = TrackerConfig(n_features=1500, n_levels=4, max_kf=48, max_mp=8192,
                        min_init_matches=100, match_radius_motion=20.0)
    trk = ObjectSlamTracker(K, (640, 480), cfg, ground_Twc0=poses[0], device=dev)
    t0 = time.time()
    for f in range(N):
        gray = frames[f]
        lines, lv = lsd_ops.detect_lines(
            torch.as_tensor(gray, dtype=torch.float32, device=dev), min_length=15.0, max_lines=128
        )
        bb = bboxes[f]
        trk.track(gray, bboxes_2d=None if bb is None else bb[None, :], lines=lines[lv].cpu().numpy())
    wall = time.time() - t0

    # SLAM world = first camera frame; map into the ground-truth world
    G = poses[0]
    est, tru = [], []
    for fid, T in trk.final_trajectory():
        if T is not None:
            est.append(G @ np.linalg.inv(T))
            tru.append(poses[fid])
    print(f"tracked {len(est)}/{N} in {wall:.1f}s, "
          f"map points {int(trk.map.mp_valid.sum())}, "
          f"mono scale from object: {trk.mono_scale_initialized}")
    if len(est) > 5:
        est_np = np.stack(est)
        tru_np = np.stack(tru)
        d = est_np[:, :3, 3] - tru_np[:, :3, 3]
        print(f"ATE Sim3-aligned: {evaluate_ate_scaled(est_np, tru_np):.4f} m")
        print(f"ATE metric (unaligned): {float(np.sqrt((d * d).sum(1).mean())):.4f} m")

    st = trk.objects.store
    cuboids = None
    if st.valid.any():
        o = int(np.where(st.valid)[0][0])
        pose_ground = (G @ st.pose[o].astype(np.float64))
        Tgt, sgt = scene.box_pose_scale()
        err = cbm.min_log_error(
            cbm.Cuboid(torch.as_tensor(pose_ground.astype(np.float32)), torch.as_tensor(st.scale[o])),
            cbm.Cuboid(torch.as_tensor(Tgt.astype(np.float32)), torch.as_tensor(sgt.astype(np.float32))),
        )
        print(f"object t: {np.round(pose_ground[:3, 3], 3)} vs gt {np.round(Tgt[:3, 3], 3)}")
        print(f"object scale: {np.round(st.scale[o], 3)} vs gt {np.round(sgt, 3)}")
        print(f"cuboid min_log_error: {float(torch.linalg.vector_norm(err)):.4f}")
        cuboids = [(pose_ground, st.scale[o])]

    if len(est) > 5:
        img = drawing.draw_map_topdown(est_Twc=est_np, truth_Twc=tru_np, cuboids=cuboids)
        img.save(os.path.join(args.out, "map_topdown.png"))
        print("artifacts in", args.out)


if __name__ == "__main__":
    main()
