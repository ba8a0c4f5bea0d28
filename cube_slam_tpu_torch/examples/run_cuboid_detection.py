"""Single-image 3D cuboid detection demo — the detect_3d_cuboid node
equivalent (detect_3d_cuboid/src/main.cpp): the reference's frame + offline
LSD edges + hard-coded calibration/pose/2D-box in, scored cuboid out,
overlay saved. The detector's distance transform is the EDT CUDA kernel on
the card.

    python -m cube_slam_tpu_torch.examples.run_cuboid_detection \
        [--live-lines] [--out DIR] [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--live-lines", action="store_true",
                    help="run the port's line detector instead of the bundled LSD txt")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "cuboid_detection"))
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from cube_slam_tpu_torch.device import resolve
    from cube_slam_tpu_torch.models.detector import CuboidDetector
    from cube_slam_tpu_torch.utils import io, profiler
    from cube_slam_tpu_torch.viz import drawing

    dev = resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    profiler.enable()
    fx = io.load_detect3d_fixture()

    lines = fx["edges"]
    if args.live_lines:
        from cube_slam_tpu_torch.ops import lsd

        ls, valid = lsd.detect_lines(torch.as_tensor(fx["gray"], dtype=torch.float32, device=dev),
                                     min_length=15.0, max_lines=256)
        lines = ls[valid].cpu().numpy()

    det = CuboidDetector(device=dev)
    det.set_calibration(fx["K"])
    with profiler.span("One 3D object total time"):
        res = det.detect_cuboid(fx["gray"], fx["Twc"], fx["bbox"], lines)
    # timed steady-state pass (each call ends in the one host read of its result)
    t0 = time.perf_counter()
    for _ in range(5):
        res = det.detect_cuboid(fx["gray"], fx["Twc"], fx["bbox"], lines)
    print(f"steady detect: {(time.perf_counter() - t0) / 5 * 1000:.1f} ms/frame")

    p = res[0][0]
    print(f"pos {np.round(p.pos, 3)}  rotY {p.rotY:.3f}  scale {np.round(p.scale, 3)}")
    print(f"errors: dist {p.edge_distance_error:.3f} angle {p.edge_angle_error:.3f} "
          f"normalized {p.normalized_error:.4f} skew {p.skew_ratio:.3f}")

    img = drawing.draw_frame(
        fx["rgb"], cuboid_corners_2d=[p.box_corners_2d], bboxes=[fx["bbox"][0]]
    )
    img.save(os.path.join(args.out, "cuboid_overlay.png"))
    profiler.print_aggregated()
    print("artifacts in", args.out)


if __name__ == "__main__":
    main()
