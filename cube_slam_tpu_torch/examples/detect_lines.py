"""Line detection demo — the line_lbd `detect_lines` node equivalent
(line_lbd/src/detect_lines.cpp): detect + filter line segments on an image,
optionally compute LBD descriptors, save overlay and txt.

    python -m cube_slam_tpu_torch.examples.detect_lines [IMAGE] [--out DIR] \
        [--min-length 15] [--max-lines 256] [--lbd] [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None,
                    help="image path (default: the reference's detect_3d_cuboid frame)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "detect_lines"))
    ap.add_argument("--min-length", type=float, default=15.0)
    ap.add_argument("--max-lines", type=int, default=256)
    ap.add_argument("--lbd", action="store_true", help="also compute LBD descriptors")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image, ImageDraw

    from cube_slam_tpu_torch.device import resolve
    from cube_slam_tpu_torch.ops import lbd, lsd
    from cube_slam_tpu_torch.utils import io

    dev = resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.image:
        rgb = io.load_image(args.image)
        gray = io.rgb_to_gray(rgb)
    else:
        fx = io.load_detect3d_fixture()
        rgb, gray = fx["rgb"], fx["gray"]

    g = torch.as_tensor(gray, dtype=torch.float32, device=dev)
    lines, valid = lsd.detect_lines(g, min_length=args.min_length, max_lines=args.max_lines)
    L = lines[valid].cpu().numpy()
    print(f"detected {len(L)} lines")

    if args.lbd:
        fdesc, _ = lbd.lbd_descriptors(g, lines, valid)
        np.savetxt(os.path.join(args.out, "lbd_float.txt"), fdesc[valid].cpu().numpy())
        print("LBD descriptors written")

    # save_to_imgs / save_to_txts (detect_lines.cpp rosparams)
    np.savetxt(os.path.join(args.out, "lines.txt"), L, fmt="%.3f")
    img = Image.fromarray(np.asarray(rgb, dtype=np.uint8)).convert("RGB")
    d = ImageDraw.Draw(img)
    for x1, y1, x2, y2 in L:
        d.line([(x1, y1), (x2, y2)], fill=(255, 0, 0), width=2)
    img.save(os.path.join(args.out, "lines.png"))
    print("artifacts in", args.out)


if __name__ == "__main__":
    main()
