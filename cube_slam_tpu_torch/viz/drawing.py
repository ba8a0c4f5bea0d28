"""Host-side visualization — FrameDrawer / MapDrawer parity as images.

The reference renders with Pangolin GL and RViz markers (Viewer.cc,
FrameDrawer.cc:57 DrawFrame, MapDrawer.cc:184 DrawMapCuboids,
object_slam/src/main_obj.cpp:104-144 cuboid markers). Headless accelerator
hosts have no GL; these functions draw the same overlays into PIL images
(keypoints, tracked points, cuboid wireframes, top-down maps) for saving
or notebook display.

A host copy of cube_slam_tpu/viz/drawing.py: the same PIL calls, so the
images are the JAX package's pixel for pixel. Tensors given to it, on any
device, are moved to numpy first. PIL is imported at the first drawing.
"""

from __future__ import annotations

import numpy as np
import torch

# 12 cuboid wireframe edges over the struct corner order
# (bottom 1-4 = idx 0-3, top 5-8 = idx 4-7)
CUBOID_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _host(x):
    """A tensor as numpy; lists and tuples element by element; anything
    else as it is."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _pil():
    from PIL import Image, ImageDraw

    return Image, ImageDraw


def draw_frame(gray_or_rgb, kp_xy=None, kp_tracked=None, cuboid_corners_2d=None,
               bboxes=None, status_text=None):
    """FrameDrawer::DrawFrame analog: keypoints (green = tracked map points,
    blue = unmatched), cuboid wireframes, detection boxes, status bar."""
    gray_or_rgb, kp_xy, kp_tracked, cuboid_corners_2d, bboxes = _host(
        [gray_or_rgb, kp_xy, kp_tracked, cuboid_corners_2d, bboxes])
    Image, ImageDraw = _pil()
    arr = np.asarray(gray_or_rgb)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    d = ImageDraw.Draw(img)
    if kp_xy is not None:
        tracked = kp_tracked if kp_tracked is not None else np.zeros(len(kp_xy), bool)
        for (x, y), t in zip(kp_xy, tracked):
            color = (0, 255, 0) if t else (80, 80, 255)
            d.ellipse([x - 2, y - 2, x + 2, y + 2], outline=color)
    if bboxes is not None:
        for b in bboxes:
            d.rectangle([b[0], b[1], b[0] + b[2], b[1] + b[3]], outline=(255, 255, 0), width=2)
    if cuboid_corners_2d is not None:
        for corners in cuboid_corners_2d:  # (2, 8) or (8, 2)
            c = np.asarray(corners)
            if c.shape == (2, 8):
                c = c.T
            for a, b in CUBOID_EDGES:
                d.line([tuple(c[a]), tuple(c[b])], fill=(255, 0, 0), width=2)
    if status_text:
        d.text((6, 6), status_text, fill=(255, 255, 255))
    return img


def draw_map_topdown(est_Twc=None, truth_Twc=None, points=None, cuboids=None,
                     dynamic_tracks=None, size=640, margin=0.1):
    """MapDrawer analog: top-down (x, y) view of trajectory, map points and
    cuboid footprints.

    dynamic_tracks: optional list of (poses, scale) per moving object —
    poses is a sequence of 4x4 object->world poses over time. Rendered as
    a fading trail through the pose-history centers with footprints at the
    first and latest pose (MapDrawer.cc:250's all-dynamic-poses view)."""
    est_Twc, truth_Twc, points, cuboids, dynamic_tracks = _host(
        [est_Twc, truth_Twc, points, cuboids, dynamic_tracks])
    Image, ImageDraw = _pil()
    img = Image.new("RGB", (size, size), (20, 20, 24))
    d = ImageDraw.Draw(img)

    pts_all = []
    for arr in (est_Twc, truth_Twc):
        if arr is not None:
            pts_all.append(np.asarray(arr)[:, :2, 3].reshape(-1, 2))
    if points is not None and len(points):
        pts_all.append(np.asarray(points)[:, :2])
    if dynamic_tracks:
        for poses, _scale in dynamic_tracks:
            if len(poses):
                pts_all.append(np.asarray(poses)[:, :2, 3].reshape(-1, 2))
    if not pts_all:
        return img
    allp = np.concatenate(pts_all)
    lo = allp.min(axis=0)
    hi = allp.max(axis=0)
    span = max((hi - lo).max(), 1e-6)
    lo = lo - margin * span
    span = span * (1 + 2 * margin)

    def to_px(p):
        q = (np.asarray(p)[:2] - lo) / span * (size - 1)
        return (float(q[0]), float(size - 1 - q[1]))

    if points is not None:
        for p in np.asarray(points):
            x, y = to_px(p)
            d.point((x, y), fill=(120, 120, 120))
    if truth_Twc is not None:
        tr = [to_px(T[:3, 3]) for T in np.asarray(truth_Twc)]
        d.line(tr, fill=(0, 200, 0), width=2)
    if est_Twc is not None:
        tr = [to_px(T[:3, 3]) for T in np.asarray(est_Twc)]
        d.line(tr, fill=(255, 80, 80), width=2)
    def footprint(pose, scale, color, width=2):
        pose = np.asarray(pose)
        scale = np.asarray(scale)
        corners_local = np.array(
            [[1, 1, 0], [1, -1, 0], [-1, -1, 0], [-1, 1, 0]], dtype=np.float64
        ) * np.array([scale[0], scale[1], 0.0])
        cw = corners_local @ pose[:3, :3].T + pose[:3, 3]
        px = [to_px(c) for c in cw] + [to_px(cw[0])]
        d.line(px, fill=color, width=width)

    if cuboids is not None:
        for pose, scale in cuboids:
            footprint(pose, scale, (80, 160, 255))
    if dynamic_tracks:
        for poses, scale in dynamic_tracks:
            poses = np.asarray(poses)
            if len(poses) == 0:
                continue
            centers = [to_px(T[:3, 3]) for T in poses]
            # fading trail: older segments darker (pose history over time)
            for i in range(1, len(centers)):
                f = i / max(len(centers) - 1, 1)
                col = (int(120 + 135 * f), int(60 + 100 * f), 30)
                d.line([centers[i - 1], centers[i]], fill=col, width=2)
            footprint(poses[0], scale, (120, 70, 30), width=1)
            footprint(poses[-1], scale, (255, 170, 60), width=2)
    return img


def cuboid_corners_2d_from_pose(pose, scale, Tcw, K):
    """Project a cuboid's 8 corners for draw_frame (numpy)."""
    pose, scale, Tcw, K = _host([pose, scale, Tcw, K])
    corners_body = np.array(
        [
            [1, 1, -1, -1, 1, 1, -1, -1],
            [1, -1, -1, 1, 1, -1, -1, 1],
            [-1, -1, -1, -1, 1, 1, 1, 1],
        ],
        dtype=np.float64,
    ).T * np.asarray(scale)
    cw = corners_body @ np.asarray(pose)[:3, :3].T + np.asarray(pose)[:3, 3]
    cc = cw @ np.asarray(Tcw)[:3, :3].T + np.asarray(Tcw)[:3, 3]
    uv = cc @ np.asarray(K).T
    return (uv[:, :2] / uv[:, 2:3])
