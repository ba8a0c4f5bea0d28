"""Procedural synthetic sequences with exact ground truth.

The benchmark's frozen copy of cube_slam_tpu_torch/utils/synth.py, cut to
the room and the orbit: the traffic stays the same whatever later changes
the port's copy, and tests/test_portbench_traffic.py pins its frames.

The reference validates its full SLAM runtime on video-rate rosbags (TUM /
KITTI, README.md:52) that are not redistributable; the bundled 58-frame
cabinet set is keyframe-subsampled (~6 deg/frame — far beyond what any
frame-to-frame tracker, including the reference's, is designed for). This
module renders a textured 3D room (ground plane + walls) under a pinhole
camera by inverse ray casting, so the full tracking runtime can be
validated at video rate against exact poses.
"""

from __future__ import annotations

import numpy as np


def value_noise_texture(size=1024, octaves=5, seed=0, contrast=1.0):
    """Multi-octave value noise in [0, 255] with plenty of corners."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size))
    for o in range(octaves):
        n = 4 * 2**o
        grid = rng.uniform(0, 1, (n + 1, n + 1))
        # bilinear upsample to size
        idx = np.linspace(0, n, size)
        i0 = np.floor(idx).astype(int)
        f = idx - i0
        i1 = np.minimum(i0 + 1, n)
        row = grid[i0][:, i0] * (1 - f)[:, None] * (1 - f)[None, :] \
            + grid[i1][:, i0] * f[:, None] * (1 - f)[None, :] \
            + grid[i0][:, i1] * (1 - f)[:, None] * f[None, :] \
            + grid[i1][:, i1] * f[:, None] * f[None, :]
        tex += row / 2**o
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    # add blocky high-contrast patches (corner features). Blocks carry
    # CONTINUOUS random intensities on a fine grid: a coarse BINARY grid
    # is adversarially self-similar — a descriptor patch spanning ~2x2
    # binary cells carries only a few bits and every corner aliases every
    # other, which no real-world surface does
    blocks = rng.uniform(0, 1, (128, 128))
    rep = size // 128
    tex = 0.6 * tex + 0.4 * np.kron(blocks, np.ones((rep, rep)))
    tex = 0.5 + contrast * (tex - 0.5)
    return np.clip(tex * 255.0, 0, 255).astype(np.float32)


class RoomScene:
    """Ground plane z=0 + back wall y=wall_y + side walls x=+-half_x,
    each with its own texture; optionally an axis-aligned textured box
    sitting on the floor (a synthetic cuboid-SLAM target with exact
    ground-truth pose/scale). World units meters; textures tile every
    `tex_scale` meters."""

    def __init__(self, wall_y=6.0, half_x=4.0, height=3.0, tex_scale=8.0, seed=0,
                 box_center=None, box_half=None, box_yaw=0.0, extra_boxes=()):
        # tex_scale defaults to the full room extent (8 m): a texture that
        # tiles WITHIN the field of view puts two identical copies of every
        # corner in one image — global perceptual aliasing no descriptor
        # can disambiguate, which no real room exhibits at exact-copy level
        self.wall_y = wall_y
        self.half_x = half_x
        self.height = height
        self.tex_scale = tex_scale
        self.tex = [value_noise_texture(seed=seed + i) for i in range(4)]
        self.box_center = None
        if box_center is not None:
            self.box_center = np.asarray(box_center, dtype=np.float64)
            self.box_half = np.asarray(box_half, dtype=np.float64)
            self.box_yaw = float(box_yaw)
            c, s = np.cos(self.box_yaw), np.sin(self.box_yaw)
            self.box_R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            # darker, high-contrast texture so the box pops against the room
            self.box_tex = value_noise_texture(seed=seed + 10) * 0.55
        # static clutter boxes (center, half, yaw): the synthetic analog of
        # parked cars/furniture — NEAR geometry at varied depths that keeps
        # monocular tracking well-conditioned (a bare room seen through a
        # wide-aspect camera degenerates to a frontal plane)
        self.extra_boxes = []
        for j, (c_, h_, yaw_) in enumerate(extra_boxes):
            cj, sj = np.cos(float(yaw_)), np.sin(float(yaw_))
            self.extra_boxes.append((
                np.asarray(c_, dtype=np.float64),
                np.asarray(h_, dtype=np.float64),
                np.array([[cj, -sj, 0.0], [sj, cj, 0.0], [0.0, 0.0, 1.0]]),
                value_noise_texture(seed=seed + 20 + j) * (0.5 + 0.08 * (j % 4)),
            ))

    def set_box_pose(self, center, yaw=None):
        """Move the box (dynamic-object sequences). yaw optional."""
        self.box_center = np.asarray(center, dtype=np.float64)
        if yaw is not None:
            self.box_yaw = float(yaw)
            c, s = np.cos(self.box_yaw), np.sin(self.box_yaw)
            self.box_R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    def box_pose_scale(self):
        """Ground-truth cuboid (pose 4x4 object->world, half scale 3)."""
        T = np.eye(4)
        T[:3, :3] = self.box_R
        T[:3, 3] = self.box_center
        return T, self.box_half.copy()

    def box_bbox_2d(self, Twc, K, wh=(640, 480)):
        """Ground-truth 2D bounding box [x y w h] of the box's projected
        corners (the synthetic stand-in for the YOLO detections)."""
        corners = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            dtype=np.float64,
        ) * self.box_half
        cw = corners @ self.box_R.T + self.box_center
        Tcw = np.linalg.inv(Twc)
        cc = cw @ Tcw[:3, :3].T + Tcw[:3, 3]
        if (cc[:, 2] <= 0.1).any():
            return None
        uv = cc @ np.asarray(K).T
        uv = uv[:, :2] / uv[:, 2:3]
        x1 = max(0.0, uv[:, 0].min())
        y1 = max(0.0, uv[:, 1].min())
        x2 = min(wh[0] - 1.0, uv[:, 0].max())
        y2 = min(wh[1] - 1.0, uv[:, 1].max())
        if x2 - x1 < 20 or y2 - y1 < 20:
            return None
        return np.array([x1, y1, x2 - x1, y2 - y1])

    def _box_hits(self, c, rays, center=None, Rb=None, h=None):
        """Ray-box intersection in the box frame (slab method). Returns
        (t (H, W), uv-texture (H, W, 2), hit mask). Defaults to the main
        (object-SLAM target) box; pass center/Rb/h for clutter boxes."""
        Rb = self.box_R if Rb is None else Rb
        center = self.box_center if center is None else center
        h = self.box_half if h is None else h
        oc = (c - center) @ Rb  # origin in box frame
        rd = rays @ Rb           # directions in box frame
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / rd
        t1 = (-h - oc) * inv
        t2 = (h - oc) * inv
        tmin = np.minimum(t1, t2).max(axis=-1)
        tmax = np.maximum(t1, t2).min(axis=-1)
        hit = (tmax > np.maximum(tmin, 0.05)) & np.isfinite(tmin)
        t = np.where(hit, tmin, np.inf)
        P = oc[None, None, :] + t[..., None] * rd  # box-frame hit points
        # texture coords: unwrap by dominant face axis
        u = P[..., 0] + 2.0 * P[..., 2]
        v = P[..., 1] + 2.0 * P[..., 2]
        return t, np.stack([u, v], axis=-1), hit

    def _sample(self, tex, u, v, tex_scale=None):
        size = tex.shape[0]
        ts = self.tex_scale if tex_scale is None else tex_scale
        uu = (u / ts % 1.0) * (size - 1)
        vv = (v / ts % 1.0) * (size - 1)
        u0 = np.floor(uu).astype(int)
        v0 = np.floor(vv).astype(int)
        fu = uu - u0
        fv = vv - v0
        u1 = np.minimum(u0 + 1, size - 1)
        v1 = np.minimum(v0 + 1, size - 1)
        return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
                + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)

    def render(self, Twc, K, wh=(640, 480), return_depth=False, return_mask=False):
        """Inverse ray casting: for each pixel, intersect the camera ray with
        the room planes, take the nearest hit, sample its texture. With
        return_depth, also returns the z-depth map (camera-frame depth —
        the ray parameter t, since K^-1 p has unit z); with return_mask,
        the box instance mask (the synthetic objmask_img, Frame.cc:221)."""
        W, H = wh
        Rwc = Twc[:3, :3]
        c = Twc[:3, 3]
        xs, ys = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
        Kinv = np.linalg.inv(K)
        rays_cam = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ Kinv.T
        rays = rays_cam @ Rwc.T  # world directions

        best_t = np.full((H, W), np.inf)
        img = np.full((H, W), 40.0, dtype=np.float32)

        planes = [
            # (normal, offset, texture idx, uv extractor)
            (np.array([0.0, 0.0, 1.0]), 0.0, 0, lambda P: (P[..., 0], P[..., 1])),
            (np.array([0.0, 1.0, 0.0]), self.wall_y, 1, lambda P: (P[..., 0], P[..., 2])),
            (np.array([1.0, 0.0, 0.0]), -self.half_x, 2, lambda P: (P[..., 1], P[..., 2])),
            (np.array([1.0, 0.0, 0.0]), self.half_x, 3, lambda P: (P[..., 1], P[..., 2])),
        ]
        for n, d, ti, uv_of in planes:
            denom = rays @ n
            tnum = d - c @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                t = tnum / denom
            valid = (t > 0.05) & np.isfinite(t)
            P = c[None, None, :] + t[..., None] * rays
            # clip to room extents
            if ti == 0:
                inside = (np.abs(P[..., 0]) <= self.half_x) & (P[..., 1] <= self.wall_y)
            elif ti == 1:
                inside = (np.abs(P[..., 0]) <= self.half_x) & (P[..., 2] >= 0) & (P[..., 2] <= self.height)
            else:
                inside = (P[..., 1] <= self.wall_y) & (P[..., 2] >= 0) & (P[..., 2] <= self.height)
            hit = valid & inside & (t < best_t)
            if hit.any():
                u, v = uv_of(P)
                vals = self._sample(self.tex[ti], u[hit], v[hit])
                img[hit] = vals
                best_t[hit] = t[hit]

        # clutter boxes first (the main box keeps the instance mask below)
        for bc, bh, bR, btex in self.extra_boxes:
            tb, uvb, hitb = self._box_hits(c, rays, center=bc, Rb=bR, h=bh)
            occ = hitb & (tb < best_t)
            if occ.any():
                vals = self._sample(btex, uvb[..., 0][occ], uvb[..., 1][occ],
                                    tex_scale=2.0)
                img[occ] = vals
                best_t[occ] = tb[occ]

        box_mask = np.zeros_like(img, dtype=bool)
        if self.box_center is not None:
            tb, uvb, hitb = self._box_hits(c, rays)
            occ = hitb & (tb < best_t)
            if occ.any():
                # the box samples at its own (fine) scale: the room-extent
                # tile would leave a ~1 m object nearly textureless
                vals = self._sample(self.box_tex, uvb[..., 0][occ],
                                    uvb[..., 1][occ], tex_scale=2.0)
                img[occ] = vals
                best_t[occ] = tb[occ]
            box_mask = occ
        extra = []
        if return_depth:
            extra.append(np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32))
        if return_mask:
            extra.append(box_mask)
        if extra:
            return (img, *extra)
        return img


def camera_path(n_frames, kind="arc", seed=0, target=None, s_values=None):
    """Smooth camera trajectory inside the room, looking toward the back
    wall (or at `target` when kind="orbit"). Returns (N, 4, 4) Twc
    (camera x right, y down, z forward).

    `s_values`: optional per-frame path parameters in [0, 1] replacing the
    default uniform sweep — e.g. a cosine time-warp 0.5-0.5*cos(2*pi*t)
    gives a there-and-back run whose velocity passes smoothly through zero
    at the turnaround (an instant reversal defeats any constant-velocity
    motion model, including the reference's)."""
    poses = []
    for i in range(n_frames):
        s = (float(s_values[i]) if s_values is not None
             else i / max(n_frames - 1, 1))
        if kind == "arc":
            x = -1.5 + 3.0 * s
            y = 1.0 + 0.8 * np.sin(np.pi * s)
            z = 1.4 + 0.1 * np.sin(2 * np.pi * s)
            yaw_look = 0.25 * (s - 0.5)  # slight look rotation
        elif kind == "orbit":
            x = -1.2 + 2.4 * s
            y = 0.4 + 0.5 * np.sin(np.pi * s)
            z = 1.2
        else:  # forward
            x, y, z = 0.0, 0.5 + 3.0 * s, 1.4
            yaw_look = 0.0
        eye = np.array([x, y, z])
        if kind == "orbit" and target is not None:
            f = np.asarray(target, dtype=np.float64) - eye
        else:
            f = np.array([np.sin(yaw_look), np.cos(yaw_look), -0.05])
        f = f / np.linalg.norm(f)
        xr = np.cross(f, np.array([0.0, 0.0, 1.0]))
        xr /= np.linalg.norm(xr)
        yd = np.cross(f, xr)
        Twc = np.eye(4)
        Twc[:3, :3] = np.stack([xr, yd, f], axis=1)
        Twc[:3, 3] = eye
        poses.append(Twc)
    return np.stack(poses)


class SynthSequence:
    """A rendered orbit around the RoomScene box, shaped like
    io.CabinetSequence for ObjectSlamDemo.run_online: `K`, `num_frames`,
    `gray(f)`, `yolo_boxes(f)` and `truth_Twc(f)`. Frames are rounded to
    integer grey levels, as io.load_image gives real frames, and the 2D
    boxes are the projected ground-truth box (the stand-in for YOLO).
    Frames render lazily and are cached."""

    def __init__(self, n_frames, K, wh=(640, 480), scene=None,
                 target=(0.0, 3.2, 0.6)):
        self.K = np.asarray(K, dtype=np.float64)
        self.wh = tuple(wh)
        self.num_frames = int(n_frames)
        self.scene = scene if scene is not None else RoomScene(
            seed=3, box_center=[0.0, 3.2, 0.45], box_half=[0.6, 0.4, 0.45])
        self.poses = camera_path(self.num_frames, kind="orbit", target=list(target))
        self._gray = {}

    def truth_Twc(self, idx):
        return self.poses[idx].copy()

    def gray(self, idx):
        if idx not in self._gray:
            img = self.scene.render(self.poses[idx], self.K, wh=self.wh)
            self._gray[idx] = np.round(img).astype(np.float32)
        return self._gray[idx]

    def yolo_boxes(self, idx):
        """[x, y, w, h, prob] rows; empty when the box is out of view."""
        bb = self.scene.box_bbox_2d(self.poses[idx], self.K, wh=self.wh)
        if bb is None:
            return np.zeros((0, 5))
        return np.concatenate([bb, [1.0]])[None, :]
