"""One episode of a cell's traffic, made from the seed by the frozen generator.

An episode is the configuration's camera orbit through the synthetic room:
`frames` grey images (uint8, as a camera gives them), the projected true box
as the 2D detection of each frame, the box's offline cuboid rows (KITTI
mode) and the true camera poses. The room, its textures, the camera path and
the box are the configuration's; `--seed` draws the camera's sensor noise
(`camera.noise_sigma` grey levels, Gaussian, per pixel and frame). A texture
drawn from the seed changed the tracker's work by half from seed to seed
(6 to 9 keyframes, 40-60 s per episode), where noise leaves it the same.

Rendering is numpy on the host (~0.2 s per 640x480 frame on one core): the
noiseless frames are rendered once per checkout by worker processes that
exit before the window opens, and kept in portbench/_frames/.
"""

from __future__ import annotations

import functools
import hashlib
import json
import multiprocessing
import os
from dataclasses import dataclass

import numpy as np

from . import synth

# worker processes for rendering; fixed so that set-up does the same work on
# every run
RENDER_WORKERS = 6
FRAME_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_frames")


def noise_seed(seed: int) -> int:
    """The noise generator's seed for a run's --seed (numpy takes
    non-negative seeds; a run's may pass 32 bits)."""
    return int(seed) % (2**62)


def camera_K(cfg) -> np.ndarray:
    c = cfg["camera"]
    return np.array([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]])


def truth_poses(cfg) -> np.ndarray:
    """(frames, 4, 4) true camera-to-world poses: the first `frames` of an
    orbit of `path_frames` (default: `frames`) poses."""
    s = cfg["scene"]
    return synth.camera_path(s.get("path_frames", s["frames"]), kind="orbit", target=list(s["target"]))[:s["frames"]]


def box_pose(cfg) -> tuple[np.ndarray, np.ndarray]:
    """The true box: (4x4 object-to-world pose, half extents)."""
    s = cfg["scene"]
    yaw = float(s.get("box_yaw", 0.0))
    T = np.eye(4)
    T[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = s["box_center"]
    return T, np.asarray(s["box_half"], dtype=np.float64)


@functools.lru_cache(maxsize=1)
def _scene(tex_seed: int, center: tuple, half: tuple, yaw: float) -> synth.RoomScene:
    return synth.RoomScene(seed=tex_seed, box_center=list(center), box_half=list(half), box_yaw=yaw)


def _render(job):
    """Worker: (texture seed, box, Twc, K, wh) -> (uint8 frame, [x y w h] or None)."""
    tex_seed, center, half, yaw, Twc, K, wh = job
    scene = _scene(tex_seed, center, half, yaw)
    with np.errstate(invalid="ignore"):  # rays parallel to a box face
        img = np.round(scene.render(Twc, K, wh=wh)).astype(np.uint8)
    return img, scene.box_bbox_2d(Twc, K, wh=wh)


@dataclass
class Episode:
    frames: list          # (H, W) uint8 per frame
    boxes: list           # (1, 4) float [x y w h] per frame, or None out of view
    truth_Twc: np.ndarray  # (N, 4, 4)
    K: np.ndarray
    wh: tuple
    box_T: np.ndarray
    box_half: np.ndarray

    def offline_rows(self, tid: int = 1) -> list:
        """Per frame the 13-column offline cuboid row [centre(3) yaw
        half-scale(3) x y w h prob tid] of the box in the local ground frame
        of the first pose, or a (0, 13) array where the box is out of view
        (the KITTI mode's offline detections)."""
        rows = []
        for P, bb in zip(self.truth_Twc, self.boxes):
            if bb is None:
                rows.append(np.zeros((0, 13)))
                continue
            pose_lg = self.truth_Twc[0] @ (np.linalg.inv(P) @ self.box_T)
            yaw = float(np.arctan2(pose_lg[1, 0], pose_lg[0, 0]))
            rows.append(np.array([[*pose_lg[:3, 3], yaw, *self.box_half, *bb[0], 0.9, float(tid)]]))
        return rows


def _render_all(cfg, workers):
    """The noiseless frames and 2D boxes of the configuration's orbit, from
    the checkout's cache or rendered in `workers` spawned processes (0: in
    this process) and cached."""
    K = camera_K(cfg)
    wh = tuple(cfg["camera"]["wh"])
    s = cfg["scene"]
    key = (int(s["texture_seed"]), tuple(s["box_center"]), tuple(s["box_half"]), float(s.get("box_yaw", 0.0)))
    jobs = [(*key, P, K, wh) for P in truth_poses(cfg)]
    tag = hashlib.sha256(json.dumps([cfg["camera"], s], sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(FRAME_CACHE, f"{cfg['name']}-{tag}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            frames, boxes = list(z["frames"]), list(z["boxes"])
        return frames, [None if np.isnan(b).any() else b[None, :] for b in boxes]
    if workers:
        pool = multiprocessing.get_context("spawn").Pool(workers)
        try:
            out = pool.map(_render, jobs, chunksize=1)
            pool.close()
        finally:
            pool.terminate()
            pool.join()
    else:
        out = [_render(j) for j in jobs]
    frames = [img for img, _ in out]
    boxes = [np.full(4, np.nan) if bb is None else np.asarray(bb, dtype=np.float64) for _, bb in out]
    os.makedirs(FRAME_CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, frames=np.stack(frames), boxes=np.stack(boxes))
    os.replace(tmp, path)
    return frames, [None if np.isnan(b).any() else b[None, :] for b in boxes]


def make_episode(cfg, seed: int, workers: int = RENDER_WORKERS) -> Episode:
    """The episode of `seed`: the configuration's frames with the camera's
    noise drawn from the seed."""
    frames, boxes = _render_all(cfg, workers)
    sigma = float(cfg["camera"]["noise_sigma"])
    rng = np.random.default_rng(noise_seed(seed))
    noisy = [np.clip(np.round(f + rng.normal(0.0, sigma, f.shape)), 0, 255).astype(np.uint8) for f in frames]
    box_T, half = box_pose(cfg)
    return Episode(noisy, boxes, truth_poses(cfg), camera_K(cfg), tuple(cfg["camera"]["wh"]), box_T, half)
