"""KITTI-mode helpers.

Counterpart of cube_slam_tpu/slam/kitti.py. For now it holds only the
ray-cuboid depth that the object tracker's metric scale initialization
needs (`ObjectSlamTracker._object_depth_ratios`); the KITTI trackers of that
module come with the slice of the port that ports the other inputs.
Host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..utils import np_geometry as np_geo


def _ray_cuboid_depth(K, xy, local_pose, scale):
    """Camera-frame z of the first hit of each pixel ray with the cuboid
    (slab test in the object frame). xy: (N, 2). Returns (N,) z (0 = miss)."""
    if len(xy) == 0:
        return np.zeros(0, dtype=np.float32)
    Kinv = np.linalg.inv(np.asarray(K, dtype=np.float64))
    rays = np.concatenate([xy, np.ones((len(xy), 1))], axis=1) @ Kinv.T
    inv_P = np_geo.inv_T(np.asarray(local_pose, dtype=np.float64))
    o = np.broadcast_to(inv_P[:3, 3], rays.shape)
    dvec = rays @ inv_P[:3, :3].T
    s = np.asarray(scale, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-s - o) / dvec
        t2 = (s - o) / dvec
    t_near = np.nanmax(np.minimum(t1, t2), axis=1)
    t_far = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (t_near <= t_far) & (t_near > 0.1)
    # camera-frame z of the hit: ray has unit z, so z = t (ray param)
    return np.where(hit, t_near, 0.0).astype(np.float32)
