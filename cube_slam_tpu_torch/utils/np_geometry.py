"""Numpy geometry helpers for HOST-side code paths.

The per-frame host loop and the detector's input preparation do their
pose bookkeeping in float64 numpy, exactly as the JAX package does, so the
two packages feed identical inputs to their device code. Conventions are
identical to utils/geometry.py (zyx Euler, [w,x,y,z] quaternions).
"""

from __future__ import annotations

import numpy as np


def quat_to_rot(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rot_to_quat(R):
    """Rotation matrix -> [w, x, y, z] (Shepperd)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def quat_to_euler_zyx(q):
    """[w,x,y,z] -> (roll, pitch, yaw) (matrix_utils.cpp:35-46)."""
    qw, qx, qy, qz = q
    roll = np.arctan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
    pitch = np.arcsin(np.clip(2 * (qw * qy - qz * qx), -1.0, 1.0))
    yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    return roll, pitch, yaw


def rot_to_euler_zyx(R):
    """Matches the reference's quat-based extraction (set_cam_pose,
    box_proposal_detail.cpp:42-54 goes rot -> quat -> euler)."""
    return quat_to_euler_zyx(rot_to_quat(R))


def euler_zyx_to_rot(roll, pitch, yaw):
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array(
        [
            [cp * cy, sr * sp * cy - cr * sy, cr * sp * cy + sr * sy],
            [cp * sy, sr * sp * sy + cr * cy, cr * sp * sy - sr * cy],
            [-sp, sr * cp, cr * cp],
        ]
    )


def make_T(R, t):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def inv_T(T):
    R = T[:3, :3]
    t = T[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def minimal9_to_pose_scale(v9):
    """[x y z roll pitch yaw l w h] -> (pose 4x4, scale 3) (numpy twin of
    models/cuboid.from_minimal_vector)."""
    v9 = np.asarray(v9, dtype=np.float64)
    R = euler_zyx_to_rot(v9[3], v9[4], v9[5])
    return make_T(R, v9[:3]), v9[6:9].copy()


def se3_exp(xi):
    """se3 tangent [omega, upsilon] -> (4, 4) float64 transform (the
    Rodrigues form of utils/geometry.se3_exp, in numpy)."""
    w, v = np.asarray(xi[:3], dtype=np.float64), np.asarray(xi[3:], dtype=np.float64)
    th = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-9:
        a, b, c = 1.0, 0.5, 1.0 / 6.0
    else:
        a, b, c = np.sin(th) / th, (1.0 - np.cos(th)) / th**2, (1.0 - np.sin(th) / th) / th**2
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + a * W + b * W @ W
    T[:3, 3] = (np.eye(3) + b * W + c * W @ W) @ v
    return T
