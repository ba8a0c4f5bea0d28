"""The scene's truth and the plain arithmetic that holds the tracker's
answers to it: a similarity alignment of camera centres (Umeyama) and the
errors of poses, landmarks and detections in the true world. NumPy only;
nothing here comes from the port."""

from __future__ import annotations

import numpy as np


def umeyama(src, dst):
    """The similarity (s, R, t) minimizing |s R src + t - dst|^2 over rows
    (Umeyama 1991)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    ms, md = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - ms, dst - md
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var = (xs * xs).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var) if var > 0 else 1.0
    return s, R, md - s * R @ ms


def rigid_inverse(T):
    """The inverse of a rigid 4x4 transform, (R^T, -R^T t); never singular,
    and non-finite where T is."""
    T = np.asarray(T, dtype=np.float64)
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def aligned_ate(est_Twc, truth_Twc):
    """RMS distance (m) between the estimated camera centres, similarity
    aligned onto the true ones, and the true centres; with the alignment."""
    x = np.stack([T[:3, 3] for T in est_Twc])
    y = np.stack([T[:3, 3] for T in truth_Twc])
    s, R, t = umeyama(x, y)
    d = (s * x @ R.T + t) - y
    return float(np.sqrt((d * d).sum(axis=1).mean())), (s, R, t)


def episode_alignment(final_Twc, truth_Twc, min_share=0.5):
    """(ATE, alignment) of one episode's final trajectory, or (inf, None)
    where it holds fewer than 3 poses or poses for fewer than `min_share` of
    the frames after its first pose."""
    posed = [(f, T) for f, T in final_Twc if T is not None]
    if len(posed) < 3 or not all(np.isfinite(T).all() for _, T in posed):
        return float("inf"), None
    first = posed[0][0]
    if len(posed) < min_share * (len(truth_Twc) - first):
        return float("inf"), None
    return aligned_ate([T for _, T in posed], [truth_Twc[f] for f, _ in posed])


def motion_errors(final_Twc, truth_Twc, min_share=0.5, n_frames=None):
    """Per pair of consecutive posed frames, the angle (degrees) between the
    estimated displacement of the camera and the true one, each in the
    pair's first camera frame (a displacement of zero reads 180); None where
    the pairs cover fewer than `min_share` of the frames after the first
    pose, of the `n_frames` run (all of the orbit's by default)."""
    posed = [(f, T) for f, T in final_Twc if T is not None]
    if not posed:
        return None
    errs = []
    for (f0, A), (f1, B) in zip(posed[:-1], posed[1:]):
        if f1 != f0 + 1:
            continue
        est = (rigid_inverse(A) @ B)[:3, 3]
        true = (rigid_inverse(truth_Twc[f0]) @ truth_Twc[f1])[:3, 3]
        n = np.linalg.norm(est) * np.linalg.norm(true)
        if not np.isfinite(n):
            errs.append(180.0)
            continue
        errs.append(float(np.degrees(np.arccos(np.clip(est @ true / n, -1.0, 1.0)))) if n > 0 else 180.0)
    if len(errs) < min_share * ((n_frames or len(truth_Twc)) - posed[0][0]):
        return None
    return errs


def camera_error(centres_cam, truth_Twc, box_centre):
    """The distance from the true box centre, seen from the true camera, to
    the nearest of the estimated centres in that camera's frame, as a share
    of the box's distance (a monocular map's metric scale comes from the
    ground and the objects, so the error is a share of the range); inf
    without an estimate."""
    c_true = (rigid_inverse(truth_Twc) @ np.append(np.asarray(box_centre, dtype=np.float64), 1.0))[:3]
    c = np.asarray(centres_cam, dtype=np.float64).reshape(-1, 3)
    if not len(c):
        return float("inf")
    return float(np.min(np.linalg.norm(c - c_true, axis=1)) / np.linalg.norm(c_true))
