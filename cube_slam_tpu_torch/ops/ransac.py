"""Batched RANSAC primitives.

PyTorch counterpart of cube_slam_tpu/ops/ransac.py: the plane fit that
replaces the reference's PCL SACSegmentation for monocular ground-scale
recovery (Tracking.cc:2537-2550), every hypothesis scored at once.

The refine step takes the plane normal from `torch.linalg.eigh` of the
inliers' symmetric covariance (the smallest eigenvalue's vector) where the
JAX package takes `vt[-1]` of an SVD: the same line, and no SVD on the card.
Either sign of that vector is a valid answer; LAPACK builds differ in which
they return, so the port fixes its own: the normal's component of largest
magnitude is positive.
"""

from __future__ import annotations

import numpy as np
import torch


def fit_plane_ransac(points, valid, sample_idx, inlier_thresh,
                     expected_normal=None, min_normal_cos=0.0,
                     prefer_farthest=False):
    """Plane RANSAC: points (N, 3), valid (N,), sample_idx (S, 3) int.

    Returns (plane (4,) [n, d] with |n|=1 and n·p + d = 0, inlier_mask (N,),
    n_inliers). Hypotheses from 3-point samples, scored by point-plane
    distance, best refined by least squares on its inliers (PCA plane).

    expected_normal/min_normal_cos: candidate planes whose normal deviates
    from the expectation are rejected before scoring (the ground-plane fit
    must not lock onto walls; PCL's setAxis/setEpsAngle).

    prefer_farthest: among hypotheses within 50% of the best inlier count
    (after the normal gate), pick the plane farthest from the origin (|d|
    max): the floor is the farthest normal-aligned plane below the camera,
    object top faces share its normal and sit nearer. Ties in either
    selection go to the first hypothesis, as with jnp.argmax."""
    idx = sample_idx.to(torch.int64)
    p0 = points[idx[:, 0]]  # (S, 3)
    p1 = points[idx[:, 1]]
    p2 = points[idx[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = torch.linalg.vector_norm(n, dim=1, keepdim=True)
    n = n / torch.where(norm > 1e-12, norm, 1.0)
    d = -torch.sum(n * p0, dim=1)  # (S,)

    dist = torch.abs(points @ n.T + d[None, :])  # (N, S)
    inl = (dist < inlier_thresh) & valid[:, None]
    counts = torch.sum(inl, dim=0)
    if expected_normal is not None:
        exp_n = torch.as_tensor(expected_normal, dtype=n.dtype, device=n.device)
        exp_n = exp_n / torch.clamp(torch.linalg.vector_norm(exp_n), min=1e-12)
        gate = torch.abs(n @ exp_n) >= min_normal_cos
        counts = torch.where(gate, counts, -1)
    if prefer_farthest:
        ok = counts >= torch.clamp(counts.max(), min=1) // 2
        best = torch.argmax(torch.where(ok & (counts > 0), torch.abs(d), -1.0))
    else:
        best = torch.argmax(counts)
    inlier = inl[:, best]

    # refine: PCA plane over inliers
    w = inlier.to(torch.float32)[:, None]
    nw = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(points * w, dim=0) / nw
    cen = (points - mean) * w
    cov = cen.T @ cen / nw
    _, evecs = torch.linalg.eigh(cov)
    n_ref = evecs[:, 0]
    n_ref = n_ref * torch.where(n_ref[torch.argmax(torch.abs(n_ref))] < 0, -1.0, 1.0)
    n_norm = torch.linalg.vector_norm(n_ref)
    n_ref = n_ref / torch.where(n_norm > 1e-12, n_norm, 1.0)
    d_ref = -torch.dot(n_ref, mean)
    dist_ref = torch.abs(points @ n_ref + d_ref)
    inlier_ref = (dist_ref < inlier_thresh) & valid
    plane = torch.cat([n_ref, d_ref[None]])
    return plane, inlier_ref, torch.sum(inlier_ref)


def make_triplet_indices(valid_mask, n_hyp=256, seed=0):
    """Host-side 3-point sample indices over valid rows (numpy, the JAX
    package's generator and draws, so the tables are identical)."""
    rng = np.random.default_rng(seed)
    idx = np.where(np.asarray(valid_mask))[0]
    if len(idx) < 3:
        return np.zeros((n_hyp, 3), dtype=np.int32)
    return np.stack(
        [rng.choice(idx, size=3, replace=False) for _ in range(n_hyp)]
    ).astype(np.int32)
